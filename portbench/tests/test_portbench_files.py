"""The harness finds every file BENCHMARK.json names, by name, and refuses
a cell whose file is missing; run.py refuses to run without a card."""

import copy
import json
import subprocess
import sys

import pytest

from portbench import run
from portbench.tests.small import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_every_named_file_is_found(workload):
    files = run.cell_files(ROOT, BENCH, workload)
    assert files["entry"] in ("batch", "file")
    assert files["limits"] and files["traffic"]
    names = {m["name"] for m, _ in files["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert files["per_layer"], "every cell reports a per-layer metric"
    for m, read in files["per_layer"]:
        assert m["moves"] in names and callable(read)


def test_per_layer_workloads_name_cells_that_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            assert w in CELLS
            assert w in e2e[m["moves"]].get("workloads", CELLS)


@pytest.mark.parametrize("what", ["workload", "traffic", "metric", "config", "limits"])
def test_a_missing_file_is_refused(what, tmp_path):
    bench = copy.deepcopy(BENCH)
    cell = bench["workloads"][0]["name"]
    if what == "workload":
        cell = "corpus16k.nowhere"
    elif what == "traffic":
        bench["workloads"].append(dict(bench["workloads"][0], name="corpus16k.nowhere"))
        cell = "corpus16k.nowhere"
    elif what == "metric":
        bench["end_to_end"].append(dict(bench["end_to_end"][-1], name="nowhere_s"))
    elif what == "config":
        bench["configs"][0]["file"] = "portbench/configs/nowhere.json"
    elif what == "limits":
        # The traffic file is there, the limits file is not.
        (tmp_path / "portbench" / "configs").mkdir(parents=True)
        bench["configs"][0]["file"] = "portbench/configs/c.json"
        (tmp_path / "portbench" / "configs" / "c.json").write_text(
            json.dumps({"entry": "batch"}))
        orig = run.HERE
        run.HERE = tmp_path / "portbench"
        (run.HERE / "entries").mkdir()
        (run.HERE / "entries" / "batch.py").write_text("")
        (run.HERE / "traffic").mkdir()
        (run.HERE / "traffic" / f"{cell}.json").write_text("{}")
        try:
            with pytest.raises(run.MissingFile):
                run.cell_files(tmp_path, bench, cell)
        finally:
            run.HERE = orig
        return
    with pytest.raises(run.MissingFile):
        run.cell_files(ROOT, bench, cell)


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_run_outside_a_checkout_of_the_program_exits_nonzero(tmp_path):
    """Only BENCHMARK.json and portbench/ there: the program is missing."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.argv[1:] = ['--workload', %r, '--seed', '1', '--seconds', '1'];"
            "sys.path.insert(0, 'portbench'); import run;"
            "import torch; torch.cuda.is_available = lambda: True;"
            "torch.cuda.device_count = lambda: 1; sys.exit(run.main())" % CELLS[0])
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
