"""The benchmark of speedy_tpu_torch, the PyTorch and CUDA port, on NVIDIA
GPUs. From the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything about a cell is data, found by name from BENCHMARK.json:
  portbench/configs/<config>.json    the configuration; its "entry" names
  portbench/entries/<entry>.py       the driver of that entry into the program
  portbench/traffic/<cell>.json      the cell's traffic, read by traffic_gen.py
  portbench/limits/<cell>.json       the limit of each number compared
  portbench/metrics/<metric>.py      one reader a metric: read(record) -> value

A run makes its inputs from --seed, warms up every shape the cell uses,
measures --seconds of calls (with --trace 1, then profiles a few more calls
for the per-layer metrics), compares the answers with the plain reference
(portbench/reference/plain.py) and prints one JSON line last on standard
output. It exits nonzero, and prints no result, without a CUDA device,
when a file it needs is missing, or if JAX or the JAX package got loaded.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "speedy_tpu")


class MissingFile(FileNotFoundError):
    pass


def process_seconds() -> float:
    """Seconds since this process started, by the kernel's record of its
    start; from this module's import where /proc is not there."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        boot = time.clock_gettime(time.CLOCK_BOOTTIME)
        return boot - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules() -> list:
    """Top-level names in sys.modules that are JAX or the JAX package,
    compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _read_json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise MissingFile(f"missing {path}")
    with open(path) as f:
        return json.load(f)


def load_reader(path: pathlib.Path):
    """The read(record) function of a metric's file."""
    if not path.is_file():
        raise MissingFile(f"missing {path}")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_files(root: pathlib.Path, bench: dict, workload: str) -> dict:
    """Every file the cell needs, by the names in BENCHMARK.json; raises
    MissingFile for one that is not there."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise MissingFile(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[cell["config"]]["file"])
    entry = HERE / "entries" / f"{config['entry']}.py"
    if not entry.is_file():
        raise MissingFile(f"missing {entry}")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return {
        "cell": cell, "config": config, "entry": config["entry"],
        "traffic": _read_json(HERE / "traffic" / f"{workload}.json"),
        "limits": _read_json(HERE / "limits" / f"{workload}.json"),
        "end_to_end": [(m, load_reader(HERE / "metrics" / f"{m['name']}.py")) for m in e2e],
        "per_layer": [(m, load_reader(HERE / "metrics" / f"{m['name']}.py")) for m in layer],
    }


def power_limit():
    """The card's name and power limit by nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(root: pathlib.Path, workload: str, seed: int, seconds: float, trace: bool,
             device, overrides: dict = None, log=None) -> dict:
    """One run of one cell on `device`; returns the result line's object.
    overrides replaces keys of the cell's traffic (the tests' small sizes)."""
    import torch

    from portbench import judge, profiling

    log = log or (lambda *a: print(*a, file=sys.stderr))
    bench = _read_json(root / "BENCHMARK.json")
    files = cell_files(root, bench, workload)
    traffic = dict(files["traffic"], **(overrides or {}))
    device = torch.device(device)
    module = importlib.import_module(f"portbench.entries.{files['entry']}")
    entry = module.Entry(files["config"], traffic, seed, device)
    entry.warm_up(seconds)
    gc.collect()
    gc.freeze()

    # ---- the measured window: the calls, their synchronize, the clock ----
    setup_s = process_seconds()
    times, dispatch = [], []
    i = 0
    start = time.perf_counter()
    end_at = start + seconds
    while True:
        t0 = time.perf_counter()
        d = entry.call(i)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        dispatch.append(d)
        i += 1
        if t1 >= end_at:
            break
    window_s = t1 - start
    window_calls = i
    gc.unfreeze()

    i = entry.finish(i)
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    attempted, failed = entry.outcome(window_calls)
    record = {
        "unit": entry.unit, "setup_s": setup_s, "window_s": window_s,
        "calls": window_calls, "times": times, "work_per_call": entry.work_per_call,
        "dispatch": None if dispatch[0] is None else dispatch, "shapes": entry.shapes,
    }
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                "count": files["cell"]["chips"], "memory_peak_bytes": int(peak)}
    out = {}
    if trace:
        prof = profiling.profile_calls(entry.call, i, traffic["trace_calls"], entry.span_targets)
        record["profile"] = prof
        dev_info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        log(f"trace: {prof['calls']} calls, {prof['kernel_count']} kernels, "
            f"{prof['unattributed_events']} device events without a launch record")
        out["breakdown"] = profiling.breakdown(prof)
    if on_card:
        dev_info["power_limit"] = power_limit()
    metrics = {}
    for m, read in files["per_layer" if trace else "end_to_end"]:
        value = read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # ---- the comparison, once the program's state is freed ----
    entry.release()
    if on_card:
        torch.cuda.empty_cache()
    tally = judge.Tally()
    compared = entry.compare(tally)
    numbers = tally.numbers()
    correct, checks = judge.verdict(numbers, files["limits"])
    log(f"compared {compared} answers of {attempted} attempted, {failed} failed")
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev_info, **out, "checks": checks}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    if str(HERE) in sys.path:
        sys.path.remove(str(HERE))
    sys.path.insert(0, str(ROOT))
    import torch

    bench = _read_json(ROOT / "BENCHMARK.json")
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    return 0


def _finite(x):
    """x with every float that is not finite made None (JSON has no NaN)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return None if isinstance(x, float) and not math.isfinite(x) else x


if __name__ == "__main__":
    sys.exit(main())
