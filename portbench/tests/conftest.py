"""CPU tests of the benchmark: python -m pytest portbench/tests. None needs a
CUDA device; the checks that do are the benchmark's own runs."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
