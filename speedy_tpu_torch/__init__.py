"""speedy_tpu_torch: the PyTorch/CUDA port of speedy_tpu, for one NVIDIA
H100: the batched nonlinear-speedup path (SpeedupEngine) and the
single-utterance grid pipeline (nonlinear_speedup, linear_time_scale and
the CLI, python -m speedy_tpu_torch.cli --engine grid).

The package imports torch and numpy only, never JAX or speedy_tpu. Its
kernels (speedy_tpu_torch/csrc/*.cu) are built with nvcc at first use on
the card; CPU tensors take each kernel's plain PyTorch version.
"""

from .config import SpeedyConfig
from .ops.analysis import AnalysisResult, analyze
from .ops.wsola_fast import time_scale_grid
from .parallel.batch import (
    BatchResult,
    SpeedupEngine,
    batched_nonlinear_speedup,
    grid_output_capacity,
)
from .pipeline import SpeedupResult, linear_time_scale, nonlinear_speedup

__all__ = [
    "AnalysisResult",
    "BatchResult",
    "SpeedupEngine",
    "SpeedupResult",
    "SpeedyConfig",
    "analyze",
    "batched_nonlinear_speedup",
    "grid_output_capacity",
    "linear_time_scale",
    "nonlinear_speedup",
    "time_scale_grid",
]
