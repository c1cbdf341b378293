"""speedy_tpu_torch: the PyTorch/CUDA port of speedy_tpu's batched
nonlinear-speedup path, for one NVIDIA H100.

The package imports torch and numpy only, never JAX or speedy_tpu. Its
three kernels (speedy_tpu_torch/csrc/*.cu) are built with nvcc at first
use on the card; CPU tensors take each kernel's plain PyTorch version.
"""

from .config import SpeedyConfig
from .parallel.batch import (
    BatchResult,
    SpeedupEngine,
    batched_nonlinear_speedup,
    grid_output_capacity,
)

__all__ = [
    "BatchResult",
    "SpeedupEngine",
    "SpeedyConfig",
    "batched_nonlinear_speedup",
    "grid_output_capacity",
]
