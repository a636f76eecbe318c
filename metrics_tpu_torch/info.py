"""Package metadata for metrics_tpu_torch.

The PyTorch/CUDA port of ``metrics_tpu``: the same metrics, run eagerly on
an NVIDIA GPU, with the JAX package's one Pallas kernel rewritten as a
CUDA kernel for Hopper (``csrc/tie_scan.cu``).
"""

__version__ = "0.5.0"
__author__ = "metrics_tpu contributors"
__license__ = "Apache-2.0"
__docs__ = (
    "GPU-native machine-learning metrics on PyTorch: tensor metric state on an"
    " explicit device, torch.distributed synchronization, hand-written CUDA kernels."
)
