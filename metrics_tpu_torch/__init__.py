"""metrics_tpu_torch — the PyTorch/CUDA port of ``metrics_tpu``.

Metrics run eagerly on an NVIDIA GPU (Hopper, ``sm_90a``) by default, with
tensor state on an explicit ``torch.device``; ``device="cpu"`` runs them on
the CPU. The JAX package's Pallas tie-group scan is a hand-written CUDA
kernel here (``csrc/tie_scan.cu``), built with ``nvcc`` at first use.

Ported so far: Accuracy; exact AUROC and AveragePrecision of binary inputs
and, with every class in one batched kernel launch, of one-vs-rest
multi-class (AUROC, AP) and multi-label (AUROC) inputs; their sharded forms
with bounded per-rank state and optional sample weights (``ShardedAUROC``,
``ShardedAveragePrecision``: the weighted scan on one card, the splitter
sample sort over ``torch.distributed`` across cards); the ``Metric`` core
and ``MetricCollection``.
"""
from metrics_tpu_torch.info import __version__  # noqa: F401
from metrics_tpu_torch.metric import Metric  # noqa: F401
from metrics_tpu_torch.classification import (  # noqa: F401
    AUROC,
    Accuracy,
    AveragePrecision,
    ShardedAUROC,
    ShardedAveragePrecision,
    ShardedCurveMetric,
)
from metrics_tpu_torch.collections import MetricCollection  # noqa: F401
