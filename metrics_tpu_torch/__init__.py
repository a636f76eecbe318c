"""metrics_tpu_torch — the PyTorch/CUDA port of ``metrics_tpu``.

Metrics run eagerly on an NVIDIA GPU (Hopper, ``sm_90a``) by default, with
tensor state on an explicit ``torch.device``; ``device="cpu"`` runs them on
the CPU. The JAX package's Pallas tie-group scan is a hand-written CUDA
kernel here (``csrc/tie_scan.cu``), built with ``nvcc`` at first use.

Ported so far: Accuracy; exact AUROC and AveragePrecision of binary inputs
and, with every class in one batched kernel launch, of one-vs-rest
multi-class and multi-label inputs, weighted or not; the curves (ROC,
PrecisionRecallCurve, AUC), every class's curve built in one pass; their
sharded forms with bounded per-rank state (``ShardedAUROC``,
``ShardedAveragePrecision`` with optional sample weights: the weighted scan
on one card, the splitter sample sort over ``torch.distributed`` across
cards; ``ShardedROC``, ``ShardedPrecisionRecallCurve``); the streaming
binned curves over score histograms (``BinnedAUROC``,
``BinnedAveragePrecision``, ``BinnedPrecisionRecallCurve``); the ``Metric``
core and ``MetricCollection``.
"""
from metrics_tpu_torch.info import __version__  # noqa: F401
from metrics_tpu_torch.metric import Metric  # noqa: F401
from metrics_tpu_torch.classification import (  # noqa: F401
    AUC,
    AUROC,
    ROC,
    Accuracy,
    AveragePrecision,
    BinnedAUROC,
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    PrecisionRecallCurve,
    ShardedAUROC,
    ShardedAveragePrecision,
    ShardedCurveMetric,
    ShardedPrecisionRecallCurve,
    ShardedROC,
)
from metrics_tpu_torch.collections import MetricCollection  # noqa: F401
