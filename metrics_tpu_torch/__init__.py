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
``BinnedAveragePrecision``, ``BinnedPrecisionRecallCurve``); the stat-score
family, counted in label space without a one-hot (``StatScores``,
``Precision``, ``Recall``, ``FBeta``, ``F1``, ``HammingDistance``) and the
confusion-matrix family (``ConfusionMatrix``, ``CohenKappa``,
``MatthewsCorrcoef``, ``IoU``), with ``Hinge`` and functional
``dice_score``; the regression pack (``MeanSquaredError``,
``MeanAbsoluteError``, ``MeanSquaredLogError``, ``R2Score``,
``ExplainedVariance``, ``PSNR``, ``SSIM``), whose members share one pass
over each batch inside a ``MetricCollection``; metric arithmetic
(``CompositionalMetric``: ``(Precision() + Recall()) / 2``,
``MeanSquaredError() ** 0.5``); the retrieval family (``RetrievalMAP``,
``RetrievalMRR``, ``RetrievalPrecision``, ``RetrievalRecall``), every query
of an epoch ranked by one sort, and its bounded per-rank forms
(``ShardedRetrievalMAP``, ...; the retrieval sample sort across ranks);
the ``Metric`` core and ``MetricCollection``, whose ``compiled=True``
forward runs through the step engine (``CompiledStepEngine``: one CUDA
graph replay per step); the multi-tenant ``MetricCohort`` (N
structurally identical collections stacked along a tenant axis, every
tenant's step one CUDA graph replay); the ``BootStrapper`` wrapper; the
functional ``bleu_score``, ``image_gradients`` and ``embedding_similarity``;
the observability core (``observability``: the telemetry registry, span
tracing, the recompilation watchdog and the failure flight recorder, off by
default, under the JAX package's ``METRICS_TPU_*`` flags); and the sync
tiers: ``add_state(sync_precision="int8"|"bf16")`` with error-feedback
residuals (``parallel.quantize``), the two-level ``HierarchicalSyncBackend``
(``parallel.hierarchy``) and the ``SyncPolicy`` retry / timeout /
degradation with its fault injectors (``reliability``); and the elastic
fleet (``fleet``: placement, leases, tenant migration, replication and
failover over cohorts).
"""
from metrics_tpu_torch.info import __version__  # noqa: F401
from metrics_tpu_torch.metric import CompositionalMetric, Metric  # noqa: F401
from metrics_tpu_torch.classification import (  # noqa: F401
    AUC,
    AUROC,
    ROC,
    Accuracy,
    AveragePrecision,
    BinnedAUROC,
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    CohenKappa,
    ConfusionMatrix,
    F1,
    FBeta,
    HammingDistance,
    Hinge,
    IoU,
    MatthewsCorrcoef,
    Precision,
    PrecisionRecallCurve,
    Recall,
    ShardedAUROC,
    ShardedAveragePrecision,
    ShardedCurveMetric,
    ShardedPrecisionRecallCurve,
    ShardedROC,
    StatScores,
)
from metrics_tpu_torch.regression import (  # noqa: F401
    PSNR,
    SSIM,
    ExplainedVariance,
    MeanAbsoluteError,
    MeanSquaredError,
    MeanSquaredLogError,
    R2Score,
)
from metrics_tpu_torch.retrieval import (  # noqa: F401
    RetrievalMAP,
    RetrievalMetric,
    RetrievalMRR,
    RetrievalPrecision,
    RetrievalRecall,
    ShardedRetrievalMAP,
    ShardedRetrievalMetric,
    ShardedRetrievalMRR,
    ShardedRetrievalPrecision,
    ShardedRetrievalRecall,
)
from metrics_tpu_torch.collections import MetricCollection  # noqa: F401
from metrics_tpu_torch.engine import CompiledStepEngine  # noqa: F401
from metrics_tpu_torch.cohort import MetricCohort  # noqa: F401
from metrics_tpu_torch import observability  # noqa: F401
from metrics_tpu_torch import reliability  # noqa: F401
from metrics_tpu_torch import serving  # noqa: F401
from metrics_tpu_torch import fleet  # noqa: F401
from metrics_tpu_torch.wrappers import BootStrapper  # noqa: F401
from metrics_tpu_torch.functional.regression import (  # noqa: F401
    explained_variance,
    mean_absolute_error,
    mean_relative_error,
    mean_squared_error,
    mean_squared_log_error,
    psnr,
    r2score,
    ssim,
)
