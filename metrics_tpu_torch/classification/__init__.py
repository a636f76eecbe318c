from metrics_tpu_torch.classification.accuracy import Accuracy  # noqa: F401
from metrics_tpu_torch.classification.auc import AUC  # noqa: F401
from metrics_tpu_torch.classification.auroc import AUROC  # noqa: F401
from metrics_tpu_torch.classification.average_precision import AveragePrecision  # noqa: F401
from metrics_tpu_torch.classification.binned import (  # noqa: F401
    BinnedAUROC,
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
)
from metrics_tpu_torch.classification.precision_recall_curve import PrecisionRecallCurve  # noqa: F401
from metrics_tpu_torch.classification.roc import ROC  # noqa: F401
from metrics_tpu_torch.classification.sharded import (  # noqa: F401
    ShardedAUROC,
    ShardedAveragePrecision,
    ShardedCurveMetric,
    ShardedPrecisionRecallCurve,
    ShardedROC,
)
