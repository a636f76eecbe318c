from metrics_tpu_torch.classification.accuracy import Accuracy  # noqa: F401
from metrics_tpu_torch.classification.auroc import AUROC  # noqa: F401
from metrics_tpu_torch.classification.average_precision import AveragePrecision  # noqa: F401
from metrics_tpu_torch.classification.sharded import (  # noqa: F401
    ShardedAUROC,
    ShardedAveragePrecision,
    ShardedCurveMetric,
)
