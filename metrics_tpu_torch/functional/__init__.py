from metrics_tpu_torch.functional.classification.accuracy import accuracy  # noqa: F401
from metrics_tpu_torch.functional.classification.auroc import auroc  # noqa: F401
from metrics_tpu_torch.functional.classification.average_precision import average_precision  # noqa: F401
