from metrics_tpu_torch.functional.retrieval.average_precision import retrieval_average_precision  # noqa: F401
from metrics_tpu_torch.functional.retrieval.precision import retrieval_precision  # noqa: F401
from metrics_tpu_torch.functional.retrieval.recall import retrieval_recall  # noqa: F401
from metrics_tpu_torch.functional.retrieval.reciprocal_rank import retrieval_reciprocal_rank  # noqa: F401
