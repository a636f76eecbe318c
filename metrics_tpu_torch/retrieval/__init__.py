from metrics_tpu_torch.retrieval.mean_average_precision import RetrievalMAP  # noqa: F401
from metrics_tpu_torch.retrieval.mean_reciprocal_rank import RetrievalMRR  # noqa: F401
from metrics_tpu_torch.retrieval.precision import RetrievalPrecision  # noqa: F401
from metrics_tpu_torch.retrieval.recall import RetrievalRecall  # noqa: F401
from metrics_tpu_torch.retrieval.retrieval_metric import IGNORE_IDX, RetrievalMetric  # noqa: F401
from metrics_tpu_torch.retrieval.sharded import (  # noqa: F401
    ShardedRetrievalMAP,
    ShardedRetrievalMetric,
    ShardedRetrievalMRR,
    ShardedRetrievalPrecision,
    ShardedRetrievalRecall,
)
