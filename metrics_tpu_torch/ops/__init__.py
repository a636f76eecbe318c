"""Building-block ops shared across metric families."""
from metrics_tpu_torch.ops.segment import ranked_group_stats  # noqa: F401
