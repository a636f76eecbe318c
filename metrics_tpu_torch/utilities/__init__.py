from metrics_tpu_torch.utilities.data import apply_to_collection  # noqa: F401
from metrics_tpu_torch.utilities.distributed import class_reduce, reduce  # noqa: F401
from metrics_tpu_torch.utilities.prints import rank_zero_warn, warn_once  # noqa: F401
