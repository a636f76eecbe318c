from metrics_tpu_torch.parallel.backend import (  # noqa: F401
    SingleProcessBackend,
    SyncBackend,
    TorchDistributedBackend,
    get_sync_backend,
    is_distributed_initialized,
    set_sync_backend,
)
from metrics_tpu_torch.parallel.collective import masked_cat_sync  # noqa: F401
from metrics_tpu_torch.parallel.sample_sort import sample_sort_auroc_ap, sample_sort_retrieval  # noqa: F401
