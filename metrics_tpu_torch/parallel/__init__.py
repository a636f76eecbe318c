from metrics_tpu_torch.parallel.backend import (  # noqa: F401
    SingleProcessBackend,
    SyncBackend,
    TorchDistributedBackend,
    get_sync_backend,
    is_distributed_initialized,
    set_sync_backend,
)
