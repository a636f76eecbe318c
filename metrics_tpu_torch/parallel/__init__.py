from metrics_tpu_torch.parallel.backend import (  # noqa: F401
    MultiHostBackend,
    SingleProcessBackend,
    SyncBackend,
    TorchDistributedBackend,
    get_sync_backend,
    is_distributed_initialized,
    set_sync_backend,
)
from metrics_tpu_torch.parallel.hierarchy import (  # noqa: F401
    HierarchicalSyncBackend,
    HierarchicalSyncOutcome,
    PodUnreachableError,
    QuorumSnapshot,
    SyncTopology,
    last_quorum,
)
from metrics_tpu_torch.parallel.collective import (  # noqa: F401
    masked_cat_sync,
    qsync_state,
    qsync_sum,
    sync_array,
    sync_state,
)
from metrics_tpu_torch.parallel.quantize import (  # noqa: F401
    DEFAULT_BLOCK_SIZE,
    PRECISIONS,
    dequantize_block_scaled,
    dequantize_payload,
    quantize_block_scaled,
    quantize_payload,
    quantized_sum_reduction,
)
from metrics_tpu_torch.parallel.sample_sort import sample_sort_auroc_ap, sample_sort_retrieval  # noqa: F401
