from metrics_tpu_torch.wrappers.bootstrapping import BootStrapper  # noqa: F401
