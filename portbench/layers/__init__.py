"""Per-layer readers, one module per per-layer metric of ``BENCHMARK.json``,
named as the metric is. Each has ``read(ctx)``, returning the metric's
value from a traced run, or None where it finds nothing to read.

``ctx`` holds:

* ``trace``: a :class:`portbench.trace.Trace` of the profiled stretch, or None;
* ``epochs``: the epochs in the profiled stretch;
* ``update_host_s``: host seconds of each ``update`` call of the untraced
  window;
* ``syncs``: by phase (``update``, ``compute``), the host synchronizations
  counted under ``torch.cuda.set_sync_debug_mode("warn")`` in epochs of
  their own, neither profiled nor timed, and the calls they were counted
  over;
* ``scan_shape``: ``(rows, n)`` of each tie-scan call an epoch makes.
"""
