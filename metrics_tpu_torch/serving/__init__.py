"""Continuous serving: a metric's cost on the serve loop's step, toward 0.

Port of ``metrics_tpu/serving/``. Batch eval tolerates a ``forward()`` that
waits for the metric's step and a ``checkpoint()`` that writes the state
while the loop waits; a process measuring live traffic does not. Three
pieces, each off unless constructed:

* **Asynchronous double-buffered dispatch** (:class:`AsyncServingEngine`,
  :mod:`.async_engine`): ``forward()`` stages the batch and returns; a
  daemon worker steps it on a CUDA stream of its own. Admission refuses
  targets whose generations could share a tensor; they are served on the
  blocking path. ``compute()``, ``state_dict()`` and ``drain()`` are the
  barriers, where a batch's failure surfaces.
* **Streaming admission** (:class:`IngestQueue`, :mod:`.ingest`): flat
  ``(tenant_id, rows)`` streams micro-batched through
  :func:`~metrics_tpu_torch.cohort.route_rows` into a cohort, with
  ``block`` / ``shed_oldest`` / ``shed_by_health`` backpressure.
* **Background checkpoints** (:class:`BackgroundCheckpointer`,
  :mod:`.bgcheckpoint`): a snapshot on the card at a barrier, fetched to
  pinned host memory on the writer's own stream and committed through the
  journal's atomic rename (``EvalSession(background_checkpoints=True)``).

:class:`ServingSLO` (:mod:`.slo`) turns the pipeline's latency histograms
into burn gauges, a verdict and one flight dump per sustained breach.
Telemetry uses the ``serving.*`` keys of the JAX package.
"""
from metrics_tpu_torch.serving.async_engine import AsyncServingEngine, ServingAdmissionError  # noqa: F401
from metrics_tpu_torch.serving.bgcheckpoint import BackgroundCheckpointer  # noqa: F401
from metrics_tpu_torch.serving.ingest import IngestOverflowError, IngestQueue  # noqa: F401
from metrics_tpu_torch.serving.slo import ServingSLO  # noqa: F401

__all__ = [
    "AsyncServingEngine",
    "BackgroundCheckpointer",
    "IngestOverflowError",
    "IngestQueue",
    "ServingAdmissionError",
    "ServingSLO",
]
