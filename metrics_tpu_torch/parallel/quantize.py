"""Block-scaled low-precision payload codecs for the quantized sync tier.

Port of ``metrics_tpu/parallel/quantize.py``. A sum-reduced state can cross
the wire in a narrower form than its registered dtype:

* :func:`quantize_block_scaled` / :func:`dequantize_block_scaled` — the
  int8 codec: values are flattened, grouped into fixed-size blocks, and
  each block is mapped onto ``[-127, 127]`` by its own f32 scale
  (``absmax / 127``). Per-element error is bounded by ``absmax_block/254``
  (half a quantization step), so one badly scaled outlier only costs its
  own block, not the whole tensor.
* :func:`quantize_payload` / :func:`dequantize_payload` — the wire format
  shared by the host sync path (``Metric._sync_dist``) and the collective
  (:func:`metrics_tpu_torch.parallel.collective.qsync_sum`): a dict of
  tensors whose total bytes ARE the wire cost (int8 codes + f32 block
  scales for ``"int8"``, a bf16 cast for ``"bf16"``).
* :func:`compensate_and_quantize` — error feedback: the caller-held f32
  residual (the previous sync's quantization error) is added *before*
  quantizing and the new error handed back, so repeated syncs of an
  accumulating state do not drift.
* :func:`quantized_sum_reduction` — the gathered-payload merge as a plain
  ``(world, ...) -> (...)`` reduction callable.

``torch.round`` and ``jnp.round`` both round half to even and both casts to
bf16 round to nearest even, so codes, scales and bf16 payloads are the JAX
package's bits. Everything here is plain tensor math on the tensor's own
device: no collectives, no telemetry, no host read.
"""
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "DEFAULT_BLOCK_SIZE",
    "PRECISIONS",
    "compensate_and_quantize",
    "dequantize_block_scaled",
    "dequantize_payload",
    "merge_dequantized",
    "payload_wire_nbytes",
    "quantize_block_scaled",
    "quantize_payload",
    "quantized_sum_reduction",
]

#: valid values of the ``sync_precision`` knob
PRECISIONS = ("exact", "bf16", "int8")

#: elements per int8 scale block. 128 keeps the scale overhead at
#: 4/128 ≈ 3% of the code bytes (f32 → int8+scales is a 3.88× wire
#: reduction) while isolating outliers to 128-element neighborhoods.
DEFAULT_BLOCK_SIZE = 128


def _require_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"`sync_precision` must be one of {PRECISIONS}, got {precision!r}")


def _numel(shape: Sequence[int]) -> int:
    size = 1
    for d in shape:
        size *= int(d)
    return size


def quantize_block_scaled(
    x: torch.Tensor, block_size: int = DEFAULT_BLOCK_SIZE
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``x`` to ``(codes int8 (n_blocks, block_size), scales f32
    (n_blocks,))``. Symmetric round-to-nearest-even onto ``[-127, 127]``
    with a per-block ``absmax/127`` scale; all-zero blocks get scale 1
    (codes 0). Padding (to a whole number of blocks) quantizes as zeros
    and is dropped by :func:`dequantize_block_scaled`."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    n_blocks = -(-n // block_size)  # ceil
    flat = F.pad(flat, (0, n_blocks * block_size - n))
    blocks = flat.reshape(n_blocks, block_size)
    absmax = blocks.abs().amax(dim=1)
    # a tensor divisor, not a Python scalar: PyTorch's CUDA kernels multiply
    # by the reciprocal of a host scalar divisor, which rounds the scale
    # differently from the division the CPU (and JAX) performs
    scales = torch.where(absmax > 0, absmax / absmax.new_full((), 127.0), 1.0)
    codes = torch.clamp(torch.round(blocks / scales[:, None]), -127, 127).to(torch.int8)
    return codes, scales


def dequantize_block_scaled(codes: torch.Tensor, scales: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Reconstruct the f32 tensor of ``shape`` from block-scaled int8 codes."""
    vals = codes.to(torch.float32) * scales[:, None].to(torch.float32)
    return vals.reshape(-1)[: _numel(shape)].reshape(tuple(shape))


def quantize_payload(
    x: torch.Tensor, precision: str, block_size: int = DEFAULT_BLOCK_SIZE
) -> Dict[str, torch.Tensor]:
    """``x`` as a wire payload dict for ``precision``: ``{"q": int8 codes,
    "scales": f32}`` for int8, ``{"q": bf16}`` for bf16. The summed bytes
    of the dict's tensors are the wire cost of shipping ``x``."""
    _require_precision(precision)
    if precision == "int8":
        codes, scales = quantize_block_scaled(x, block_size)
        return {"q": codes, "scales": scales}
    if precision == "bf16":
        return {"q": x.to(torch.bfloat16)}
    raise ValueError("`exact` states have no quantized payload")


def dequantize_payload(payload: Dict[str, torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """Reconstruct one rank's f32 contribution from its wire payload."""
    if "scales" in payload:
        return dequantize_block_scaled(payload["q"], payload["scales"], shape)
    return payload["q"].to(torch.float32).reshape(tuple(shape))


def payload_wire_nbytes(payload: Any) -> int:
    """Bytes a payload puts on the wire, from tensor metadata (nothing is
    read from the device)."""
    if isinstance(payload, torch.Tensor):
        return payload.numel() * payload.element_size()
    if isinstance(payload, dict):
        return sum(payload_wire_nbytes(v) for v in payload.values())
    if isinstance(payload, (list, tuple)):
        return sum(payload_wire_nbytes(v) for v in payload)
    return 0


def _is_integer(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex and dtype != torch.bool


def merge_dequantized(payloads: Sequence[Dict[str, torch.Tensor]], shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """THE quantized cross-replica merge: sum each rank's dequantized f32
    contribution in rank order and land back on the state's ``dtype``
    (integer states re-round onto their lattice first, half to even: a sum
    of near-integers must stay a count). One implementation shared by the
    host sync path (``Metric._sync_dist``), the collective
    (:func:`~metrics_tpu_torch.parallel.collective.qsync_sum`), the
    hierarchical engine and :func:`quantized_sum_reduction`.

    Args:
        payloads: one wire-payload dict per rank.
        shape: the state's shape.
        dtype: the state's registered dtype.
    """
    device = payloads[0]["q"].device if payloads else None
    total = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    for payload in payloads:
        total = total + dequantize_payload(payload, shape)
    if _is_integer(dtype):
        total = torch.round(total)
    return total.to(dtype)


def compensate_and_quantize(
    x: torch.Tensor,
    residual: Optional[torch.Tensor],
    precision: str,
    block_size: int = DEFAULT_BLOCK_SIZE,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Error-feedback quantization of one sync contribution.

    Returns ``(payload, new_residual)``: the wire payload of
    ``x + residual`` and the f32 quantization error the NEXT sync must
    compensate (``compensated - dequantize(payload)``). The caller commits
    ``new_residual`` only after the collective succeeds: a retried or
    degraded-to-local sync must not re-apply (or falsely advance) the
    compensation.
    """
    compensated = x.to(torch.float32)
    if residual is not None:
        compensated = compensated + residual.to(torch.float32)
    payload = quantize_payload(compensated, precision, block_size)
    new_residual = compensated - dequantize_payload(payload, compensated.shape)
    return payload, new_residual


def quantized_sum_reduction(precision: str, block_size: int = DEFAULT_BLOCK_SIZE):
    """The quantized sync tier's cross-replica merge as a plain reduction:
    ``stacked (world, ...) -> sum_r dequantize(quantize(stacked[r]))``.

    Each replica row is quantized on its own (exactly what crosses the wire)
    and the dequantized contributions are summed in f32: a commutative,
    magnitude-preserving merge. The returned callable carries
    ``quantized_precision`` / ``block_scaled`` attributes, as the JAX
    package's does for its soundness auditor.
    """
    _require_precision(precision)
    if precision == "exact":
        raise ValueError("`exact` needs no quantized reduction; use dist_reduce_fx='sum'")

    def _reduce(stacked: torch.Tensor) -> torch.Tensor:
        return merge_dequantized(
            [quantize_payload(stacked[r], precision, block_size) for r in range(stacked.shape[0])],
            stacked.shape[1:],
            stacked.dtype,
        )

    _reduce.__name__ = f"quantized_{precision}_sum"
    _reduce.quantized_precision = precision
    _reduce.block_scaled = True
    return _reduce
