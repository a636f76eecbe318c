"""Segmented tie-group scan: the exact AUROC/AP epilogue after the co-sort.

Port of ``metrics_tpu/ops/tie_scan_pallas.py``. On CUDA tensors,
:func:`tie_group_reduce` (one stream) and :func:`tie_group_reduce_rows` (a
``(C, N)`` batch of streams, the JAX package's ``jax.vmap`` over classes)
launch the hand-written kernel in ``csrc/tie_scan.cu`` (reduce-then-scan
over 4096-element tiles with the row as a grid dimension; its source note
gives the design and its bound). On CPU tensors they run
:func:`tie_group_reduce_reference` / :func:`tie_group_reduce_rows_reference`,
the plain PyTorch version of the same formula. There is no other path: a
CUDA launch that fails raises.

Formulation (as in the JAX package): walking the key-sorted stream, each
tie-group *start* (``key != prev key``) closes the previous group, whose end
counts are the exclusive prefix counts at the start; the group-before-that's
end counts are the latest earlier start's prefix counts (a cummax
forward-fill — counts never decrease). Each closed group adds AUROC's
trapezoid chord and AP's ``ΔR·P`` term; the last group is closed after the
stream. Counts are int32: an f32 cumulant sticks at 2^24.

The payload is ``rel + 2*weight`` (f32): only 3 (relevant, valid) and 2
(irrelevant, valid) move counts; 0 and 1 (weight 0 — masked) are inert.
"""
import ctypes
import functools
from typing import Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.ops import _native

Offsets = Optional[Union[torch.Tensor, Sequence[float]]]


def _offsets(offsets: Offsets) -> Tuple[float, float]:
    """``[off_p, off_n]``: global class counts below this stream (a
    distributed sample-sort bucket); they shift only the AP precision ratio.
    The area stays local: the caller adds ``off_p * n_neg`` to it."""
    if offsets is None:
        return 0.0, 0.0
    off_p, off_n = torch.as_tensor(offsets, dtype=torch.float32).tolist()
    return off_p, off_n


def _scan_reference(key: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor, offsets: Offsets) -> torch.Tensor:
    """The formula in plain tensor ops along ``dim=1`` of ``(R, N)`` rows:
    i32 cumsums, a cummax forward-fill, f32 terms (summed in f64, as the
    kernel accumulates them). Returns ``(R, 4)``."""
    off_p, off_n = _offsets(offsets)
    rows, n = key.shape
    if n == 0:
        return torch.zeros(rows, 4, dtype=torch.float32, device=key.device)
    pos = pos.to(torch.int32)
    neg = neg.to(torch.int32)
    tp = torch.cumsum(pos, 1, dtype=torch.int32) - pos  # exclusive prefix counts
    fp = torch.cumsum(neg, 1, dtype=torch.int32) - neg
    is_first = torch.ones(rows, n, dtype=torch.bool, device=key.device)
    is_first[:, 1:] = key[:, 1:] != key[:, :-1]
    # latest group-start prefix at or before each element; shifted by one it
    # is the one strictly before (0 before the first start)
    tp_fill = torch.cummax(torch.where(is_first, tp, 0), 1).values
    fp_fill = torch.cummax(torch.where(is_first, fp, 0), 1).values
    zero = tp_fill.new_zeros(rows, 1)
    mt = torch.cat([zero, tp_fill[:, :-1]], 1).to(torch.float32)
    mf = torch.cat([zero, fp_fill[:, :-1]], 1).to(torch.float32)
    tpf = tp.to(torch.float32)
    fpf = fp.to(torch.float32)
    chord = torch.where(is_first, 0.5 * (tpf + mt) * (fpf - mf), 0.0)
    prec = (tpf + off_p) / torch.clamp_min(tpf + fpf + off_p + off_n, 1.0)
    ap_term = torch.where(is_first, (tpf - mt) * prec, 0.0)
    # close each row's last group
    t_pos = (tp[:, -1] + pos[:, -1]).to(torch.float32)
    t_neg = (fp[:, -1] + neg[:, -1]).to(torch.float32)
    mt_last = tp_fill[:, -1].to(torch.float32)
    mf_last = fp_fill[:, -1].to(torch.float32)
    area_close = 0.5 * (t_pos + mt_last) * (t_neg - mf_last)
    ap_close = (t_pos - mt_last) * ((t_pos + off_p) / torch.clamp_min(t_pos + t_neg + off_p + off_n, 1.0))
    area = chord.sum(1, dtype=torch.float64) + area_close.double()
    ap_sum = ap_term.sum(1, dtype=torch.float64) + ap_close.double()
    return torch.stack([area.float(), ap_sum.float(), t_pos, t_neg], 1)


def _as_int32(key_s: torch.Tensor) -> torch.Tensor:
    return key_s.view(torch.int32) if key_s.dtype == torch.uint32 else key_s


def tie_group_reduce_rows_reference(
    key_s: torch.Tensor, payload_s: torch.Tensor, offsets: Offsets = None
) -> torch.Tensor:
    """Plain PyTorch version of :func:`tie_group_reduce_rows`, on any device."""
    return _scan_reference(_as_int32(key_s), payload_s == 3.0, payload_s == 2.0, offsets)


def tie_group_reduce_reference(
    key_s: torch.Tensor, payload_s: torch.Tensor, offsets: Offsets = None
) -> torch.Tensor:
    """Plain PyTorch version of :func:`tie_group_reduce`, on any device: the
    batch of one row."""
    return tie_group_reduce_rows_reference(key_s[None], payload_s[None], offsets)[0]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _native.load("tie_scan")
    # pointers and the stream as c_void_p: a bare Python int would be cut to 32 bits
    buffers = [ctypes.c_void_p] * 4  # scratch, partial, out, stream
    lib.tie_scan.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
        *buffers,
    ]
    lib.tie_scan.restype = ctypes.c_int
    lib.tie_scan_rows.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float,
        ctypes.c_float, *buffers,
    ]
    lib.tie_scan_rows.restype = ctypes.c_int
    lib.tie_scan_tile_elems.argtypes = []
    lib.tie_scan_tile_elems.restype = ctypes.c_int
    return lib


def _check_cuda_inputs(fn: str, key_s: torch.Tensor, payload_s: torch.Tensor, ndim: int) -> Tuple[int, ...]:
    """Validate what the kernel takes; returns the inputs' shape."""
    if key_s.device.type != "cuda" or payload_s.device != key_s.device:
        raise ValueError(
            f"{fn}: `key_s` and `payload_s` must be on one CUDA device or both on the CPU,"
            f" got {key_s.device} and {payload_s.device}"
        )
    if key_s.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"{fn}: `key_s` must be uint32 or int32, got {key_s.dtype}")
    if payload_s.dtype != torch.float32:
        raise TypeError(f"{fn}: `payload_s` must be float32, got {payload_s.dtype}")
    shape = tuple(key_s.shape)
    for arg, t in (("key_s", key_s), ("payload_s", payload_s)):
        if t.ndim != ndim or tuple(t.shape) != shape:
            raise ValueError(f"{fn}: `{arg}` must be {ndim}-d of the keys' shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: `{arg}` must be contiguous")
    if shape[-1] >= 2**31:
        raise ValueError(
            f"{fn}: the kernel counts in int32 and takes fewer than 2^31 elements per stream, got {shape[-1]}"
        )
    return shape


def _buffers(rows: int, n: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scratch, partials and output of one launch over ``rows`` streams of
    ``n``; the caller holds them until the launch is queued."""
    tiles = max(1, -(-n // _library().tie_scan_tile_elems()))
    scratch = torch.empty(rows * (8 * tiles + 4), dtype=torch.int32, device=device)
    partial = torch.empty(rows * 2 * tiles, dtype=torch.float64, device=device)
    out = torch.empty(rows, 4, dtype=torch.float32, device=device)
    return scratch, partial, out


def _launch_tail(buffers: Sequence[torch.Tensor], device: torch.device) -> Tuple[int, ...]:
    """The trailing arguments of both entry points: buffer pointers, stream."""
    return (*(t.data_ptr() for t in buffers), torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, entry: str) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed with CUDA error {err}")


def tie_group_reduce(key_s: torch.Tensor, payload_s: torch.Tensor, offsets: Offsets = None) -> torch.Tensor:
    """AUROC area + AP sum + class totals of a key-sorted stream.

    Args:
        key_s: ``(N,)`` uint32 keys (or int32 keys; only equality is read),
            already sorted.
        payload_s: ``(N,)`` float32 ``rel + 2*weight`` co-sorted payload;
            only 3 (relevant, valid) and 2 (irrelevant, valid) move counts.
        offsets: optional ``[off_p, off_n]`` global class counts in all
            strictly-lower key ranges; they shift the AP precision ratio,
            the caller adds ``off_p * n_neg`` to the area.

    Returns:
        ``(4,)`` float32 ``[area, ap_sum, n_pos, n_neg]`` on the input's device.

    ``tie_group_reduce.launches`` counts the kernel's launches.
    """
    if key_s.device.type == "cpu" and payload_s.device.type == "cpu":
        return tie_group_reduce_reference(key_s, payload_s, offsets)
    (n,) = _check_cuda_inputs("tie_group_reduce", key_s, payload_s, 1)
    off_p, off_n = _offsets(offsets)
    device = key_s.device
    buffers = _buffers(1, n, device)
    err = _library().tie_scan(
        device.index, key_s.data_ptr(), payload_s.data_ptr(), n, off_p, off_n, *_launch_tail(buffers, device)
    )
    tie_group_reduce.launches += 1
    _raise_on(err, "tie_scan")
    return buffers[2][0]


tie_group_reduce.launches = 0


def tie_group_reduce_rows(key_s: torch.Tensor, payload_s: torch.Tensor, offsets: Offsets = None) -> torch.Tensor:
    """:func:`tie_group_reduce` of every row of a ``(C, N)`` batch, in one launch.

    The class-batched call shape: the JAX package gets it from ``jax.vmap``
    of its Pallas kernel over the C classes of an ``(N, C)`` input; here each
    row is one class's stream, sorted by key within the row.

    Args:
        key_s: ``(C, N)`` uint32 (or int32) keys, each row sorted.
        payload_s: ``(C, N)`` float32 co-sorted payloads, as in
            :func:`tie_group_reduce`.
        offsets: optional ``[off_p, off_n]``, the same for every row.

    Returns:
        ``(C, 4)`` float32, row ``c`` = ``[area, ap_sum, n_pos, n_neg]`` of row ``c``.

    ``tie_group_reduce_rows.launches`` counts the kernel's launches.
    """
    if key_s.device.type == "cpu" and payload_s.device.type == "cpu":
        return tie_group_reduce_rows_reference(key_s, payload_s, offsets)
    rows, n = _check_cuda_inputs("tie_group_reduce_rows", key_s, payload_s, 2)
    if rows == 0:
        return torch.zeros(0, 4, dtype=torch.float32, device=key_s.device)
    off_p, off_n = _offsets(offsets)
    device = key_s.device
    buffers = _buffers(rows, n, device)
    err = _library().tie_scan_rows(
        device.index, key_s.data_ptr(), payload_s.data_ptr(), rows, n, off_p, off_n, *_launch_tail(buffers, device)
    )
    tie_group_reduce_rows.launches += 1
    _raise_on(err, "tie_scan_rows")
    return buffers[2]


tie_group_reduce_rows.launches = 0


def auroc_ap_from_stats(stats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(AUROC, AP) from :func:`tie_group_reduce` (``(4,)``) or
    :func:`tie_group_reduce_rows` (``(C, 4)``) output, NaN on degenerate.

    The degeneracy test checks each class total on its own, not their
    product, which underflows at tiny weighted totals."""
    area, ap_sum, n_pos, n_neg = stats.unbind(-1)
    nan = torch.full((), float("nan"), dtype=stats.dtype, device=stats.device)
    auroc = torch.where((n_pos == 0) | (n_neg == 0), nan, area / torch.clamp_min(n_pos * n_neg, 1e-30))
    ap = torch.where(n_pos == 0, nan, ap_sum / torch.clamp_min(n_pos, 1e-30))
    return auroc, ap
