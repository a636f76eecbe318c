"""Segmented tie-group scan: the exact AUROC/AP epilogue after the co-sort.

Port of ``metrics_tpu/ops/tie_scan_pallas.py``. On CUDA tensors,
:func:`tie_group_reduce` (one stream) and :func:`tie_group_reduce_rows` (a
``(C, N)`` batch of streams, the JAX package's ``jax.vmap`` over classes)
launch the hand-written kernel in ``csrc/tie_scan.cu``, whose source note
gives its design and bound: one launch (plus one memset of its scratch)
that reads the stream once in 4096-element tiles, with a decoupled
look-back across them; unweighted, over int32 counts joined by a warp
tree, weighted (``weights_s`` given), over float64 sums folded in tile
order. On CPU tensors they run
:func:`tie_group_reduce_reference` / :func:`tie_group_reduce_rows_reference`,
the plain PyTorch version of the same formula. There is no other path: a
CUDA launch that fails raises.

Formulation (as in the JAX package): walking the key-sorted stream, each
tie-group *start* (``key != prev key``) closes the previous group, whose end
sums are the exclusive prefix sums at the start; the group-before-that's
end sums are the latest earlier start's prefix sums (a cummax forward-fill:
sums of non-negative terms never decrease). Each closed group adds AUROC's
trapezoid chord and AP's ``ΔR·P`` term; the last group is closed after the
stream. Unweighted, the sums are int32 counts (an f32 cumulant sticks at
2^24) and the terms f32; weighted, they are float64 weight sums and the
terms float64, with a ``1e-30`` floor under the precision's denominator
instead of 1. :func:`auroc_ap_from_stats` normalizes with no floor.

The payload is ``rel + 2*valid`` (f32): only 3 (relevant, valid) and 2
(irrelevant, valid) move the sums; 0 and 1 (masked) are inert, whatever
their weight.
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
    """The formula in plain tensor ops along ``dim=1`` of ``(R, N)`` rows.
    ``pos``/``neg`` are bool masks (counts: i32 cumsums, f32 terms summed in
    f64, as the kernel accumulates them) or float64 weights (f64 cumsums
    made monotone by a cummax, f64 terms, the ``1e-30`` floor). Returns
    ``(R, 4)`` float32."""
    off_p, off_n = _offsets(offsets)
    rows, n = key.shape
    if n == 0:
        return torch.zeros(rows, 4, dtype=torch.float32, device=key.device)
    weighted = pos.dtype == torch.float64
    if weighted:
        # reassociated float prefix sums may dip by an ulp; cummax repairs it
        tp_incl = torch.cummax(torch.cumsum(pos, 1), 1).values
        fp_incl = torch.cummax(torch.cumsum(neg, 1), 1).values
        zero = tp_incl.new_zeros(rows, 1)
        tp = torch.cat([zero, tp_incl[:, :-1]], 1)  # exclusive prefix sums
        fp = torch.cat([zero, fp_incl[:, :-1]], 1)
        t_pos, t_neg = tp_incl[:, -1], fp_incl[:, -1]
        term, floor = torch.float64, 1e-30
    else:
        pos = pos.to(torch.int32)
        neg = neg.to(torch.int32)
        tp = torch.cumsum(pos, 1, dtype=torch.int32) - pos  # exclusive prefix counts
        fp = torch.cumsum(neg, 1, dtype=torch.int32) - neg
        t_pos, t_neg = tp[:, -1] + pos[:, -1], fp[:, -1] + neg[:, -1]
        term, floor = torch.float32, 1.0
    is_first = torch.ones(rows, n, dtype=torch.bool, device=key.device)
    is_first[:, 1:] = key[:, 1:] != key[:, :-1]
    # latest group-start prefix at or before each element; shifted by one it
    # is the one strictly before (0 before the first start)
    tp_fill = torch.cummax(torch.where(is_first, tp, 0), 1).values
    fp_fill = torch.cummax(torch.where(is_first, fp, 0), 1).values
    zero = tp_fill.new_zeros(rows, 1)
    mt = torch.cat([zero, tp_fill[:, :-1]], 1).to(term)
    mf = torch.cat([zero, fp_fill[:, :-1]], 1).to(term)
    tpf = tp.to(term)
    fpf = fp.to(term)
    chord = torch.where(is_first, 0.5 * (tpf + mt) * (fpf - mf), 0.0)
    prec = (tpf + off_p) / torch.clamp_min(tpf + fpf + off_p + off_n, floor)
    ap_term = torch.where(is_first, (tpf - mt) * prec, 0.0)
    # close each row's last group
    t_pos, t_neg = t_pos.to(term), t_neg.to(term)
    mt_last = tp_fill[:, -1].to(term)
    mf_last = fp_fill[:, -1].to(term)
    area_close = 0.5 * (t_pos + mt_last) * (t_neg - mf_last)
    ap_close = (t_pos - mt_last) * ((t_pos + off_p) / torch.clamp_min(t_pos + t_neg + off_p + off_n, floor))
    area = chord.sum(1, dtype=torch.float64) + area_close.double()
    ap_sum = ap_term.sum(1, dtype=torch.float64) + ap_close.double()
    return torch.stack([area, ap_sum, t_pos.double(), t_neg.double()], 1).float()


def _as_int32(key_s: torch.Tensor) -> torch.Tensor:
    return key_s.view(torch.int32) if key_s.dtype == torch.uint32 else key_s


def tie_group_reduce_rows_reference(
    key_s: torch.Tensor, payload_s: torch.Tensor, offsets: Offsets = None, weights_s: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain PyTorch version of :func:`tie_group_reduce_rows`, on any device."""
    pos, neg = payload_s == 3.0, payload_s == 2.0
    if weights_s is not None:
        w = weights_s.to(torch.float64)
        pos, neg = torch.where(pos, w, 0.0), torch.where(neg, w, 0.0)
    return _scan_reference(_as_int32(key_s), pos, neg, offsets)


def tie_group_reduce_reference(
    key_s: torch.Tensor, payload_s: torch.Tensor, offsets: Offsets = None, weights_s: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain PyTorch version of :func:`tie_group_reduce`, on any device: the
    batch of one row."""
    weights_rows = None if weights_s is None else weights_s[None]
    return tie_group_reduce_rows_reference(key_s[None], payload_s[None], offsets, weights_rows)[0]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _native.load("tie_scan")
    # pointers and the stream as c_void_p: a bare Python int would be cut to 32 bits
    ptr, size, off = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    # the streams and sizes, then off_p, off_n, the buffers (scratch, out)
    # and the stream
    signatures = {
        "tie_scan": [ptr, ptr, size, off, off] + [ptr] * 3,
        "tie_scan_rows": [ptr, ptr, size, size, off, off] + [ptr] * 3,
        "tie_scan_w": [ptr, ptr, ptr, size, off, off] + [ptr] * 3,
        "tie_scan_rows_w": [ptr, ptr, ptr, size, size, off, off] + [ptr] * 3,
    }
    for entry, args in signatures.items():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_int, *args]
        fn.restype = ctypes.c_int
    lib.tie_scan_scratch_bytes.argtypes = [size, size, ctypes.c_int]
    lib.tie_scan_scratch_bytes.restype = size
    return lib


def _streams(key_s: torch.Tensor, payload_s: torch.Tensor, weights_s: Optional[torch.Tensor]):
    return (key_s, payload_s) if weights_s is None else (key_s, payload_s, weights_s)


def _check_cuda_inputs(fn: str, streams: Sequence[torch.Tensor], ndim: int) -> Tuple[int, ...]:
    """Validate what the kernel takes (``key_s``, ``payload_s`` and, weighted,
    ``weights_s``); returns their shape."""
    named = list(zip(("key_s", "payload_s", "weights_s"), streams))
    key_s = streams[0]
    if key_s.device.type != "cuda" or any(t.device != key_s.device for _, t in named):
        devices = ", ".join(str(t.device) for _, t in named)
        raise ValueError(f"{fn}: {', '.join(f'`{a}`' for a, _ in named)} must be on one CUDA device or all on"
                         f" the CPU, got {devices}")
    if key_s.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"{fn}: `key_s` must be uint32 or int32, got {key_s.dtype}")
    for arg, t in named[1:]:
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: `{arg}` must be float32, got {t.dtype}")
    shape = tuple(key_s.shape)
    for arg, t in named:
        if t.ndim != ndim or tuple(t.shape) != shape:
            raise ValueError(f"{fn}: `{arg}` must be {ndim}-d of the keys' shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: `{arg}` must be contiguous")
    if shape[-1] >= 2**31:
        raise ValueError(
            f"{fn}: the kernel counts in int32 and takes fewer than 2^31 elements per stream, got {shape[-1]}"
        )
    return shape


def _buffers(rows: int, n: int, weighted: bool, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scratch and output of one launch over ``rows`` streams of ``n``; the
    caller holds them until the launch is queued. The launch fills its
    scratch itself, and the size is the library's, so this module does not
    copy its layout."""
    scratch = torch.empty(_library().tie_scan_scratch_bytes(rows, n, weighted), dtype=torch.uint8, device=device)
    return scratch, torch.empty(rows, 4, dtype=torch.float32, device=device)


def _launch(entry: str, streams: Sequence[torch.Tensor], sizes: Tuple[int, ...], offsets: Offsets) -> torch.Tensor:
    """Launch ``entry`` on PyTorch's current stream of the tensors' device;
    returns its ``(rows, 4)`` output. ``sizes`` is ``(n,)`` or ``(rows, n)``."""
    device = streams[0].device
    rows, n = (1, *sizes) if len(sizes) == 1 else sizes
    buffers = _buffers(rows, n, len(streams) == 3, device)
    err = getattr(_library(), entry)(
        device.index, *(t.data_ptr() for t in streams), *sizes, *_offsets(offsets),
        *(t.data_ptr() for t in buffers), torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed with CUDA error {err}")
    return buffers[-1]


def tie_group_reduce(
    key_s: torch.Tensor, payload_s: torch.Tensor, offsets: Offsets = None, weights_s: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """AUROC area + AP sum + class totals of a key-sorted stream.

    Args:
        key_s: ``(N,)`` uint32 keys (or int32 keys; only equality is read),
            already sorted.
        payload_s: ``(N,)`` float32 ``rel + 2*valid`` co-sorted payload;
            only 3 (relevant, valid) and 2 (irrelevant, valid) move the sums.
        offsets: optional ``[off_p, off_n]`` global class totals in all
            strictly-lower key ranges; they shift the AP precision ratio,
            the caller adds ``off_p * neg`` to the area.
        weights_s: optional ``(N,)`` non-negative float32 weights, co-sorted
            with the keys: the sums become weight sums (float64 in the
            kernel) and the denominator floor ``1e-30``.

    Returns:
        ``(4,)`` float32 ``[area, ap_sum, pos, neg]`` on the input's device.

    ``tie_group_reduce.launches`` counts the unweighted kernel's launches,
    ``.weighted_launches`` the weighted kernel's, and ``.offset_launches``
    those of either that were given ``offsets``.
    """
    if key_s.device.type == "cpu" and payload_s.device.type == "cpu":
        return tie_group_reduce_reference(key_s, payload_s, offsets, weights_s)
    streams = _streams(key_s, payload_s, weights_s)
    shape = _check_cuda_inputs("tie_group_reduce", streams, 1)
    weighted = weights_s is not None
    out = _launch("tie_scan_w" if weighted else "tie_scan", streams, shape, offsets)
    if weighted:
        tie_group_reduce.weighted_launches += 1
    else:
        tie_group_reduce.launches += 1
    if offsets is not None:
        tie_group_reduce.offset_launches += 1
    return out[0]


tie_group_reduce.launches = 0
tie_group_reduce.weighted_launches = 0
tie_group_reduce.offset_launches = 0


def tie_group_reduce_rows(
    key_s: torch.Tensor, payload_s: torch.Tensor, offsets: Offsets = None, weights_s: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """:func:`tie_group_reduce` of every row of a ``(C, N)`` batch, in one launch.

    The class-batched call shape: the JAX package gets it from ``jax.vmap``
    of its Pallas kernel over the C classes of an ``(N, C)`` input; here each
    row is one class's stream, sorted by key within the row.

    Args:
        key_s: ``(C, N)`` uint32 (or int32) keys, each row sorted.
        payload_s: ``(C, N)`` float32 co-sorted payloads, as in
            :func:`tie_group_reduce`.
        offsets: optional ``[off_p, off_n]``, the same for every row.
        weights_s: optional ``(C, N)`` float32 co-sorted weights.

    Returns:
        ``(C, 4)`` float32, row ``c`` = ``[area, ap_sum, pos, neg]`` of row ``c``.

    ``tie_group_reduce_rows.launches`` counts the unweighted kernel's
    launches, ``.weighted_launches`` the weighted kernel's.
    """
    if key_s.device.type == "cpu" and payload_s.device.type == "cpu":
        return tie_group_reduce_rows_reference(key_s, payload_s, offsets, weights_s)
    streams = _streams(key_s, payload_s, weights_s)
    shape = _check_cuda_inputs("tie_group_reduce_rows", streams, 2)
    if shape[0] == 0:
        return torch.zeros(0, 4, dtype=torch.float32, device=key_s.device)
    weighted = weights_s is not None
    out = _launch("tie_scan_rows_w" if weighted else "tie_scan_rows", streams, shape, offsets)
    if weighted:
        tie_group_reduce_rows.weighted_launches += 1
    else:
        tie_group_reduce_rows.launches += 1
    return out


tie_group_reduce_rows.launches = 0
tie_group_reduce_rows.weighted_launches = 0


def auroc_ap_from_stats(stats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(AUROC, AP) from :func:`tie_group_reduce` (``(4,)``) or
    :func:`tie_group_reduce_rows` (``(C, 4)``) output, NaN on degenerate.

    The degeneracy test checks each class total on its own, and the
    normalization divides by each total on its own, in float64: the product
    of tiny weighted totals underflows, and a floor under it would change
    the value. Results are float32."""
    area, ap_sum, n_pos, n_neg = stats.double().unbind(-1)
    nan = torch.full((), float("nan"), dtype=torch.float64, device=stats.device)
    auroc = torch.where((n_pos == 0) | (n_neg == 0), nan, area / n_pos / n_neg)
    ap = torch.where(n_pos == 0, nan, ap_sum / n_pos)
    return auroc.float(), ap.float()
