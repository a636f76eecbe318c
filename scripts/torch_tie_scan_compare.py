"""Hold this checkout's tie-scan kernel against one built from another source
of it, on one GPU: the same bits on the same inputs, and both timed in turns.

    python3 scripts/torch_tie_scan_compare.py --against OTHER/tie_scan.cu

The other source is built with ``nvcc`` into ``build/`` under its own name.
Its C interface is this checkout's or the earlier one, whose unweighted
entries take a separate float64 partials buffer (two per tile) and whose
weighted scratch size comes from ``tie_scan_w_scratch_bytes``.

Inputs: ``chip_smoke.py``'s phase 2a and 2b inputs, drawn the same way from
the same seed (the one-stream edge sizes, one tie group, signed zeros, the
tie-heavy, masked and offset 1M streams, the 20M stream, and the batched row
shapes), and weighted: phase 2c's edge sizes and 45,840,617-element stream
(the same draws) and weighted rows at phase 2b's shapes. Every output of
the two libraries must be equal bit for bit. Times: CUDA events over
launches queued behind a device sleep, at the paths' shapes, in the order
other, this, this, other. Prints the card's name and power limit and one
JSON line; exits 1 if any output differs.
"""
import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402 (the checkout's root is on the path above)
    BIG_N,
    CHUNKED_ROWS,
    CRITEO_N,
    EDGE_SIZES,
    ROW_SHAPES,
    SEED,
    TIE_HEAVY_N,
    _queued_ms,
)


def _build_other(src: Path) -> Path:
    from metrics_tpu_torch.ops import _native

    digest = hashlib.sha256(src.read_bytes() + " ".join(_native._NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = ROOT / "build" / f"libtie_scan_other-{digest}.so"
    if not lib.exists():
        lib.parent.mkdir(exist_ok=True)
        subprocess.run([_native._nvcc(), *_native._NVCC_FLAGS, "-o", str(lib), str(src)], check=True)
    return lib


def _bind(torch, path: Path):
    """``run(key_s, pay_s, offsets, w_s)`` over ``(rows, n)`` streams, through
    the library at ``path``; returns its ``(rows, 4)`` output."""
    lib = ctypes.CDLL(str(path))
    earlier = not hasattr(lib, "tie_scan_scratch_bytes")
    ptr, size, off = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    lib.tie_scan_rows.argtypes = [ctypes.c_int, ptr, ptr, size, size, off, off] + [ptr] * (4 if earlier else 3)
    lib.tie_scan_rows_w.argtypes = [ctypes.c_int, ptr, ptr, ptr, size, size, off, off] + [ptr] * 3
    lib.tie_scan_tile_elems.argtypes = []
    for fn in (lib.tie_scan_rows, lib.tie_scan_rows_w, lib.tie_scan_tile_elems):
        fn.restype = ctypes.c_int
    if earlier:
        lib.tie_scan_w_scratch_bytes.argtypes = [size, size]
        lib.tie_scan_w_scratch_bytes.restype = size
    else:
        lib.tie_scan_scratch_bytes.argtypes = [size, size, ctypes.c_int]
        lib.tie_scan_scratch_bytes.restype = size

    def run(key_s, pay_s, offsets=(0.0, 0.0), w_s=None):
        rows, n = key_s.shape
        dev = key_s.device
        out = torch.empty(rows, 4, device=dev)
        if w_s is None and earlier:
            tiles = max(1, -(-n // lib.tie_scan_tile_elems()))
            buffers = [torch.empty(rows * (8 * tiles + 4), dtype=torch.int32, device=dev),
                       torch.empty(rows * 2 * tiles, dtype=torch.float64, device=dev)]
        else:
            nbytes = lib.tie_scan_w_scratch_bytes(rows, n) if earlier else lib.tie_scan_scratch_bytes(
                rows, n, w_s is not None)
            buffers = [torch.empty(nbytes, dtype=torch.uint8, device=dev)]
        streams = [key_s, pay_s] + ([] if w_s is None else [w_s])
        entry = lib.tie_scan_rows if w_s is None else lib.tie_scan_rows_w
        err = entry(dev.index, *(t.data_ptr() for t in streams), rows, n, *offsets,
                    *(t.data_ptr() for t in buffers), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{path.name}: launch failed with CUDA error {err}")
        return out

    return run


def _inputs(torch, dev):
    """(label, (rows, n) streams, offsets) in chip_smoke.py's order of draws."""
    from metrics_tpu_torch.ops.auroc_kernel import _co_sort, _co_sort_rows, _payload, _sortable_key

    def one(scores, rel, mask=None, weights=None):
        t = [None if x is None else torch.from_numpy(np.asarray(x, np.float32)).to(dev) for x in (mask, weights)]
        streams = _co_sort(torch.from_numpy(scores).to(dev), torch.from_numpy(rel.astype(np.float32)).to(dev), *t)
        return [x[None] for x in streams]

    def rows_of(rows, n, gen):
        scores = gen.random((rows, n), dtype=np.float32)
        scores[::2] = np.round(scores[::2], 2)
        rel = gen.random((rows, n)) < 0.3
        if rows >= 3:
            scores[0] = 0.25
            rel[1] = False
            scores[2] = np.where(np.arange(n) % 2 == 0, np.float32(0.0), np.float32(-0.0))
        return _co_sort_rows(_sortable_key(torch.from_numpy(scores).to(dev)),
                             _payload(torch.from_numpy(rel.astype(np.float32)).to(dev), None))

    rng = np.random.default_rng(SEED)
    for n in EDGE_SIZES:
        yield f"n={n}", one(np.round(rng.standard_normal(n), 1).astype(np.float32), rng.random(n) < 0.5), None
    yield "one tie group", one(np.zeros(40_000, np.float32), rng.random(40_000) < 0.5), None
    yield "signed zeros", one(np.array([0.0, -0.0] * 20_000, np.float32), rng.random(40_000) < 0.5), None
    scores = np.round(rng.random(TIE_HEAVY_N), 2).astype(np.float32)
    rel = rng.random(TIE_HEAVY_N) < scores
    yield "tie-heavy 1M", one(scores, rel), None
    mask = rng.random(TIE_HEAVY_N) < 0.7
    yield "masked 1M", one(np.where(mask, scores, np.float32(1e30)).astype(np.float32), rel, mask), None
    yield "offsets 1M", one(scores, rel), (1234.0, 777.0)
    yield "20M", one(np.round(rng.random(BIG_N), 3).astype(np.float32), rng.random(BIG_N) < 0.9), None
    for rows, n in ROW_SHAPES + (CHUNKED_ROWS,):
        yield f"rows {rows}x{n}", list(rows_of(rows, n, rng)), None
    rng_w = np.random.default_rng(SEED + 1)
    for n in EDGE_SIZES:
        yield f"weighted n={n}", one(np.round(rng_w.standard_normal(n), 1).astype(np.float32), rng_w.random(n) < 0.5,
                                     None, rng_w.lognormal(size=n)), None
    cr_preds = rng_w.random(CRITEO_N, dtype=np.float32)
    cr_rel = rng_w.random(CRITEO_N) < cr_preds
    yield f"weighted {CRITEO_N}", one(cr_preds, cr_rel, None, rng_w.lognormal(size=CRITEO_N)), None
    del cr_preds, cr_rel
    for rows, n in ROW_SHAPES:
        key_s, pay_s = rows_of(rows, n, rng_w)
        weights = torch.from_numpy(rng_w.lognormal(size=(rows, n)).astype(np.float32)).to(dev)
        yield f"weighted rows {rows}x{n}", [key_s, pay_s, weights], None


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, required=True, help="the other tie_scan.cu")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_tie_scan_compare: no CUDA device is available", file=sys.stderr)
        return 1
    from metrics_tpu_torch.ops import _native

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    this = _bind(torch, _native.build(["tie_scan"])["tie_scan"])
    other = _bind(torch, _build_other(args.against.resolve()))
    # the paths' shapes, timed after the bits are compared
    timed = {"tie-heavy 1M": 50, "20M": 20, "rows 1000x50000": 20, f"weighted {CRITEO_N}": 10,
             "weighted rows 1000x50000": 20}
    kept, equal = {}, {}
    for label, streams, offsets in _inputs(torch, dev):
        key_s, pay_s, *w = streams
        w_s = w[0] if w else None
        got = this(key_s, pay_s, offsets or (0.0, 0.0), w_s)
        want = other(key_s, pay_s, offsets or (0.0, 0.0), w_s)
        torch.cuda.synchronize()
        equal[label] = bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))
        if not equal[label]:
            r = int((got != want).any(1).nonzero().flatten()[0]) if (got != want).any() else 0
            print(f"{label}: row {r} {got[r].tolist()} != other {want[r].tolist()}")
        if label in timed:
            kept[label] = (key_s, pay_s, w_s)
    times = {}
    for label, launches in timed.items():
        key_s, pay_s, w_s = kept[label]
        runs = {"other": [], "this": []}
        for which in ("other", "this", "this", "other"):
            fn = this if which == "this" else other
            runs[which].append(_queued_ms(torch, lambda: fn(key_s, pay_s, (0.0, 0.0), w_s), launches=launches,
                                          trials=5))
        times[label] = runs
    print(json.dumps({"card": card, "against": str(args.against), "bit_equal": equal, "ms": times}))
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
