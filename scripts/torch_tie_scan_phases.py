"""Where a tile of the weighted tie-scan kernel spends its time, on one GPU.

Builds a copy of ``metrics_tpu_torch/csrc/tie_scan.cu`` with clock stamps
at the phase boundaries of ``tie_scan_w_kernel`` (into ``build/``, with
``nvcc``), runs it once at the two shapes the sharded paths give it
(45,840,617 elements as one row, and (1000, 50000)) and prints, per phase,
the median and 90th percentile of SM cycles over the tiles, the wall time of
the launch, and how far each tile looked back (the distance to the nearest
inclusive carry it folded from, and the polls it took). Run from the root
of a checkout on a machine with a CUDA device::

    python3 scripts/torch_tie_scan_phases.py

The stamps cost a little time, so the wall time runs above the kernel's
time in ``chip_smoke.py``. The phase boundaries are found by the source
lines they follow; when the kernel changes, update ``_STAMPS``.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = ["ticket + load start", "wait for the tile", "decode", "local scans", "publish + look-back",
          "emit + partial", "row's closing"]
SLOTS = 16  # per tile: 8 clocks, start and end time, SM, block, look-back distance and polls

# (source line, what to put before or after it); a stamp k records phase k's start
_STAMPS = [
    ("  const long long g = s_tile;\n", "  const long long g = s_tile;\n  stamp(g, 0);\n"),
    ("  // the key before the tile, for its first element", "  stamp(g, 1);\n  // the key before the tile, for its first element"),
    ("  mbar_wait(&s_bar);\n  __syncthreads();\n", "  mbar_wait(&s_bar);\n  __syncthreads();\n  stamp(g, 2);\n"),
    ("  // ---- local reduction", "  stamp(g, 3);\n  // ---- local reduction"),
    ("  const WSummary ex = block_scan_runs(own, s_warp, &agg);  // ends in __syncthreads\n",
     "  const WSummary ex = block_scan_runs(own, s_warp, &agg);\n  stamp(g, 4);\n"),
    ("  const WCarry carry = s_carry;\n", "  const WCarry carry = s_carry;\n  stamp(g, 5);\n"),
    ("  if (t != tiles_per_row - 1) return;\n", "  stamp(g, 6);\n  if (t != tiles_per_row - 1) { stamp(g, 7); return; }\n"),
    ("    o[3] = (float)inc.base.y;\n  }\n}\n", "    o[3] = (float)inc.base.y;\n  }\n  stamp(g, 7);\n}\n"),
    ("__device__ WCarry look_back(WTileState* state, long long t, WSummary* s_window) {",
     "__device__ WCarry look_back(WTileState* state, long long t, WSummary* s_window, long long g) {\n  unsigned polls = 0;"),
    ("    bool waiting = false;\n", "    ++polls;\n    bool waiting = false;\n"),
    ("  __syncwarp();\n  // the left fold",
     "  if (g_stamps && lane == 0) { g_stamps[g * 16 + 12] = k; g_stamps[g * 16 + 13] = polls; }\n"
     "  __syncwarp();\n  // the left fold"),
    ("      carry = look_back(row_state, t, reinterpret_cast<WSummary*>(s_words));",
     "      carry = look_back(row_state, t, reinterpret_cast<WSummary*>(s_words), g);"),
]

_STAMP_FN = """namespace {
__device__ unsigned long long* g_stamps = nullptr;
__device__ __forceinline__ void stamp(long long g, int k) {
  if (g_stamps && threadIdx.x == 0) {
    unsigned long long now, sm;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(now));
    asm volatile("{ .reg .u32 s; mov.u32 s, %smid; cvt.u64.u32 %0, s; }" : "=l"(sm));
    g_stamps[g * 16 + k] = (unsigned long long)clock64();
    if (k == 0) { g_stamps[g * 16 + 8] = now; g_stamps[g * 16 + 10] = sm; g_stamps[g * 16 + 11] = blockIdx.x; }
    if (k == 7) g_stamps[g * 16 + 9] = now;
  }
}
"""


def _build() -> Path:
    src = (ROOT / "metrics_tpu_torch/csrc/tie_scan.cu").read_text()
    src = src.replace("namespace {\n", _STAMP_FN, 1)
    for anchor, replacement in _STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"the kernel source no longer has this line once: {anchor!r}")
        src = src.replace(anchor, replacement)
    src = src.replace('extern "C" {\n', 'extern "C" {\nint set_stamps(void* p) '
                      '{ return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)); }\n', 1)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    (build / "tie_scan_phases.cu").write_text(src)
    lib = build / "libtie_scan_phases.so"
    subprocess.run(["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(build / "tie_scan_phases.cu")], check=True)
    return lib


def _report(label, stamps, tiles):
    a = stamps.view(tiles, SLOTS).cpu().numpy().astype(np.int64)
    cycles = np.diff(a[:, :8], axis=1)
    print(f"{label}: {tiles} tiles, launch wall {(a[:, 9].max() - a[:, 8].min()) / 1e3:.1f} us on"
          f" {len(np.unique(a[:, 10]))} SMs")
    for i, name in enumerate(PHASES):
        print(f"  {name:20s} cycles median {np.median(cycles[:, i]):8.0f}  p90 {np.percentile(cycles[:, i], 90):8.0f}")
    total = a[:, 7] - a[:, 0]
    print(f"  {'tile':20s} cycles median {np.median(total):8.0f}")
    back = a[:, 12][a[:, 13] > 0]
    polls = a[:, 13][a[:, 13] > 0]
    if back.size:
        print(f"  look-back distance median {np.median(back):.0f} p90 {np.percentile(back, 90):.0f},"
              f" polls median {np.median(polls):.0f} p90 {np.percentile(polls, 90):.0f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_tie_scan_phases: no CUDA device is available", file=sys.stderr)
        return 1
    from metrics_tpu_torch.ops.auroc_kernel import _co_sort, _co_sort_rows, _payload, _sortable_key

    lib = ctypes.CDLL(str(_build()))
    ptr, size, off = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    lib.tie_scan_rows_w.argtypes = [ctypes.c_int, ptr, ptr, ptr, size, size, off, off, ptr, ptr, ptr]
    lib.tie_scan_rows_w.restype = ctypes.c_int
    lib.tie_scan_w_scratch_bytes.argtypes = [size, size]
    lib.tie_scan_w_scratch_bytes.restype = size
    lib.set_stamps.argtypes = [ptr]
    tile = lib.tie_scan_tile_elems()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(torch.cuda.get_device_name(0))

    def run(label, key_s, pay_s, w_s):
        rows, n = key_s.shape
        tiles = rows * max(1, -(-n // tile))
        stamps = torch.zeros(tiles * SLOTS, dtype=torch.int64, device=dev)
        scratch = torch.empty(lib.tie_scan_w_scratch_bytes(rows, n), dtype=torch.uint8, device=dev)
        out = torch.empty(rows, 4, device=dev)

        def call():
            err = lib.tie_scan_rows_w(dev.index or 0, key_s.data_ptr(), pay_s.data_ptr(), w_s.data_ptr(), rows, n,
                                      0.0, 0.0, scratch.data_ptr(), out.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")

        lib.set_stamps(None)
        call()
        call()
        lib.set_stamps(stamps.data_ptr())
        torch.cuda._sleep(20_000_000)  # the stamped launch starts with the card idle
        call()
        torch.cuda.synchronize()
        lib.set_stamps(None)
        _report(label, stamps, tiles)

    n = 45_840_617
    scores = torch.rand(n, device=dev, generator=gen)
    rel = (torch.rand(n, device=dev, generator=gen) < scores).float()
    weights = torch.empty(n, device=dev).log_normal_(generator=gen)
    key_s, pay_s, w_s = _co_sort(scores, rel, None, weights)
    run("45,840,617 as one row", key_s[None], pay_s[None], w_s[None])
    del scores, rel, weights, key_s, pay_s, w_s
    scores = torch.rand(1000, 50_000, device=dev, generator=gen)
    rel = (torch.rand(1000, 50_000, device=dev, generator=gen) < 0.001).float()
    weights = torch.empty(1000, 50_000, device=dev).log_normal_(generator=gen)
    run("(1000, 50000)", *_co_sort_rows(_sortable_key(scores), _payload(rel, None), weights))
    return 0


if __name__ == "__main__":
    sys.exit(main())
