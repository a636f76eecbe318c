"""Where a tile of the tie-scan kernels spends its time, on one GPU.

Builds a copy of ``metrics_tpu_torch/csrc/tie_scan.cu`` whose phase marks
(``TIE_SCAN_PHASE``, ``TIE_SCAN_LOOK_BACK``, empty in the package's build)
record clock stamps (into ``build/``, with ``nvcc``), runs it once at the
shapes the paths give it and prints, per phase, the median and 90th
percentile of SM cycles over the tiles, the wall time of the launch, and how
far each tile looked back (the distance to the nearest predecessor with an
inclusive carry, 0 for the tile just before, and how many times it waited on
a predecessor). Unweighted (``tie_scan_kernel``): 1M and 20M elements as one
row, and (1000, 50000); weighted (``tie_scan_w_kernel``): 45,840,617 as one
row, and (1000, 50000). Run from the root of a checkout on a machine with a
CUDA device::

    python3 scripts/torch_tie_scan_phases.py

The stamps cost a little time, so the wall time runs above the kernel's
time in ``chip_smoke.py``.
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
# per block: 8 clocks (the phases' starts and the end), start and end time,
# SM, look-back distance + 1 (0: no look-back) and waits
SLOTS = 16

_MARKS = """#include <cuda_runtime.h>
__device__ unsigned long long* g_stamps = nullptr;
__device__ __forceinline__ void stamp(int k) {
  if (g_stamps && threadIdx.x == 0) {
    unsigned long long* s = g_stamps + 16ull * blockIdx.x;
    s[k] = (unsigned long long)clock64();
    if (k == 0 || k == 7) {
      unsigned long long now;
      asm volatile("mov.u64 %0, %globaltimer;" : "=l"(now));
      s[k == 0 ? 8 : 9] = now;
    }
    if (k == 0) {
      unsigned long long sm;
      asm volatile("{ .reg .u32 s; mov.u32 s, %smid; cvt.u64.u32 %0, s; }" : "=l"(sm));
      s[10] = sm;
    }
  }
}
__device__ __forceinline__ void mark_look_back(long long distance, unsigned waits) {
  if (g_stamps && threadIdx.x == 0) {
    g_stamps[16ull * blockIdx.x + 12] = distance + 1;
    g_stamps[16ull * blockIdx.x + 13] = waits;
  }
}
#define TIE_SCAN_PHASE(k) stamp(k)
#define TIE_SCAN_LOOK_BACK(distance, waits) mark_look_back(distance, waits)
"""
_SET_STAMPS = """
extern "C" int set_stamps(void* p) { return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)); }
"""


def _build() -> Path:
    from metrics_tpu_torch.ops import _native

    src = (ROOT / "metrics_tpu_torch/csrc/tie_scan.cu").read_text()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    (build / "tie_scan_phases.cu").write_text(_MARKS + src + _SET_STAMPS)
    lib = build / "libtie_scan_phases.so"
    subprocess.run([_native._nvcc(), *_native._NVCC_FLAGS, "-o", str(lib), str(build / "tie_scan_phases.cu")],
                   check=True)
    return lib


def _phases(stamps, tiles) -> dict:
    a = stamps.view(tiles, SLOTS).cpu().numpy().astype(np.int64)
    cycles = np.diff(a[:, :8], axis=1)
    row = {name: (np.median(cycles[:, i]), np.percentile(cycles[:, i], 90)) for i, name in enumerate(PHASES)}
    total = a[:, 7] - a[:, 0]
    row["whole tile"] = (np.median(total), np.percentile(total, 90))
    looked = a[:, 12] > 0
    if looked.any():
        row["look-back distance"] = (np.median(a[looked, 12] - 1), np.percentile(a[looked, 12] - 1, 90))
        row["look-back waits"] = (np.median(a[looked, 13]), np.percentile(a[looked, 13], 90))
    row["tiles"] = (tiles,)
    row["launch wall us"] = ((a[:, 9].max() - a[:, 8].min()) / 1e3,)
    row["SMs"] = (len(np.unique(a[:, 10])),)
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_tie_scan_phases: no CUDA device is available", file=sys.stderr)
        return 1
    from metrics_tpu_torch.ops.auroc_kernel import _co_sort, _co_sort_rows, _payload, _sortable_key

    lib = ctypes.CDLL(str(_build()))
    ptr, size, off = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    lib.tie_scan_rows.argtypes = [ctypes.c_int, ptr, ptr, size, size, off, off, ptr, ptr, ptr]
    lib.tie_scan_rows_w.argtypes = [ctypes.c_int, ptr, ptr, ptr, size, size, off, off, ptr, ptr, ptr]
    lib.tie_scan_scratch_bytes.argtypes = [size, size, ctypes.c_int]
    lib.tie_scan_scratch_bytes.restype = size
    lib.tie_scan_tile_elems.argtypes = []
    lib.set_stamps.argtypes = [ptr]
    for fn in (lib.tie_scan_rows, lib.tie_scan_rows_w, lib.tie_scan_tile_elems, lib.set_stamps):
        fn.restype = ctypes.c_int
    tile = lib.tie_scan_tile_elems()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)

    def run(key_s, pay_s, w_s=None) -> dict:
        rows, n = key_s.shape
        tiles = rows * max(1, -(-n // tile))
        stamps = torch.zeros(tiles * SLOTS, dtype=torch.int64, device=dev)
        scratch = torch.empty(lib.tie_scan_scratch_bytes(rows, n, w_s is not None), dtype=torch.uint8, device=dev)
        out = torch.empty(rows, 4, device=dev)

        def call():
            streams = [key_s.data_ptr(), pay_s.data_ptr()] + ([] if w_s is None else [w_s.data_ptr()])
            entry = lib.tie_scan_rows if w_s is None else lib.tie_scan_rows_w
            err = entry(dev.index or 0, *streams, rows, n, 0.0, 0.0, scratch.data_ptr(), out.data_ptr(),
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
        return _phases(stamps, tiles)

    reports = {}
    for n in (1_000_000, 20_000_000):
        # uniform scores at 1M (few ties); at 20M the tie-heavy 90%-positive stream of chip_smoke.py
        scores = torch.rand(n, device=dev, generator=gen)
        if n > 1_000_000:
            scores = torch.round(scores, decimals=3)
            rel = (torch.rand(n, device=dev, generator=gen) < 0.9).float()
        else:
            rel = (torch.rand(n, device=dev, generator=gen) < scores).float()
        key_s, pay_s = _co_sort(scores, rel)
        reports[f"{n:,} one row"] = run(key_s[None], pay_s[None])
    rows_key = _sortable_key(torch.rand(1000, 50_000, device=dev, generator=gen))
    rows_payload = _payload((torch.rand(1000, 50_000, device=dev, generator=gen) < 0.001).float(), None)
    reports["(1000, 50000)"] = run(*_co_sort_rows(rows_key, rows_payload))
    n = 45_840_617
    scores = torch.rand(n, device=dev, generator=gen)
    rel = (torch.rand(n, device=dev, generator=gen) < scores).float()
    weights = torch.empty(n, device=dev).log_normal_(generator=gen)
    key_s, pay_s, w_s = _co_sort(scores, rel, None, weights)
    reports["weighted 45,840,617 one row"] = run(key_s[None], pay_s[None], w_s[None])
    del scores, rel, weights, key_s, pay_s, w_s
    weights = torch.empty(1000, 50_000, device=dev).log_normal_(generator=gen)
    reports["weighted (1000, 50000)"] = run(*_co_sort_rows(rows_key, rows_payload, weights))

    labels = list(reports)
    names = list(dict.fromkeys(name for r in reports.values() for name in r))
    print("SM cycles per tile, median / p90, " + card)
    print(f"| {'phase':22s} | " + " | ".join(f"{label:>27s}" for label in labels) + " |")
    for name in names:
        cells = []
        for label in labels:
            value = reports[label].get(name, (float("nan"), float("nan")))
            cells.append(f"{value[0]:>27.1f}" if len(value) == 1 else f"{value[0]:>13.0f} / {value[1]:>11.0f}")
        print(f"| {name:22s} | " + " | ".join(cells) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
