"""Time forms of ``label_bincount`` on one CUDA card at the stat-score family's shapes.

Run from the root of a checkout, on a machine with a CUDA device::

    python3 scripts/torch_label_bincount_compare.py

Every form counts labels into a buffer of known length without reading
anything back to the host; each must equal ``torch.bincount`` bit for bit.
The forms:

* ``index_add_int64``: one ``index_add_`` of ones into an int64 buffer;
* ``index_add_int32``: the same into an int32 buffer, cast to int64;
* ``spread_S``: the same, each position adding into one of ``S`` copies of
  the buffer (position mod ``S``), the copies summed after: ``S`` times
  fewer atomic adds contend for one address.

Shapes: the Cityscapes val cells of one 4-image batch (8,388,608 labels in
19, 76 and 361 buckets, the largest class a third of the pixels), the
ImageNet val per-batch counts (5,000 labels and 25,000 top-5 labels in
1,000 buckets; 5,000 in 1,000,000 confusion cells) and the forward leg's
100,000 labels in 4 buckets. ``torch.bincount`` (which reads the input's
min and max to the host) is timed beside them with the host clock. Prints
the card's name and power limit and one JSON line of milliseconds.
"""
import json
import subprocess
import sys
import time

import numpy as np


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_label_bincount_compare: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    def queued_ms(fn, launches=20, trials=5):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(trials):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(50_000_000)
            start.record()
            for _ in range(launches):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / launches)
        return float(np.median(times))

    def host_ms(fn, trials=7):
        fn()
        times = []
        for _ in range(trials):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))

    def index_add(idx, length, dtype):
        counts = torch.zeros(length + 1, dtype=dtype, device=idx.device)
        return counts.index_add_(0, idx, torch.ones_like(idx, dtype=dtype))[:length].to(torch.int64)

    def spread(idx, length, copies, dtype):
        lane = torch.arange(idx.numel(), device=idx.device) % copies
        counts = torch.zeros(copies * (length + 1), dtype=dtype, device=idx.device)
        counts.index_add_(0, lane * (length + 1) + idx, torch.ones_like(idx, dtype=dtype))
        return counts.view(copies, length + 1).sum(0)[:length].to(torch.int64)

    forms = {
        "index_add_int64": lambda idx, n: index_add(idx, n, torch.int64),
        "index_add_int32": lambda idx, n: index_add(idx, n, torch.int32),
        **{f"spread_{s}_int32": (lambda s: lambda idx, n: spread(idx, n, s, torch.int32))(s) for s in (32, 128, 512)},
        "spread_128_int64": lambda idx, n: spread(idx, n, 128, torch.int64),
    }

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shares = np.concatenate([[1 / 3], (2 / 3) * 0.62 ** np.arange(18) / np.sum(0.62 ** np.arange(18))])
    cdf = torch.from_numpy(np.cumsum(shares)).to(dev, torch.float32)
    pixels = 4 * 1024 * 2048
    target = torch.searchsorted(cdf, torch.rand(pixels, generator=gen, device=dev)).clamp_(max=18)
    hit = torch.rand(pixels, generator=gen, device=dev) < 0.85
    pred = torch.where(hit, target, torch.randint(0, 19, (pixels,), generator=gen, device=dev))
    sample = torch.arange(pixels, device=dev) // (pixels // 4)
    shapes = {
        "cityscapes_cells_8388608_in_361": (target * 19 + pred, 361),
        "cityscapes_support_8388608_in_19": (target, 19),
        "cityscapes_samplewise_8388608_in_76": (sample * 19 + target, 76),
        "imagenet_5000_in_1000": (torch.randint(0, 1000, (5000,), generator=gen, device=dev), 1000),
        "imagenet_top5_25000_in_1000": (torch.randint(0, 1000, (25000,), generator=gen, device=dev), 1000),
        "imagenet_cells_5000_in_1000000": (torch.randint(0, 10**6, (5000,), generator=gen, device=dev), 10**6),
        "forward_leg_100000_in_4": (torch.randint(0, 4, (100_000,), generator=gen, device=dev), 4),
    }
    card = _card()
    print(card)
    results = {}
    for name, (idx, length) in shapes.items():
        want = torch.bincount(idx, minlength=length)
        row = {"torch_bincount_host_ms": host_ms(lambda: torch.bincount(idx, minlength=length))}
        for form, fn in forms.items():
            if form.startswith("spread") and length > 4096:
                continue  # copies of a large buffer cost more to clear and sum than contention costs
            if not torch.equal(fn(idx, length), want):
                raise AssertionError(f"{form} differs from torch.bincount at {name}")
            row[form] = queued_ms(lambda: fn(idx, length))
        results[name] = row
        print(name, {k: round(v, 4) for k, v in row.items()})
    print(json.dumps({"label_bincount_forms_ms": results, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
