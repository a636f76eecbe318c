"""Drive the PyTorch/CUDA port (``metrics_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA device::

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. build every CUDA kernel of ``metrics_tpu_torch/csrc`` with ``nvcc``, all
   sources at once;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it and at the hazards (block edges, one tie
   group, masking, bucket offsets, a positive class above 2^24), and the
   1M-element AUROC/AP against float64 numpy oracles;
3. the main path: ``MetricCollection([Accuracy(), AUROC(pos_label=1)])`` on
   ``cuda``, 10 forward batches of 100,000 seeded predictions, then
   ``compute()``, checked against numpy, with the kernel's launch count;
4. times on the card: the kernel, its plain version and both co-sort forms
   at 1M (CUDA events over launches queued behind a device sleep, so host
   overhead does not show), a forward batch and the whole compute step (host
   clock ending in a synchronize).

Prints the card's name and power limit (``nvidia-smi``), a ``{"timings":
...}`` line, a ``{"kernels": [...]}`` line and, last, ``{"ok": true,
"device": {...}}``. Exits with 1 and prints no result when no CUDA device
is available.
"""
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
BATCHES = 10
BATCH = 100_000
MAIN_N = BATCHES * BATCH
TIE_HEAVY_N = 1_000_003
BIG_N = 20_000_000  # with 90% positives the positive class exceeds 2^24
EDGE_SIZES = (1, 7, 32767, 32768, 32769, BATCH)

# H100 SXM data sheet: HBM bandwidth and the float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# kernel vs plain version: exact counts; the two sum the same f32 terms in
# f64 in other orders (and nvcc may contract to FMA), so the normalized
# AUROC and AP agree to well below one f32 ulp of 1
SCORE_TOL = 1e-6
# against the float64 numpy oracles: f32 scores and f32 terms
ORACLE_TOL = 1e-5


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _oracle_auroc(scores: np.ndarray, rel: np.ndarray) -> float:
    """Tie-corrected Mann-Whitney AUROC in float64."""
    s = scores.astype(np.float64)
    neg = np.sort(s[~rel])
    pos = s[rel]
    lo = np.searchsorted(neg, pos, side="left")
    hi = np.searchsorted(neg, pos, side="right")
    return (float(lo.sum()) + 0.5 * float((hi - lo).sum())) / (float(pos.size) * float(neg.size))


def _oracle_ap(scores: np.ndarray, rel: np.ndarray) -> float:
    """Tie-corrected average precision in float64 (one point per distinct score)."""
    s = scores.astype(np.float64)
    order = np.argsort(-s, kind="stable")
    s, r = s[order], rel[order]
    last = np.r_[s[1:] != s[:-1], True]
    tp = np.cumsum(r)[last].astype(np.float64)
    fp = np.cumsum(~r)[last].astype(np.float64)
    prev = np.r_[0.0, tp[:-1]]
    return float(np.sum((tp - prev) * (tp / (tp + fp))) / tp[-1])


def _queued_ms(torch, fn, launches: int = 50, trials: int = 7) -> float:
    """Device time of one call: ``launches`` calls queued behind a device
    sleep (so they run back to back), timed with CUDA events; median of
    ``trials``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def _host_ms(torch, fn, trials: int = 5) -> float:
    times = []
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from metrics_tpu_torch import AUROC, Accuracy, MetricCollection
    from metrics_tpu_torch.ops import _native, tie_scan
    from metrics_tpu_torch.ops.auroc_kernel import (
        _co_sort,
        _payload,
        _sortable_key,
        binary_auroc,
        binary_average_precision,
        masked_binary_auroc,
    )

    dev = torch.device("cuda")
    card = _card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    built = _native.build()
    print(f"build: {sorted(built)} in {time.perf_counter() - t0:.2f} s")

    # ---- 2. each kernel against its plain version ------------------------
    rng = np.random.default_rng(SEED)
    max_err = 0.0

    def hold(label, scores, rel, mask=None, offsets=None):
        nonlocal max_err
        preds = torch.from_numpy(scores).to(dev)
        rel_t = torch.from_numpy(rel.astype(np.float32)).to(dev)
        w = None if mask is None else torch.from_numpy(mask.astype(np.float32)).to(dev)
        key_s, pay_s = _co_sort(preds, rel_t, w)
        want = tie_scan.tie_group_reduce_reference(key_s, pay_s, offsets)
        got = tie_scan.tie_group_reduce(key_s, pay_s, offsets)
        torch.cuda.synchronize()
        g, w = got.tolist(), want.tolist()
        if g[2:] != w[2:]:
            raise AssertionError(f"{label}: counts {g[2:]} != plain {w[2:]}")
        err = [abs(g[i] - w[i]) / max(1.0, abs(w[i])) for i in (0, 1)]
        if max(err) > SCORE_TOL:
            raise AssertionError(f"{label}: area/ap {g[:2]} vs plain {w[:2]} (rel err {err})")
        ga, gp = (float(x) for x in tie_scan.auroc_ap_from_stats(got))
        wa, wp = (float(x) for x in tie_scan.auroc_ap_from_stats(want))
        for a, b in ((ga, wa), (gp, wp)):
            if np.isnan(a) != np.isnan(b) or (not np.isnan(a) and abs(a - b) > SCORE_TOL):
                raise AssertionError(f"{label}: scores ({ga}, {gp}) vs plain ({wa}, {wp})")
            if not np.isnan(a):
                max_err = max(max_err, abs(a - b))
        return want

    for n in EDGE_SIZES:
        hold(f"n={n}", np.round(rng.standard_normal(n), 1).astype(np.float32), rng.random(n) < 0.5)
    hold("one tie group", np.zeros(40_000, np.float32), rng.random(40_000) < 0.5)
    hold("signed zeros", np.array([0.0, -0.0] * 20_000, np.float32), rng.random(40_000) < 0.5)
    scores = np.round(rng.random(TIE_HEAVY_N), 2).astype(np.float32)
    rel = rng.random(TIE_HEAVY_N) < scores
    hold("tie-heavy 1M", scores, rel)
    mask = rng.random(TIE_HEAVY_N) < 0.7
    garbage = np.where(mask, scores, np.float32(1e30)).astype(np.float32)
    hold("masked 1M", garbage, rel, mask)
    hold("offsets 1M", scores, rel, offsets=(1234.0, 777.0))
    big_scores = np.round(rng.random(BIG_N), 3).astype(np.float32)
    big = hold("20M", big_scores, rng.random(BIG_N) < 0.9)
    if not big[2].item() > 2**24:
        raise AssertionError(f"20M stream: positive count {big[2].item()} does not exceed 2^24")
    del big_scores
    # masked elements are inert, whatever their scores
    m_t = torch.from_numpy(mask).to(dev)
    r_t = torch.from_numpy(rel.astype(np.int64)).to(dev)
    a1 = float(masked_binary_auroc(torch.from_numpy(garbage).to(dev), r_t, m_t))
    a2 = float(masked_binary_auroc(torch.from_numpy(scores).to(dev), r_t, m_t))
    # the masked-off elements move the valid ones across tiles, which only
    # reorders the sum of the same terms
    if abs(a1 - a2) > SCORE_TOL:
        raise AssertionError(f"masked AUROC moved with masked-off scores: {a1} != {a2}")
    # the 1M-element scores against float64 oracles
    s_t = torch.from_numpy(scores).to(dev)
    auroc_1m = float(binary_auroc(s_t, r_t))
    ap_1m = float(binary_average_precision(s_t, r_t))
    oracle_auroc, oracle_ap = _oracle_auroc(scores, rel), _oracle_ap(scores, rel)
    if abs(auroc_1m - oracle_auroc) > ORACLE_TOL or abs(ap_1m - oracle_ap) > ORACLE_TOL:
        raise AssertionError(f"1M: AUROC {auroc_1m} / AP {ap_1m} vs oracle {oracle_auroc} / {oracle_ap}")
    torch.cuda.synchronize()
    print(f"kernel vs plain: ok, max |d score| {max_err:.3g}; 1M AUROC {auroc_1m:.7f} (oracle {oracle_auroc:.7f}),"
          f" AP {ap_1m:.7f} (oracle {oracle_ap:.7f})")

    # ---- 3. the main path -----------------------------------------------
    preds_np = rng.random(MAIN_N, dtype=np.float32)
    target_np = (rng.random(MAIN_N) < preds_np).astype(np.int64)
    preds = torch.from_numpy(preds_np).to(dev)
    target = torch.from_numpy(target_np).to(dev)
    collection = MetricCollection([Accuracy(), AUROC(pos_label=1)])
    torch.cuda.synchronize()
    tie_scan.tie_group_reduce.launches = 0
    t0 = time.perf_counter()
    for b in range(BATCHES):
        step = collection(preds[b * BATCH:(b + 1) * BATCH], target[b * BATCH:(b + 1) * BATCH])
    t_forward = time.perf_counter() - t0
    result = collection.compute()
    torch.cuda.synchronize()
    main_path_s = time.perf_counter() - t0
    launches = tie_scan.tie_group_reduce.launches
    if launches == 0:
        raise AssertionError("the main path never launched the tie_scan kernel")
    values = {k: v.item() for k, v in result.items()}
    for k, v in list(values.items()) + [(k, v.item()) for k, v in step.items()]:
        if not np.isfinite(v):
            raise AssertionError(f"main path: {k} = {v} is not finite")
    rel_np = target_np.astype(bool)
    want_acc = float(np.float32(np.sum((preds_np >= 0.5) == rel_np)) / np.float32(MAIN_N))
    want_auroc = _oracle_auroc(preds_np, rel_np)
    if values["Accuracy"] != want_acc:
        raise AssertionError(f"main path: Accuracy {values['Accuracy']} != numpy {want_acc}")
    if abs(values["AUROC"] - want_auroc) > ORACLE_TOL:
        raise AssertionError(f"main path: AUROC {values['AUROC']} vs oracle {want_auroc}")
    print(f"main path: {values} (numpy: Accuracy {want_acc}, AUROC {want_auroc:.7f}),"
          f" tie_scan launches {launches}, {main_path_s:.3f} s including first calls")

    # ---- 4. times --------------------------------------------------------
    all_preds = torch.cat(list(collection["AUROC"].preds))
    all_rel = (torch.cat(list(collection["AUROC"].target)) == 1).to(torch.float32)
    key = _sortable_key(all_preds)
    payload = _payload(all_rel, None)
    key_s, pay_s = _co_sort(all_preds, all_rel)
    groups = int((key_s[1:] != key_s[:-1]).sum()) + 1
    kernel_ms = _queued_ms(torch, lambda: tie_scan.tie_group_reduce(key_s, pay_s))
    plain_ms = _queued_ms(torch, lambda: tie_scan.tie_group_reduce_reference(key_s, pay_s))
    sort_gather_ms = _queued_ms(torch, lambda: payload[torch.sort(key)[1]])
    sort_packed_ms = _queued_ms(torch, lambda: torch.sort((key.long() << 2) | payload.long()).values)

    collection.persistent(True)
    saved = collection.state_dict()

    def compute_fresh():
        # a collection restored from the saved states, so compute() has no cached value
        fresh = MetricCollection([Accuracy(), AUROC(pos_label=1)])
        fresh.load_state_dict(saved, strict=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fresh.compute()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    compute_fresh()
    compute_ms = float(np.median([compute_fresh() for _ in range(5)]))
    forward_ms = _host_ms(torch, lambda: collection(preds[:BATCH], target[:BATCH]))
    n = key_s.numel()
    bytes_moved = n * (key_s.element_size() + pay_s.element_size()) + 4 * 4
    ops = 5 * n + 10 * groups  # compare/decode/prefix per element, the f32 terms per group start
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    timings = {
        "n": n,
        "tie_groups": groups,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "co_sort_int32_sort_gather_ms": sort_gather_ms,
        "co_sort_packed_int64_ms": sort_packed_ms,
        "forward_batch_ms": forward_ms,
        "compute_step_ms": compute_ms,
        "forward_10_batches_first_run_s": t_forward,
        "kernel_bytes": bytes_moved,
        "bytes_bound_ms": bytes_ms,
        "ops_bound_ms": ops_ms,
        "card": card,
    }
    print(json.dumps({"timings": timings}))

    # ---- 5. where the time goes: one forward batch + compute, profiled ----
    from torch.profiler import ProfilerActivity, profile

    fresh = MetricCollection([Accuracy(), AUROC(pos_label=1)])
    fresh.load_state_dict(saved, strict=True)
    fresh(preds[:BATCH], target[:BATCH])  # first-call costs stay out of the window
    fresh.load_state_dict(saved, strict=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fresh(preds[:BATCH], target[:BATCH])
        fresh.compute()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t) * 1e3
    averages = prof.key_averages()
    sort_key = "self_device_time_total" if hasattr(averages[0], "self_device_time_total") else "self_cuda_time_total"
    device_ms = sum(
        getattr(e, sort_key) for e in averages if e.device_type == torch.autograd.DeviceType.CUDA
    ) / 1e3
    print(averages.table(sort_by=sort_key, row_limit=15, max_name_column_width=48))
    print(averages.table(sort_by="self_cpu_time_total", row_limit=15, max_name_column_width=48))
    # the plain version at 1M, by ATen kernel
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_plain:
        tie_scan.tie_group_reduce_reference(key_s, pay_s)
        torch.cuda.synchronize()
    print(prof_plain.key_averages().table(sort_by=sort_key, row_limit=10, max_name_column_width=48))
    print(json.dumps({"profile": {
        "window": "one forward batch of 100k + compute at 1.1M, under torch.profiler",
        "window_ms": window_ms,
        "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / window_ms,
    }}))
    kernels = [
        {
            "name": "tie_scan",
            "route": "cuda",
            "source": "metrics_tpu_torch/csrc/tie_scan.cu",
            "replaces": "metrics_tpu/ops/tie_scan_pallas.py:80",
            "launches": launches,
            "max_abs_err": max_err,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        }
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
