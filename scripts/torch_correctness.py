#!/usr/bin/env python
"""The port's accelerator correctness tier: one representative metric per
family on the card, held against float64 numpy/scipy oracles.

The CPU suite proves the port's arithmetic against the JAX package; this
tier proves it on the card, where sorts, reductions and the hand-written
``tie_scan`` kernel run. It keeps the JAX package's tier
(``tpu_correctness.py``): the same 32 checks, at the same sizes through the
same ``sz()`` scale, with the same tolerances, including its adversarial
AUROC/AP streams: signed zeros, ±inf scores, a tie storm longer than a
tile, permutation invariance, a single-class stream (NaN) and a positive
class past 2^24 (about 22M elements at scale 1). The oracles are its own
(the card's machine has no scikit-learn).

For every adversarial check (``adv_*``) every ``tie_scan`` launch is
recorded, and the launch's plain version (``ops/tie_scan.py``'s
``*_reference``) runs on the same sorted stream, on the same device; the
normalized AUROC and AP of both must agree within 1e-6 and their class
totals exactly. The sharded and sample-sort checks run at the world the
process has, and their lines say it.

Output, one line each::

    PLATFORM <device type> <device name>
    CHECK <name> <abs_err> <tol> <want_min> <want_max> <n> [world=<W>]
    ADV <check> <entry> auroc <kernel> <plain> ap <kernel> <plain> <abs_err>
    LAUNCHES {"tie_scan": ..., "tie_scan_w": ..., "tie_scan_rows": ..., "tie_scan_rows_w": ..., "offsets": ...}
    DONE

Exits 0 only when every check is within its tolerance and every adversarial
launch agrees with its plain version (on the card, every adversarial check
must launch the kernel). The card is the default and a missing one raises;
``--device cpu`` runs the same checks on the CPU, where the wrappers run the
plain versions and nothing launches. Usage::

    python3 scripts/torch_correctness.py [--device cuda] [--scale 1.0]
"""
import argparse
import contextlib
import json
import os
import sys
from typing import Callable, Dict, List

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ADV_TOL = 1e-6
ENTRIES = ("tie_scan", "tie_scan_w", "tie_scan_rows", "tie_scan_rows_w", "offsets")


# ---- float64 oracles (numpy / scipy) ----------------------------------------------


def _descending_key(p: np.ndarray) -> np.ndarray:
    """uint32 sort key of float32 scores, ascending key == descending score:
    the monotone map of the float's bits, ``-0.0`` folded onto ``+0.0`` and
    every NaN last (the JAX package's key, computed here on its own)."""
    bits = np.ascontiguousarray(p, dtype=np.float32).view(np.uint32).copy()
    bits[bits == 0x80000000] = 0
    ascending = np.where(bits >> 31 == 1, ~bits, bits | np.uint32(0x80000000))
    return np.where(np.isnan(p), np.uint32(0xFFFFFFFF), ~ascending).astype(np.uint32)


def _mw_stats(key: np.ndarray, rel: np.ndarray):
    rel = np.asarray(rel).astype(bool)
    kp, kn = np.sort(key[rel]), np.sort(key[~rel])
    return kp, kn, np.searchsorted(kn, kp, side="left"), np.searchsorted(kn, kp, side="right")


def host_mw_auroc(key: np.ndarray, rel: np.ndarray) -> float:
    """Tie-corrected AUROC of a keyed stream as the Mann-Whitney U statistic
    (float64; NaN for a single class)."""
    kp, kn, lo, hi = _mw_stats(key, rel)
    if kp.size == 0 or kn.size == 0:
        return float("nan")
    below = (kn.size - hi).astype(np.float64)
    tied = (hi - lo).astype(np.float64)
    return float((below.sum() + 0.5 * tied.sum()) / (float(kp.size) * kn.size))


def host_mw_average_precision(key: np.ndarray, rel: np.ndarray) -> float:
    """Tie-corrected AP over the distinct thresholds that hold a positive."""
    kp, kn, lo, hi = _mw_stats(key, rel)
    if kp.size == 0:
        return float("nan")
    is_last = np.append(kp[:-1] != kp[1:], True)
    tps = np.arange(1, kp.size + 1, dtype=np.float64)[is_last]
    fps = hi[is_last].astype(np.float64)
    prev = np.concatenate([[0.0], tps[:-1]])
    return float(np.sum((tps - prev) * tps / (tps + fps)) / kp.size)


def curve_points(target: np.ndarray, scores: np.ndarray, weights=None):
    """``(fps, tps, thresholds)`` at each distinct score, descending (the
    binary classifier curve of scikit-learn, float64 sums)."""
    scores = np.asarray(scores, np.float64)
    y = (np.asarray(target) == 1).astype(np.float64)
    w = np.ones_like(scores) if weights is None else np.asarray(weights, np.float64)
    order = np.argsort(-scores, kind="mergesort")
    scores, y, w = scores[order], y[order], w[order]
    last = np.r_[np.nonzero(np.diff(scores))[0], scores.size - 1]
    return np.cumsum((1 - y) * w)[last], np.cumsum(y * w)[last], scores[last]


def roc_curve(target, scores, weights=None):
    """``(fpr, tpr, thresholds)`` with every distinct threshold kept and the
    ``(0, 0)`` point first at threshold ``inf`` (``drop_intermediate=False``)."""
    fps, tps, thr = curve_points(target, scores, weights)
    fps, tps = np.r_[0.0, fps], np.r_[0.0, tps]
    return fps / fps[-1], tps / tps[-1], np.r_[np.inf, thr]


def roc_auc(target, scores, weights=None) -> float:
    """Binary ROC AUC: the Mann-Whitney statistic with tie groups (average
    ranks), or the trapezoid over the weighted curve's points."""
    target = np.asarray(target) == 1
    if weights is None:
        _, inv, cnt = np.unique(np.asarray(scores, np.float64), return_inverse=True, return_counts=True)
        ranks = (np.cumsum(cnt) - (cnt - 1) / 2.0)[inv]
        n_pos = float(target.sum())
        n_neg = target.size - n_pos
        return float((ranks[target].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
    fpr, tpr, _ = roc_curve(target, scores, weights)
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2))


def average_precision(target, scores, weights=None) -> float:
    """Σ (R_k − R_{k−1}) P_k over the distinct thresholds."""
    fps, tps, _ = curve_points(target, scores, weights)
    recall = tps / tps[-1]
    # a threshold that only zero weights reach has no precision; it adds no recall
    precision = np.divide(tps, tps + fps, out=np.zeros_like(tps), where=tps + fps > 0)
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def confusion_matrix(target, preds, num_classes: int) -> np.ndarray:
    idx = np.asarray(target, np.int64) * num_classes + np.asarray(preds, np.int64)
    return np.bincount(idx, minlength=num_classes * num_classes).reshape(num_classes, num_classes)


def f1_macro(target, preds) -> float:
    labels = np.union1d(target, preds)
    cm = confusion_matrix(target, preds, int(labels.max()) + 1)[np.ix_(labels, labels)].astype(np.float64)
    tp = np.diag(cm)
    denom = 2 * tp + (cm.sum(0) - tp) + (cm.sum(1) - tp)
    return float(np.mean(np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 0.0)))


def cohen_kappa_quadratic(target, preds) -> float:
    labels = np.union1d(target, preds)
    cm = confusion_matrix(target, preds, int(labels.max()) + 1)[np.ix_(labels, labels)].astype(np.float64)
    expected = np.outer(cm.sum(1), cm.sum(0)) / cm.sum()
    k = np.arange(labels.size)
    weight = (k[:, None] - k[None, :]) ** 2
    return float(1 - np.sum(weight * cm) / np.sum(weight * expected))


def r2_score(target, preds) -> float:
    t, p = np.asarray(target, np.float64), np.asarray(preds, np.float64)
    return float(1 - np.sum((t - p) ** 2) / np.sum((t - t.mean()) ** 2))


def oracle_map(indexes, preds, target) -> float:
    """Mean per-query average precision (queries with no positive skipped)."""
    scores = []
    for idx in np.unique(indexes):
        sel = indexes == idx
        if target[sel].sum() == 0:
            continue
        scores.append(average_precision(target[sel], preds[sel]))
    return float(np.mean(scores))


def oracle_ssim(preds, target, data_range: float) -> float:
    from scipy.signal import convolve2d

    preds = np.asarray(preds, np.float64)
    target = np.asarray(target, np.float64)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    dist = np.arange(-5, 6, dtype=np.float64)
    g = np.exp(-((dist / 1.5) ** 2) / 2)
    kernel = np.outer(g / g.sum(), g / g.sum())

    def filt(img):
        return convolve2d(np.pad(img, 5, mode="reflect"), kernel, mode="valid")

    vals = []
    for b in range(preds.shape[0]):
        for c in range(preds.shape[1]):
            p, t = preds[b, c], target[b, c]
            mu_p, mu_t = filt(p), filt(t)
            s_p = filt(p * p) - mu_p**2
            s_t = filt(t * t) - mu_t**2
            s_pt = filt(p * t) - mu_p * mu_t
            m = ((2 * mu_p * mu_t + c1) * (2 * s_pt + c2)) / ((mu_p**2 + mu_t**2 + c1) * (s_p + s_t + c2))
            vals.append(m[5:-5, 5:-5])
    return float(np.mean(vals))


# ---- the kernel's launches --------------------------------------------------------------


def launch_counts() -> Dict[str, int]:
    """Launches of each ``tie_scan`` entry since the counters were last zeroed."""
    from metrics_tpu_torch.ops import tie_scan

    one, rows = tie_scan.tie_group_reduce, tie_scan.tie_group_reduce_rows
    return {"tie_scan": one.launches, "tie_scan_w": one.weighted_launches, "tie_scan_rows": rows.launches,
            "tie_scan_rows_w": rows.weighted_launches, "offsets": one.offset_launches}


@contextlib.contextmanager
def scan_tap(records: List[dict]):
    """Record every ``tie_scan`` launch (a wrapper call on CUDA tensors) made
    through the exact AUROC/AP paths and the sample sort: its entry, its
    sorted streams and its output. The wrappers count as they always do."""
    from metrics_tpu_torch.ops import auroc_kernel, tie_scan
    from metrics_tpu_torch.parallel import sample_sort

    def tap(fn, rows: bool):
        def tapped(key_s, payload_s, offsets=None, weights_s=None):
            out = fn(key_s, payload_s, offsets, weights_s)
            if key_s.device.type == "cuda":
                entry = ("tie_scan_rows" if rows else "tie_scan") + ("_w" if weights_s is not None else "")
                records.append({"entry": entry + (" offsets" if offsets is not None else ""), "rows": rows,
                                "args": (key_s, payload_s, offsets, weights_s), "out": out})
            return out

        return tapped

    sites = [(auroc_kernel, "tie_group_reduce", False), (auroc_kernel, "tie_group_reduce_rows", True),
             (sample_sort, "tie_group_reduce", False)]
    saved = [(module, name, getattr(module, name)) for module, name, _ in sites]
    try:
        for module, name, rows in sites:
            setattr(module, name, tap(getattr(tie_scan, name), rows))
        yield records
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def kernel_against_plain(record: dict) -> dict:
    """The recorded launch's output against its plain version on the same
    streams and device: normalized AUROC and AP of each, and the largest
    difference (class totals must be equal, NaNs in the same places)."""
    from metrics_tpu_torch.ops import tie_scan

    plain_fn = tie_scan.tie_group_reduce_rows_reference if record["rows"] else tie_scan.tie_group_reduce_reference
    plain = plain_fn(*record["args"])
    kernel = record["out"]
    k_auroc, k_ap = (t.double().cpu().numpy().ravel() for t in tie_scan.auroc_ap_from_stats(kernel))
    p_auroc, p_ap = (t.double().cpu().numpy().ravel() for t in tie_scan.auroc_ap_from_stats(plain))
    got, want = np.r_[k_auroc, k_ap], np.r_[p_auroc, p_ap]
    nan_same = np.array_equal(np.isnan(got), np.isnan(want))
    totals_equal = torch.equal(kernel[..., 2:].cpu(), plain[..., 2:].cpu())
    err = float(np.max(np.abs(np.nan_to_num(got - want, nan=0.0)))) if got.size else 0.0
    ok = nan_same and totals_equal and err <= ADV_TOL
    return {"entry": record["entry"], "totals": kernel[..., 2:].tolist(), "kernel": (k_auroc.tolist(), k_ap.tolist()),
            "plain": (p_auroc.tolist(), p_ap.tolist()), "abs_err": err if nan_same and totals_equal else float("inf"),
            "ok": ok}


# ---- the tier ---------------------------------------------------------------------------


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def run_tier(device: torch.device, scale: float = 1.0, emit: Callable[[str], None] = print) -> dict:
    """Run every check on ``device``; returns ``{"ok", "checks": {name:
    {"abs_err", "tol", "ok"}}, "adversarial": {check: [kernel against
    plain, ...]}, "launches": {entry: n}, "world"}``. ``launches`` counts
    this call's launches only; the counters are left advanced by them."""
    import metrics_tpu_torch as M
    from metrics_tpu_torch.functional import embedding_similarity
    from metrics_tpu_torch.ops.auroc_kernel import (
        binary_auroc,
        binary_average_precision,
        masked_weighted_binary_auroc,
    )
    from metrics_tpu_torch.parallel.sample_sort import sample_sort_auroc_ap

    rng = np.random.RandomState(7)
    world = _world()
    checks, adversarial = {}, {}
    before = launch_counts()
    name_of = torch.cuda.get_device_name(device) if device.type == "cuda" else ""
    emit(f"PLATFORM {device.type} {name_of}".rstrip())

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def sz(n):
        return max(512, int(n * scale))

    def check(name, got, want, tol, sharded=False):
        w = np.asarray(want, dtype=np.float64)
        got = got.detach().cpu().double().numpy() if isinstance(got, torch.Tensor) else got
        abs_err = float(np.max(np.abs(np.asarray(got, dtype=np.float64) - w)))
        ok = abs_err <= tol  # a NaN error fails
        checks[name] = {"abs_err": abs_err, "tol": tol, "ok": ok}
        emit(" ".join(["CHECK", name, repr(abs_err), str(tol), repr(float(w.min())), repr(float(w.max())),
                       str(w.size)] + ([f"world={world}"] if sharded else [])))

    @contextlib.contextmanager
    def adversarial_check(name):
        records = []
        with scan_tap(records):
            yield
        results = [kernel_against_plain(r) for r in records]
        adversarial[name] = results
        for r in results:
            emit(f"ADV {name} {r['entry'].replace(' ', '+')} auroc {r['kernel'][0]} {r['plain'][0]}"
                 f" ap {r['kernel'][1]} {r['plain'][1]} {r['abs_err']!r}")
        if device.type == "cuda" and not results:
            emit(f"ADV {name} no tie_scan launch on the card")

    # Accuracy: the argmax/count path
    probs = rng.rand(sz(50_000), 8).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    labels = rng.randint(8, size=sz(50_000))
    m = M.Accuracy(device=device)
    check("accuracy", m(T(probs), T(labels)), np.mean(labels == probs.argmax(1)), 1e-6)

    # AUROC: the co-sort and the scan at size, with score ties
    scores = np.round(rng.rand(sz(500_000)) * 1000).astype(np.float32) / 1000
    bt = (rng.rand(sz(500_000)) < scores).astype(np.int32)
    a = M.AUROC(device=device)
    a.update(T(scores), T(bt))
    want_auroc = roc_auc(bt, scores)
    check("auroc_sort_kernel", a.compute(), want_auroc, 1e-5)

    # ConfusionMatrix: the label-count path
    cm_preds, cm_t = rng.randint(6, size=sz(20_000)), rng.randint(6, size=sz(20_000))
    cm = M.ConfusionMatrix(num_classes=6, device=device)
    cm.update(T(cm_preds), T(cm_t))
    check("confusion_matrix", cm.compute(), confusion_matrix(cm_t, cm_preds, 6), 0.5)

    # SSIM: the blur, in full float32
    ip = rng.rand(4, 3, 64, 64).astype(np.float32)
    it = (ip * 0.7 + 0.3 * rng.rand(4, 3, 64, 64)).astype(np.float32)
    dr = float(max(ip.max() - ip.min(), it.max() - it.min()))
    s = M.SSIM(data_range=dr, device=device)
    s.update(T(ip), T(it))
    check("ssim_conv", s.compute(), oracle_ssim(ip, it, dr), 1e-4)

    # R2Score: moment accumulators in float32
    rt = rng.randn(sz(100_000)).astype(np.float32) * 3 + 1
    rp = rt + rng.randn(sz(100_000)).astype(np.float32)
    r2 = M.R2Score(device=device)
    r2.update(T(rp), T(rt))
    check("r2score_moments", r2.compute(), r2_score(rt, rp), 1e-3)

    # RetrievalMAP: the grouped ranking
    qi = rng.randint(sz(500), size=sz(50_000))
    qp = rng.rand(sz(50_000)).astype(np.float32)
    qt = (rng.rand(sz(50_000)) < 0.1).astype(np.int32)
    rm = M.RetrievalMAP(device=device)
    rm.update(T(qi), T(qp), T(qt))
    check("retrieval_map", rm.compute(), oracle_map(qi, qp, qt), 1e-4)

    # ShardedAUROC: the masked kernel over this rank's buffer, at the process's world
    sh = M.ShardedAUROC(capacity_per_device=sz(500_000), device=device)
    sh.update(T(scores), T(bt))
    check("sharded_auroc_mesh", sh.compute(), want_auroc, 1e-5, sharded=True)

    # the sample sort's programs (at world 1 one bucket: the offset form of the scan)
    want_ap = average_precision(bt, scores)
    ss_a, ss_ap = sample_sort_auroc_ap(sh.buf_preds, sh.buf_target, sh._fill())
    check("samplesort_spmd_auroc", ss_a, want_auroc, 1e-5, sharded=True)
    check("samplesort_spmd_ap", ss_ap, want_ap, 1e-5, sharded=True)

    # weighted: the third co-sorted stream and the weighted scan
    sw = rng.exponential(size=scores.shape[0]).astype(np.float32)
    want_w = roc_auc(bt, scores, sw)
    shw = M.ShardedAUROC(capacity_per_device=sz(500_000), with_sample_weights=True, device=device)
    shw.update(T(scores), T(bt), sample_weights=T(sw))
    check("samplesort_weighted_auroc", shw.compute(), want_w, 1e-5, sharded=True)
    w_a, w_ap = sample_sort_auroc_ap(shw.buf_preds, shw.buf_target, shw._fill(), weights=shw.buf_weights)
    check("samplesort_weighted_spmd_auroc", w_a, want_w, 1e-5, sharded=True)
    check("samplesort_weighted_spmd_ap", w_ap, average_precision(bt, scores, sw), 1e-5, sharded=True)

    # the masked weighted epilogue over one gathered stream
    with adversarial_check("adv_weighted_gather_epilogue"):
        mw_a = masked_weighted_binary_auroc(T(scores), T(bt), torch.ones(scores.shape[0], device=device), T(sw))
    check("adv_weighted_gather_epilogue", mw_a, want_w, 1e-5)

    # weighted one-vs-rest: the weighted batched scan, macro over weighted supports
    ovr_n, ovr_c = sz(100_000), 6
    ovr_p = rng.rand(ovr_n, ovr_c).astype(np.float32)
    ovr_t = rng.randint(ovr_c, size=ovr_n).astype(np.int32)
    ovr_w = rng.exponential(size=ovr_n).astype(np.float32)
    ovr_m = M.ShardedAUROC(capacity_per_device=ovr_n, num_classes=ovr_c, average="macro", with_sample_weights=True,
                           device=device)
    ovr_m.update(T(ovr_p), T(ovr_t), sample_weights=T(ovr_w))
    ovr_want = float(np.mean([roc_auc((ovr_t == c).astype(int), ovr_p[:, c], ovr_w) for c in range(ovr_c)]))
    check("weighted_ovr_macro", ovr_m.compute(), ovr_want, 1e-5, sharded=True)

    # weighted binned histograms; scores on the bin centres make binning lossless
    bw_scores = (np.floor(rng.rand(sz(200_000)) * 512) / 512 + 0.5 / 512).astype(np.float32)
    bw_t = rng.randint(2, size=bw_scores.shape[0])
    bw_w = rng.rand(bw_scores.shape[0]).astype(np.float32)
    bw_m = M.BinnedAUROC(num_bins=512, device=device)
    bw_m.update(T(bw_scores), T(bw_t), sample_weights=T(bw_w))
    check("weighted_binned_histogram", bw_m.compute(), roc_auc(bw_t, bw_scores, bw_w), 1e-5)

    nb = 512
    qscores = (np.floor(rng.rand(sz(200_000)) * nb) / nb + 0.5 / nb).astype(np.float32)
    qtb = rng.randint(2, size=sz(200_000))
    bm = M.BinnedAUROC(num_bins=nb, device=device)
    bm.update(T(qscores), T(qtb))
    check("binned_auroc_histogram", bm.compute(), roc_auc(qtb, qscores), 1e-5)

    # ROC: thresholds recovered from the keys; quantized scores fix the point count.
    # thresholds[0] is the reference's max + 1 point, against the oracle's inf
    roc = M.ROC(device=device)
    roc.update(T(scores), T(bt))
    fpr, tpr, thr = (v.detach().cpu().numpy() for v in roc.compute())
    o_fpr, o_tpr, o_thr = roc_curve(bt, scores)
    check("roc_curve_len", len(fpr), len(o_fpr), 0)
    if len(fpr) == len(o_fpr):
        check("roc_curve_fpr", fpr, o_fpr, 1e-6)
        check("roc_curve_tpr", tpr, o_tpr, 1e-6)
        check("roc_curve_thresholds", thr[1:], o_thr[1:], 1e-6)

    apm = M.AveragePrecision(device=device)
    apm.update(T(scores), T(bt))
    check("average_precision_sort_kernel", apm.compute(), want_ap, 1e-5)

    # F1 macro: the stat-score counts and the zero-division-masked mean
    f1_preds, f1_t = rng.randint(6, size=sz(40_000)), rng.randint(6, size=sz(40_000))
    f1m = M.F1(num_classes=6, average="macro", device=device)
    check("f1_macro_stat_scores", f1m(T(f1_preds), T(f1_t)), f1_macro(f1_t, f1_preds), 1e-6)

    ckm = M.CohenKappa(num_classes=6, weights="quadratic", device=device)
    check("cohen_kappa_quadratic", ckm(T(f1_preds), T(f1_t)), cohen_kappa_quadratic(f1_t, f1_preds), 1e-5)

    # PSNR with data_range=None: the min/max states
    px = rng.rand(sz(100_000)).astype(np.float32) * 7
    py = (px + rng.randn(sz(100_000)) * 0.3).astype(np.float32)
    pm = M.PSNR(data_range=None, device=device)
    pm.update(T(py), T(px))
    p_dr = float(px.max() - px.min())
    p_mse = float(np.mean((py.astype(np.float64) - px.astype(np.float64)) ** 2))
    check("psnr_minmax_states", pm.compute(), 20 * np.log10(p_dr) - 10 * np.log10(p_mse), 1e-2)

    emb = rng.randn(512, 256).astype(np.float32)
    sim = embedding_similarity(T(emb), similarity="cosine", zero_diagonal=False)
    emb_n = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float64)
    check("embedding_similarity_matmul", sim, emb_n @ emb_n.T, 1e-5)

    # ---- adversarial streams: the exact kernel on the card against the host
    # float64 Mann-Whitney oracle, which shares nothing with it but the key map

    # signed zeros: ±0.0 in one tie group, the positives skewed to -0.0
    n_adv = sz(200_000)
    zp = rng.randn(n_adv).astype(np.float32)
    z_t = (rng.rand(n_adv) < 0.4).astype(np.int32)
    zero_slots = rng.rand(n_adv) < 0.2
    zp[zero_slots] = np.where(z_t[zero_slots] == 1, -0.0, 0.0).astype(np.float32)
    with adversarial_check("adv_auroc_signed_zero"):
        got = binary_auroc(T(zp), T(z_t))
    check("adv_auroc_signed_zero", got, host_mw_auroc(_descending_key(zp), z_t), 1e-5)

    # ±inf scores: extremes of the key, each in its own tie group
    ip_adv = rng.randn(n_adv).astype(np.float32)
    ip_adv[: n_adv // 100] = np.inf
    ip_adv[n_adv // 100: n_adv // 50] = -np.inf
    with adversarial_check("adv_auroc_inf_scores"):
        got = binary_auroc(T(ip_adv), T(z_t))
    check("adv_auroc_inf_scores", got, host_mw_auroc(_descending_key(ip_adv), z_t), 1e-5)

    # tie storm: 8 distinct scores, tie groups far longer than a tile
    storm = (rng.randint(8, size=n_adv) / 8.0).astype(np.float32)
    with adversarial_check("adv_auroc_tie_storm"):
        storm_auroc = binary_auroc(T(storm), T(z_t))
    check("adv_auroc_tie_storm", storm_auroc, host_mw_auroc(_descending_key(storm), z_t), 1e-5)
    with adversarial_check("adv_ap_tie_storm"):
        got = binary_average_precision(T(storm), T(z_t))
    check("adv_ap_tie_storm", got, host_mw_average_precision(_descending_key(storm), z_t), 1e-5)

    # a single class: NaN, not 0 and not garbage
    deg_n = min(2048, n_adv)
    with adversarial_check("adv_auroc_degenerate_nan"):
        got_deg = float(binary_auroc(T(zp[:deg_n]), torch.ones(deg_n, dtype=torch.int32, device=device)))
    check("adv_auroc_degenerate_nan", float(np.isnan(got_deg)), 1.0, 0)

    # a permutation of the same stream gives the same bits
    perm = rng.permutation(n_adv)
    with adversarial_check("adv_auroc_permutation_invariance"):
        a_perm = binary_auroc(T(storm[perm]), T(z_t[perm]))
    check("adv_auroc_permutation_invariance", a_perm, float(storm_auroc), 0)

    # a positive class past 2^24 members, where a float32 count sticks
    n_pos_big = sz((1 << 24) + (1 << 20))
    n_neg_big = sz(1 << 22)
    big_p = rng.rand(n_pos_big + n_neg_big).astype(np.float32)
    big_t = np.zeros(n_pos_big + n_neg_big, np.int32)
    big_t[:n_pos_big] = 1
    with adversarial_check("adv_auroc_2p24_counts"):
        got = binary_auroc(T(big_p), T(big_t))
    check("adv_auroc_2p24_counts", got, host_mw_auroc(_descending_key(big_p), big_t), 1e-4)

    after = launch_counts()
    launches = {k: after[k] - before[k] for k in ENTRIES}
    emit("LAUNCHES " + json.dumps(launches))
    adv_ok = all(r["ok"] for rs in adversarial.values() for r in rs)
    if device.type == "cuda":
        adv_ok = adv_ok and all(adversarial.values())
    ok = all(c["ok"] for c in checks.values()) and adv_ok
    emit("DONE")
    return {"ok": ok, "checks": checks, "adversarial": adversarial, "launches": launches, "world": world}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="the card (default) or cpu")
    ap.add_argument("--scale", type=float, default=1.0, help="shrinks the workloads (1.0: the tier's sizes)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_correctness: no CUDA device is available (pass --device cpu to run on the CPU)")
    result = run_tier(device, args.scale)
    failed = sorted(n for n, c in result["checks"].items() if not c["ok"])
    failed += sorted(f"{n}: {r['entry']}" for n, rs in result["adversarial"].items() for r in rs if not r["ok"])
    if device.type == "cuda":
        failed += sorted(f"{n}: no launch" for n, rs in result["adversarial"].items() if not rs)
    for name in failed:
        print(f"FAIL {name}", file=sys.stderr)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
