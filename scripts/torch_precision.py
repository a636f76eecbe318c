#!/usr/bin/env python
"""The precision policy on a device: half inputs and half states through
the port's paths, each value held against its float32 run, a float64
oracle of the half-rounded scores, or the same call on the CPU.

Four legs (``chip_smoke.py``'s phase 4t runs them on the card at scale 1):

a. the classification pack in half inputs: the JAX package's 16
   half-precision cases (``tests/classification/test_half_precision.py``,
   the same metrics, arguments and tolerances) on the forward leg's rows,
   in bfloat16 and float16, through the module's ``forward`` and the
   functional form, against the port's float32 value (the case's ``atol``,
   ``rtol`` 2e-2); AUROC and AP also against the float64 oracle of the
   half-rounded scores (1e-6). Then the regression pack's 7 half cases
   (``tests/test_torch_regression.py::HALF_CASES``) on the regression leg's
   rows, against the same call on the CPU (1e-6 relative; R2 and explained
   variance 1e-5 absolute). ``MeanSquaredLogError`` takes the rows'
   absolute values (its log needs non-negative inputs).
b. half scores and half states on the main path: the north-star step
   (``Accuracy`` + binary ``AUROC``, 10 batches) on bf16 scores through a
   collection cast with ``half()`` and one cast with ``bfloat16()`` (equal
   bits; Accuracy, whose counts stay bf16, equal to the same run on the
   CPU; AUROC to the oracle), then one-vs-rest ``AUROC`` and
   ``AveragePrecision`` on bf16 ``(N, C)`` scores against per-class oracles.
c. the sharded buffer: ``ShardedAUROC(preds_dtype=torch.bfloat16)`` at world
   1 (half the buffer bytes of the float32 one) and a float32 one cast with
   ``bfloat16()`` mid-accumulation, both against the oracle.
d. the engine's graph: a ``compiled=True`` ``Accuracy`` +
   ``BinnedAUROC(num_bins=512)`` cast with ``bfloat16()`` and fed float32
   batches, bit-equal to the eager collection at every step. Its float
   histogram states promote to float32 at the first update and the
   signature keys state dtypes, so it builds twice.

Every ``tie_scan`` launch of (a)–(c) is recorded
(``torch_correctness.scan_tap``) and held against its plain version on the
same sorted streams (``kernel_against_plain``: within 1e-6, class totals
equal), with each stream's distinct keys and largest tie group. On the card
no leg may call a plain scan or leave a value on the CPU.

Output, one line each::

    PLATFORM <device type> <device name>
    CASE <name> <dtype> <path> <abs_err vs float32> <atol> [oracle <abs_err>]
    REG <name> <dtype> <path> <err vs CPU> <tol>
    STEP ... / OVR ... / SHARDED ... / ENGINE ...
    SCAN <leg> <entry> <elements> keys <distinct> largest <group> err <abs_err>
    LAUNCHES {...}
    DONE

The card is the default and a missing one raises; ``--device cpu`` runs
the same legs on the CPU, where nothing launches. Usage::

    python3 scripts/torch_precision.py [--device cuda] [--scale 1.0]
"""
import argparse
import contextlib
import importlib.util
import json
import os
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = 0
MAIN_N, BATCHES = 1_000_000, 10  # the north-star stream and the forward / regression legs' rows
IMAGENET_N, IMAGENET_C = 50_000, 1_000  # ILSVRC2012 val
CRITEO_N, SHARDED_BATCH = 45_840_617, 4_194_304  # the sharded binary phase's stream
NUM_BINS = 512
HALF_RTOL = 2e-2  # tests/helpers/testers.py::_assert_half_support
ORACLE_TOL = 1e-6  # AUROC / AP against the float64 oracle of the half-rounded scores
SUM_TOL, MOMENT_TOL = 1e-6, 1e-5  # tests/test_torch_regression.py: relative for sums, absolute for R2 / EV
FLIP_ATOL, RANK_ATOL = 0.1, 0.02  # tests/classification/test_half_precision.py
HALVES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def cases(num_classes: int) -> List[tuple]:
    """The JAX package's 16 half-precision cases
    (``tests/classification/test_half_precision.py::CASES``): ``(id, class,
    functional, arguments, input kind, atol)``."""
    c = num_classes
    return [
        ("accuracy-binary", "Accuracy", "accuracy", {"threshold": 0.5}, "binary", FLIP_ATOL),
        ("accuracy-multiclass", "Accuracy", "accuracy", {}, "multiclass", FLIP_ATOL),
        ("stat_scores-binary", "StatScores", "stat_scores", {"threshold": 0.5}, "binary", 3.0),
        ("precision-binary", "Precision", "precision", {"threshold": 0.5}, "binary", FLIP_ATOL),
        ("precision-multiclass", "Precision", "precision", {"num_classes": c, "average": "macro"}, "multiclass",
         FLIP_ATOL),
        ("recall-binary", "Recall", "recall", {"threshold": 0.5}, "binary", FLIP_ATOL),
        ("fbeta-binary", "FBeta", "fbeta", {"threshold": 0.5, "beta": 2.0}, "binary", FLIP_ATOL),
        ("f1-multiclass", "F1", "f1", {"num_classes": c, "average": "macro"}, "multiclass", FLIP_ATOL),
        ("hamming-binary", "HammingDistance", "hamming_distance", {"threshold": 0.5}, "binary", FLIP_ATOL),
        ("confusion_matrix-multiclass", "ConfusionMatrix", "confusion_matrix", {"num_classes": c}, "multiclass", 3.0),
        ("cohen_kappa-multiclass", "CohenKappa", "cohen_kappa", {"num_classes": c}, "multiclass", FLIP_ATOL),
        ("matthews-multiclass", "MatthewsCorrcoef", "matthews_corrcoef", {"num_classes": c}, "multiclass", FLIP_ATOL),
        ("iou-multiclass", "IoU", "iou", {"num_classes": c}, "multiclass", FLIP_ATOL),
        ("hinge-multiclass", "Hinge", "hinge", {}, "multiclass", 1e-2),
        ("auroc-binary", "AUROC", "auroc", {"pos_label": 1}, "binary", RANK_ATOL),
        ("average_precision-binary", "AveragePrecision", "average_precision", {"pos_label": 1}, "binary", RANK_ATOL),
    ]


# tests/test_torch_regression.py::HALF_CASES: (class, functional, arguments, layout of the leg's rows)
REG_CASES = [
    ("MeanSquaredError", "mean_squared_error", {}, "single"),
    ("MeanAbsoluteError", "mean_absolute_error", {}, "multi"),
    ("MeanSquaredLogError", "mean_squared_log_error", {}, "single_abs"),
    ("R2Score", "r2score", {"num_outputs": 5}, "multi"),
    ("ExplainedVariance", "explained_variance", {}, "single"),
    ("PSNR", "psnr", {"data_range": 10}, "single"),
    ("PSNR", "psnr", {"data_range": 5, "dim": (1, 2)}, "images"),
]


def _sibling(name: str):
    """``scripts/<name>.py`` as a module (the tier's launch tap)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                                     f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


# ---- inputs ------------------------------------------------------------------------------


def binary_leg(n: int, seed: int):
    """The binary cases' rows: the JAX fixture's recipe
    (``tests/classification/inputs.py``: uniform scores, 0/1 labels) drawn
    from the forward leg's seed."""
    rs = np.random.RandomState(seed)
    return rs.rand(n).astype(np.float32), rs.randint(2, size=n)


def make_inputs(scale: float = 1.0) -> Dict[str, tuple]:
    """Seeded numpy inputs of every leg at ``scale`` (1.0: phase 4t's sizes):
    ``forward`` (the JAX bench's forward-leg 4-class rows), ``binary`` (the
    JAX fixture's binary recipe from the same seed), ``regression`` (the
    regression leg's rows), ``stream`` (the north-star stream), ``ovr``
    (ImageNet-shaped softmax scores and balanced labels) and ``sharded``."""
    n = max(10_000, int(MAIN_N * scale) // 10_000 * 10_000)
    rs = np.random.RandomState(SEED)
    p4 = rs.rand(n, 4).astype(np.float32)
    p4 = p4 / p4.sum(1, keepdims=True)
    t4 = rs.randint(4, size=n)
    t_reg = (rs.randn(n) * 3 + 1).astype(np.float32)
    p_reg = t_reg + rs.randn(n).astype(np.float32)
    binary = binary_leg(n, SEED)
    rng = np.random.default_rng(SEED)
    stream_p = rng.random(n, dtype=np.float32)
    stream_t = (rng.random(n) < stream_p).astype(np.int64)
    classes = max(10, int(IMAGENET_C * scale))
    rows = max(classes * 10, int(IMAGENET_N * scale) // classes * classes)
    ovr_t = rng.permutation(np.repeat(np.arange(classes), rows // classes))
    logits = rng.standard_normal((rows, classes), dtype=np.float32)
    logits[np.arange(rows), ovr_t] += np.float32(3.0)
    logits -= logits.max(axis=1, keepdims=True)
    np.exp(logits, out=logits)
    ovr_p = logits / logits.sum(axis=1, keepdims=True)
    m = max(100_000, int(CRITEO_N * scale))
    sh_p = rng.random(m, dtype=np.float32)
    sh_t = (rng.random(m) < sh_p).astype(np.int32)
    return {"forward": (p4, t4), "binary": binary, "regression": (p_reg, t_reg), "stream": (stream_p, stream_t),
            "ovr": (ovr_p, ovr_t), "sharded": (sh_p, sh_t),
            "sharded_batch": max(10_000, int(SHARDED_BATCH * scale)), "batches": BATCHES, "num_bins": NUM_BINS}


# ---- float64 oracles of half-rounded scores --------------------------------------------------


def half_bits(scores: torch.Tensor) -> np.ndarray:
    """The uint16 bit patterns of half-precision scores, on the host. For
    non-negative scores (sign bit clear, checked) ascending bits are
    ascending scores and equal bits equal scores."""
    bits = scores.view(torch.int16).cpu().numpy().view(np.uint16)
    if np.any(bits & 0x8000):
        raise ValueError("the half oracle takes non-negative scores (sign bit clear)")
    return bits


def half_oracle(bits: np.ndarray, target: np.ndarray):
    """Tie-corrected float64 ``(AUROC, AP)`` of half-precision scores given
    by :func:`half_bits`: one stream (``bits`` ``(N,)``, ``target`` 0/1) or
    one-vs-rest columns (``bits`` ``(N, C)``, ``target`` labels in
    ``[0, C)``, returning ``(C,)`` arrays). The scores have at most 65,536
    values, so each class is a histogram over them, scanned from the top."""
    present = np.zeros(1 << 16, bool)
    present[bits.ravel()] = True
    lut = np.cumsum(present) - 1
    k = int(present.sum())
    idx = lut[bits]
    if bits.ndim == 1:
        tot = np.bincount(idx, minlength=k)[None]
        pos = np.bincount(idx, weights=(target == 1).astype(np.float64), minlength=k)[None]
    else:
        c = bits.shape[1]
        tot = np.bincount((idx + k * np.arange(c)[None, :]).ravel(), minlength=c * k).reshape(c, k)
        own = idx[np.arange(len(target)), target]
        pos = np.bincount(target * k + own, minlength=c * k).reshape(c, k)
    pos = pos[:, ::-1].astype(np.float64)
    neg = tot[:, ::-1].astype(np.float64) - pos
    tp, fp = np.cumsum(pos, 1), np.cumsum(neg, 1)
    n_pos, n_neg = tp[:, -1], fp[:, -1]
    auroc = np.sum(neg * (tp - 0.5 * pos), 1) / (n_pos * n_neg)
    precision = np.divide(tp, tp + fp, out=np.zeros_like(tp), where=(tp + fp) > 0)
    ap = np.sum(pos * precision, 1) / n_pos
    return (float(auroc[0]), float(ap[0])) if bits.ndim == 1 else (auroc, ap)


# ---- the run -------------------------------------------------------------------------------


def _f64(value) -> np.ndarray:
    if isinstance(value, (list, tuple)):
        return np.concatenate([_f64(v).ravel() for v in value])
    return value.detach().double().cpu().numpy()


def _leaves(value) -> list:
    return [leaf for v in value for leaf in _leaves(v)] if isinstance(value, (list, tuple)) else [value]


def _tie_profile(key_s: torch.Tensor):
    """``(fewest distinct keys of a row, most, largest tie group)`` of a
    sorted ``(N,)`` stream or ``(C, N)`` rows."""
    k = key_s if key_s.ndim == 2 else key_s[None]
    starts = torch.ones(k.shape, dtype=torch.bool, device=k.device)
    starts[:, 1:] = k[:, 1:] != k[:, :-1]
    distinct = starts.sum(1)
    first = torch.nonzero(starts.reshape(-1)).squeeze(1)
    lengths = torch.diff(first, append=torch.tensor([k.numel()], device=k.device))
    return int(distinct.min()), int(distinct.max()), int(lengths.max())


def run(device: torch.device, inputs: Dict[str, tuple], emit: Callable[[str], None] = print) -> dict:
    """Run the four legs on ``device`` over ``inputs`` (:func:`make_inputs`'s
    layout). Returns ``{"ok", "failures", "legs": {leg: {...}}, "scans":
    [...], "launches": {entry: n}, "plain_calls_on_card"}``; a failed check
    is listed in ``failures``, not raised, so every leg runs."""
    import metrics_tpu_torch as M
    import metrics_tpu_torch.functional as F
    from metrics_tpu_torch.ops import tie_scan

    tier = _sibling("torch_correctness")
    on_card = device.type == "cuda"
    failures: List[str] = []
    legs: Dict[str, dict] = {}
    scans: List[dict] = []
    before = tier.launch_counts()
    emit(f"PLATFORM {device.type} {torch.cuda.get_device_name(device) if on_card else ''}".rstrip())

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def fail(what: str):
        failures.append(what)
        emit(f"FAIL {what}")

    def where(label, value):
        if on_card and any(leaf.device.type != "cuda" for leaf in _leaves(value)):
            fail(f"{label}: a value left the card")

    plain = {"calls": 0}
    scan_reference = tie_scan._scan_reference

    def counted_reference(key, *args):
        if key.device.type == "cuda":
            plain["calls"] += 1
        return scan_reference(key, *args)

    @contextlib.contextmanager
    def leg(name):
        """Time the leg, tap its launches and count plain scans while it
        drives; then hold each launch against its plain version."""
        records = []
        counts = tier.launch_counts()
        t0 = time.perf_counter()
        tie_scan._scan_reference = counted_reference
        try:
            with tier.scan_tap(records):
                yield legs.setdefault(name, {})
        finally:
            tie_scan._scan_reference = scan_reference
        if on_card:
            torch.cuda.synchronize(device)
        legs[name]["drive_s"] = time.perf_counter() - t0
        legs[name]["launches"] = {k: v - counts[k] for k, v in tier.launch_counts().items()}
        for r in records:
            checked = tier.kernel_against_plain(r)
            fewest, most, largest = _tie_profile(r["args"][0])
            scan = {"leg": name, "entry": checked["entry"], "elements": int(r["args"][0].numel()),
                    "rows": int(r["args"][0].shape[0]) if r["rows"] else 1, "distinct_keys": [fewest, most],
                    "largest_tie_group": largest, "abs_err": checked["abs_err"], "ok": checked["ok"]}
            scans.append(scan)
            keys = f"{fewest}" if fewest == most else f"{fewest}..{most}"
            emit(f"SCAN {name} {scan['entry'].replace(' ', '+')} {scan['elements']} keys {keys} largest {largest}"
                 f" err {checked['abs_err']!r}")
            if not checked["ok"]:
                fail(f"{name}: {checked['entry']} launch against its plain version: {checked['abs_err']}")
        legs[name]["scans"] = len(records)
        legs[name]["leg_s"] = time.perf_counter() - t0

    # a. the classification pack, then the regression pack, in half inputs
    with leg("a") as out:
        p4, t4 = inputs["forward"]
        pb, tb = inputs["binary"]
        data = {"binary": (pb, tb), "multiclass": (p4, t4)}
        on_dev = {kind: (T(p), T(t)) for kind, (p, t) in data.items()}
        worst = {}
        for name, cls, fn, args, kind, atol in cases(p4.shape[1]):
            preds, target = on_dev[kind]
            want = getattr(F, fn)(preds, target, **args)
            for half, dtype in HALVES.items():
                ph = preds.to(dtype)
                oracle = half_oracle(half_bits(ph), data[kind][1]) if fn in ("auroc", "average_precision") else None
                for path in ("module", "functional"):
                    got = getattr(M, cls)(**args, device=device)(ph, target) if path == "module" else \
                        getattr(F, fn)(ph, target, **args)
                    where(f"a. {name} {half} {path}", got)
                    g, w = _f64(got), _f64(want)
                    err = float(np.max(np.abs(g - w)))
                    if g.shape != w.shape or not np.all(np.abs(g - w) <= atol + HALF_RTOL * np.abs(w)):
                        fail(f"a. {name} {half} {path}: {g.tolist()[:8]} vs float32 {w.tolist()[:8]}")
                    line = f"CASE {name} {half} {path} {err!r} {atol}"
                    if oracle is not None:
                        o_err = abs(float(g.ravel()[0]) - oracle[0 if fn == "auroc" else 1])
                        line += f" oracle {o_err!r}"
                        worst["oracle"] = max(worst.get("oracle", 0.0), o_err)
                        if not o_err <= ORACLE_TOL:
                            fail(f"a. {name} {half} {path}: {float(g.ravel()[0])} vs the float64 oracle {oracle}")
                    worst[name] = max(worst.get(name, 0.0), err)
                    emit(line)
        out["max_abs_err_vs_float32"] = worst
        p_reg, t_reg = inputs["regression"]
        n = len(p_reg) // 10_000 * 10_000
        layouts = {"single": (p_reg[:n], t_reg[:n]), "single_abs": (np.abs(p_reg[:n]), np.abs(t_reg[:n])),
                   "multi": (p_reg[:n].reshape(-1, 5), t_reg[:n].reshape(-1, 5)),
                   "images": (p_reg[:n].reshape(-1, 100, 100), t_reg[:n].reshape(-1, 100, 100))}
        reg_worst = 0.0
        for i, (cls, fn, args, layout) in enumerate(REG_CASES):
            fn_args = {k: v for k, v in args.items() if k != "num_outputs"}
            moments = cls in ("R2Score", "ExplainedVariance")
            for half, dtype in HALVES.items():
                p, t = (T(a).to(dtype) for a in layouts[layout])
                for path in ("functional", "module"):
                    def call(dev, a, b):
                        if path == "functional":
                            return getattr(F, fn)(a, b, **fn_args)
                        return getattr(M, cls)(**args, device=dev)(a, b)

                    got, want = call(device, p, t), call(torch.device("cpu"), p.cpu(), t.cpu())
                    where(f"a. {cls}-{i} {half} {path}", got)
                    g, w = _f64(got), _f64(want)
                    err = float(np.max(np.abs(g - w))) if moments else float(np.max(np.abs(g - w) / np.abs(w)))
                    tol = MOMENT_TOL if moments else SUM_TOL
                    if got.dtype != torch.float32 or not err <= tol:
                        fail(f"a. {cls}-{i} {half} {path}: {g.tolist()} ({got.dtype}) vs the CPU's {w.tolist()}")
                    reg_worst = max(reg_worst, err)
                    emit(f"REG {cls}-{i} {half} {path} {err!r} {tol}")
        out["regression_max_err_vs_cpu"] = reg_worst
        out["cases"] = 16 * 2 * 2 + len(REG_CASES) * 2 * 2

    # b. the north-star step on bf16 scores with half states, then one-vs-rest in bf16
    with leg("b") as out:
        sp, st = inputs["stream"]
        batches = inputs["batches"]
        size = len(sp) // batches
        ph, t = T(sp).to(torch.bfloat16), T(st)

        def north_star(dev, cast):
            col = M.MetricCollection([M.Accuracy(device=dev), M.AUROC(pos_label=1, device=dev)])
            return getattr(col, cast)()

        by_half, by_bf16 = north_star(device, "half"), north_star(device, "bfloat16")
        on_cpu = M.MetricCollection([M.Accuracy(device="cpu")]).half()
        for b in range(batches):
            sl = slice(b * size, (b + 1) * size)
            s1, s2 = by_half(ph[sl], t[sl]), by_bf16(ph[sl], t[sl])
            s_cpu = on_cpu(ph[sl].cpu(), t[sl].cpu())
            where(f"b. north-star step {b}", list(s1.values()))
            if not all(torch.equal(s1[k], s2[k]) for k in s1):
                fail(f"b. step {b}: half() {s1} and bfloat16() {s2} differ")
            if not torch.equal(s1["Accuracy"].cpu(), s_cpu["Accuracy"]):
                fail(f"b. step {b}: Accuracy {s1['Accuracy']} vs the CPU's {s_cpu['Accuracy']}")
        r1, r2, r_cpu = by_half.compute(), by_bf16.compute(), on_cpu.compute()
        if not all(torch.equal(r1[k], r2[k]) for k in r1):
            fail(f"b. compute: half() {r1} and bfloat16() {r2} differ")
        if not torch.equal(r1["Accuracy"].cpu(), r_cpu["Accuracy"]):
            fail(f"b. compute: Accuracy {r1['Accuracy']} vs the CPU's {r_cpu['Accuracy']}")
        acc = by_half["Accuracy"]
        if acc.correct.dtype != torch.bfloat16 or by_half["AUROC"].preds[0].dtype != torch.bfloat16:
            fail(f"b. half states: Accuracy.correct {acc.correct.dtype}, AUROC.preds {by_half['AUROC'].preds[0].dtype}")
        q = ph.float().cpu().numpy()
        exact_acc = float(np.mean((q >= 0.5) == (st == 1)))
        auroc_oracle = half_oracle(half_bits(ph), st)[0]
        out["auroc"], out["auroc_oracle"] = float(r1["AUROC"]), auroc_oracle
        out["auroc_err"] = abs(float(r1["AUROC"]) - auroc_oracle)
        out["accuracy"], out["accuracy_exact"] = float(r1["Accuracy"]), exact_acc
        if not out["auroc_err"] <= ORACLE_TOL:
            fail(f"b. AUROC {float(r1['AUROC'])} vs the float64 oracle {auroc_oracle}")
        emit(f"STEP {batches} x {size} bf16: half() = bfloat16() bit for bit; AUROC {out['auroc']!r} (oracle"
             f" {auroc_oracle!r}, err {out['auroc_err']!r}); Accuracy {out['accuracy']!r} = the CPU's (bf16 counts;"
             f" exact count {exact_acc!r})")
        op, ot = inputs["ovr"]
        rows, classes = op.shape
        oh, otd = T(op).to(torch.bfloat16), T(ot)
        ovr = M.MetricCollection([M.AUROC(num_classes=classes, device=device),
                                  M.AveragePrecision(num_classes=classes, device=device)]).half()
        step = rows // batches
        for b in range(batches):
            ovr.update(oh[b * step:(b + 1) * step], otd[b * step:(b + 1) * step])
        res = ovr.compute()
        where("b. one-vs-rest", [res["AUROC"]] + list(res["AveragePrecision"]))
        o_auroc, o_ap = half_oracle(half_bits(oh), ot)
        ap = _f64(res["AveragePrecision"])
        out["ovr_auroc_err"] = abs(float(res["AUROC"]) - float(np.mean(o_auroc)))
        out["ovr_ap_max_err"] = float(np.max(np.abs(ap - o_ap)))
        if not (out["ovr_auroc_err"] <= ORACLE_TOL and out["ovr_ap_max_err"] <= ORACLE_TOL):
            fail(f"b. one-vs-rest: macro AUROC off the oracle by {out['ovr_auroc_err']}, AP by {out['ovr_ap_max_err']}")
        emit(f"OVR {rows} x {classes} bf16: macro AUROC {float(res['AUROC'])!r} (oracle {float(np.mean(o_auroc))!r},"
             f" err {out['ovr_auroc_err']!r}); per-class AP max err {out['ovr_ap_max_err']!r}")

    # c. the sharded buffer in bf16, built so and cast mid-accumulation
    with leg("c") as out:
        cp, ct = inputs["sharded"]
        batch = inputs["sharded_batch"]
        p, t = T(cp), T(ct)
        cuts = [slice(b, b + batch) for b in range(0, len(cp), batch)]
        built = M.ShardedAUROC(capacity_per_device=len(cp), preds_dtype=torch.bfloat16, device=device)
        cast = M.ShardedAUROC(capacity_per_device=len(cp), device=device)
        f32_bytes = cast.buf_preds.nbytes
        for i, sl in enumerate(cuts):
            built.update(p[sl], t[sl])
            if i == len(cuts) // 2:
                cast.bfloat16()
            cast.update(p[sl], t[sl])
        v_built, v_cast = built.compute(), cast.compute()
        where("c. sharded", [v_built, v_cast])
        oracle = half_oracle(half_bits(p.to(torch.bfloat16)), ct)[0]
        out["buffer_bytes"], out["float32_buffer_bytes"] = built.buf_preds.nbytes, f32_bytes
        out["err_built"], out["err_cast"] = abs(float(v_built) - oracle), abs(float(v_cast) - oracle)
        if built.buf_preds.dtype != torch.bfloat16 or 2 * built.buf_preds.nbytes != f32_bytes:
            fail(f"c. the bf16 buffer holds {built.buf_preds.nbytes} bytes, the float32 one {f32_bytes}")
        if cast.buf_preds.dtype != torch.bfloat16:
            fail(f"c. bfloat16() mid-accumulation left the buffer {cast.buf_preds.dtype}")
        if not (out["err_built"] <= ORACLE_TOL and out["err_cast"] <= ORACLE_TOL):
            fail(f"c. ShardedAUROC {float(v_built)} / cast {float(v_cast)} vs the float64 oracle {oracle}")
        emit(f"SHARDED {len(cp)} at world 1: bf16 buffer {out['buffer_bytes']} bytes (float32 {f32_bytes});"
             f" AUROC {float(v_built)!r}, cast mid-accumulation {float(v_cast)!r}, oracle {oracle!r}")

    # d. the engine's graph: bf16 states fed float32 batches, compiled against eager
    with leg("d") as out:
        sp, st = inputs["stream"]
        batches, bins = inputs["batches"], inputs["num_bins"]
        size = len(sp) // batches
        p, t = T(sp), T(st)

        def binned(compiled):
            return M.MetricCollection([M.Accuracy(device=device), M.BinnedAUROC(num_bins=bins, device=device)],
                                      compiled=compiled).bfloat16()

        eager, compiled = binned(False), binned(True)
        for b in range(batches):
            sl = slice(b * size, (b + 1) * size)
            ve, vc = eager(p[sl], t[sl]), compiled(p[sl], t[sl])
            if not all(torch.equal(ve[k], vc[k]) for k in ve):
                fail(f"d. step {b}: compiled {vc} vs eager {ve}")
            for name in eager.keys():
                for state in eager[name]._defaults:
                    a, e = getattr(compiled[name], state), getattr(eager[name], state)
                    if a.dtype != e.dtype or not torch.equal(a, e):
                        fail(f"d. step {b}: state {name}.{state} compiled {a.dtype} vs eager {e.dtype}")
        ce, cc = eager.compute(), compiled.compute()
        if not all(torch.equal(ce[k], cc[k]) for k in ce):
            fail(f"d. compute: compiled {cc} vs eager {ce}")
        info = compiled._engine.cache_info()
        out["builds"], out["eager_fallbacks"] = info["trace_count"], info["eager_fallbacks"]
        out["state_dtypes"] = {f"{name}.{state}": str(getattr(compiled[name], state).dtype).replace("torch.", "")
                               for name in compiled.keys() for state in compiled[name]._defaults}
        if info["eager_fallbacks"] or info["trace_count"] != 2:
            fail(f"d. the engine built {info['trace_count']} times (want 2: bf16 states, then float32),"
                 f" fallbacks {info['eager_fallbacks']}")
        emit(f"ENGINE {batches} x {size}: compiled = eager bit for bit; builds {info['trace_count']}, states after"
             f" {out['state_dtypes']}, values {({k: float(v) for k, v in cc.items()})}")

    launches = {k: v - before[k] for k, v in tier.launch_counts().items()}
    if on_card:
        for name, want in (("a", "tie_scan"), ("b", "tie_scan"), ("b", "tie_scan_rows"), ("c", "tie_scan")):
            if not legs[name]["launches"][want]:
                fail(f"{name}: no {want} launch")
        if plain["calls"]:
            fail(f"{plain['calls']} plain scans ran on the card while the legs drove")
    emit(f"LAUNCHES {json.dumps(launches)}")
    emit("DONE")
    return {"ok": not failures, "failures": failures, "legs": legs, "scans": scans, "launches": launches,
            "plain_calls_on_card": plain["calls"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="the card (default) or cpu")
    ap.add_argument("--scale", type=float, default=1.0, help="shrinks the inputs (1.0: phase 4t's sizes)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_precision: no CUDA device is available (pass --device cpu to run on the CPU)")
    result = run(device, make_inputs(args.scale))
    for what in result["failures"]:
        print(f"FAIL {what}", file=sys.stderr)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
