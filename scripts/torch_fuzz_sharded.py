#!/usr/bin/env python
"""Randomized self-consistency fuzz of the port's bounded-state designs.

The ``Sharded*`` metrics (per-rank bounded buffers), the sample sort and the
``Binned*`` histograms have no counterpart in the reference: their contract
is agreement with the exact metrics the port also ships. This drives that
contract with random batch counts and sizes, capacities, class counts, tie
structures, weights and options, in one ``torch.distributed`` world of
``--world`` ranks (one process per rank: gloo with CPU tensors, or NCCL with
one card per rank; world 1 runs in this process without a process group).
Every rank draws the same seeded stream and appends its own shard of each
batch; rank 0 also runs the exact twin over the whole stream and compares.

The domains are the JAX package's (``scripts/fuzz_sharded.py``):

- ``Sharded{AUROC, AveragePrecision, ROC, PrecisionRecallCurve}`` against
  the exact metrics, tie-heavy scores included (the kernels are exact per
  tie group, so the order in which ranks hold the stream cannot matter);
- ``ShardedAUROC(preds_dtype=torch.bfloat16)`` against the exact metric of
  the bf16-rounded scores;
- ``ShardedRetrieval{MAP, MRR, Precision, Recall}`` against the retrieval
  metrics (unique scores: the gathered stream is a permutation of the
  input, and ties rank by input order);
- the sample sort (``parallel/sample_sort.py``) called directly, unweighted,
  weighted (zero weights included) and on hand-staged buffers of raw
  adversarial floats with uneven fills (signed zeros, ±inf, subnormals, tie
  storms) against the float64 Mann-Whitney oracle, and its retrieval half;
- ``Binned{AUROC, AveragePrecision, PrecisionRecallCurve}`` (each rank
  adding its shard, ``compute`` summing the histograms across the world)
  against the exact metrics on scores on the bin centres, where binning is
  lossless.

Usage::

    python3 scripts/torch_fuzz_sharded.py [--device cuda] [--world W] [--trials 200] [--seed 0] [--domain NAME]

``--world`` defaults to the cards present with ``--device cuda`` and to 4
with ``--device cpu``. The last line is ``torch_fuzz_sharded: <n> trials on
<world> ranks (<device>), <m> matched, <r> rejected-by-both, <k>
MISMATCHES``; exits 0 only when k is 0.
"""
import argparse
import multiprocessing
import os
import queue as queue_module
import socket
import sys
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_correctness import (  # noqa: E402  (the tier's float64 oracles)
    _descending_key,
    average_precision,
    host_mw_auroc,
    host_mw_average_precision,
    roc_auc,
)


def _to_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _compare(ours, theirs, atol):
    """``None`` when ``ours`` equals ``theirs`` within ``atol`` plus 1e-6 of
    ``|theirs|`` (NaN equal to NaN), else what differs; dicts, tuples and
    lists element by element (the JAX package's fuzz comparison)."""
    if isinstance(ours, dict) or isinstance(theirs, dict):
        if not (isinstance(ours, dict) and isinstance(theirs, dict)) or sorted(ours) != sorted(theirs):
            ko = sorted(ours) if isinstance(ours, dict) else type(ours).__name__
            kt = sorted(theirs) if isinstance(theirs, dict) else type(theirs).__name__
            return f"dict keys {ko} vs {kt}"
        for k in sorted(ours):
            err = _compare(ours[k], theirs[k], atol)
            if err:
                return f"[{k}] {err}"
        return None
    ours_seq, theirs_seq = isinstance(ours, (tuple, list)), isinstance(theirs, (tuple, list))
    if ours_seq or theirs_seq:
        if not (ours_seq and theirs_seq) or len(ours) != len(theirs):
            return (
                f"structure mismatch: {len(ours) if ours_seq else type(ours).__name__} "
                f"vs {len(theirs) if theirs_seq else type(theirs).__name__}"
            )
        for i, (a, b) in enumerate(zip(ours, theirs)):
            err = _compare(a, b, atol)
            if err:
                return f"[{i}] {err}"
        return None
    a, b = _to_np(ours).astype(np.float64), _to_np(theirs).astype(np.float64)
    if a.shape != b.shape:
        return f"shape {a.shape} vs {b.shape}"
    both_nan = np.isnan(a) & np.isnan(b)
    with np.errstate(invalid="ignore"):
        # a relative term for large outputs; finite-only, so an inf on one
        # side cannot widen the tolerance to inf
        tol = atol + 1e-6 * np.where(np.isfinite(b), np.abs(b), 0.0)
        bad = ~(both_nan | (a == b) | (np.abs(a - b) <= tol))
    if bad.any():
        i = int(np.argmax(bad.ravel()))
        return f"{int(bad.sum())} elements differ, first at {i}: {a.ravel()[i]!r} vs {b.ravel()[i]!r}"
    return None


# ---- input generators ---------------------------------------------------------------


def _unit(world: int) -> int:
    """The batch unit: the least multiple of the world that is at least 8
    (the JAX package's eight-device unit), so every batch holds both
    classes and every class of a one-vs-rest trial."""
    return world * -(-8 // world)


def _batches(rng, max_total: int, world: int) -> List[int]:
    """1-3 batches, each 1-3 units, fitting the capacity."""
    unit = _unit(world)
    out, total = [], 0
    for _ in range(int(rng.randint(1, 4))):
        n = unit * int(rng.randint(1, 4))
        if total + n > max_total:
            break
        out.append(n)
        total += n
    return out or [unit]


def _tied_scores(rng, n: int) -> np.ndarray:
    mode = rng.randint(3)
    x = rng.rand(n)
    if mode == 1:
        x = np.round(x * rng.choice([2, 5, 10])) / 10
    elif mode == 2:
        x = np.full(n, float(rng.rand()))
    return x.astype(np.float32)


def _adversarial_scores(rng, n: int) -> np.ndarray:
    """Raw floats the modules' probability checks would reject: signed
    zeros, ±inf, subnormals, ties."""
    x = rng.randn(n)
    sel = rng.rand(n)
    x[sel < 0.15] = 0.0
    x[(sel >= 0.15) & (sel < 0.3)] = -0.0
    x[(sel >= 0.3) & (sel < 0.35)] = np.inf
    x[(sel >= 0.35) & (sel < 0.4)] = -np.inf
    x[(sel >= 0.4) & (sel < 0.45)] = 1e-42  # subnormal
    return x.astype(np.float32)


# ---- the domains ----------------------------------------------------------------------


def _one_rank(x, group=None):
    """A sync function that keeps a metric to this process: the exact twins
    run on rank 0 over the whole stream."""
    return [x]


class Rank(NamedTuple):
    """This process's place in the world: it appends shard ``rank`` of each
    batch, and rank 0 runs the exact twins."""

    rank: int
    world: int
    device: torch.device

    def tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def shard(self, a) -> torch.Tensor:
        return self.tensor(np.array_split(np.asarray(a), self.world)[self.rank])

    def exact(self, cls, **kwargs):
        """The exact twin, on rank 0 only (None elsewhere)."""
        return cls(device=self.device, dist_sync_fn=_one_rank, **kwargs) if self.rank == 0 else None


def _outcome(fn: Callable[[], Any]):
    try:
        return fn(), None
    except Exception as err:  # noqa: BLE001 — acceptance parity: any failure must match
        return None, err


def _both_classes(rng, n):
    p, t = _tied_scores(rng, n), rng.randint(2, size=n)
    # both classes present: the exact metric raises on a single class where a
    # sharded one returns NaN, a deliberate difference, not a fuzz target
    # (the adversarial domain covers degenerate streams)
    t[:2] = [0, 1]
    return p, t


def _fz_auroc_binary(rng, M, r: Rank):
    cap = int(rng.choice([16, 64]))
    sh, ex = M.ShardedAUROC(capacity_per_device=cap, device=r.device), r.exact(M.AUROC)
    for n in _batches(rng, cap * r.world, r.world):
        p, t = _both_classes(rng, n)
        sh.update(r.shard(p), r.shard(t))
        if ex is not None:
            ex.update(r.tensor(p), r.tensor(t))
    got = sh.compute()
    return got, ex.compute() if ex is not None else None, 1e-6


def _fz_auroc_bf16(rng, M, r: Rank):
    cap = int(rng.choice([16, 64]))
    sh = M.ShardedAUROC(capacity_per_device=cap, preds_dtype=torch.bfloat16, device=r.device)
    ex = r.exact(M.AUROC)
    for n in _batches(rng, cap * r.world, r.world):
        p, t = _both_classes(rng, n)
        sh.update(r.shard(p), r.shard(t))
        if ex is not None:
            # the documented contract: the exact metric of the bf16-rounded scores
            ex.update(r.tensor(p).to(torch.bfloat16).float(), r.tensor(t))
    got = sh.compute()
    return got, ex.compute() if ex is not None else None, 1e-6


def _fz_auroc_ovr(rng, M, r: Rank):
    from metrics_tpu_torch.ops.auroc_kernel import binary_auroc

    cap, c = int(rng.choice([16, 64])), int(rng.randint(2, 5))
    average = [None, "macro", "weighted"][rng.randint(3)]
    sh = M.ShardedAUROC(capacity_per_device=cap, num_classes=c, average=average, device=r.device)
    batches = []
    for n in _batches(rng, cap * r.world, r.world):
        e = np.exp(rng.rand(n, c))
        p = (e / e.sum(1, keepdims=True)).astype(np.float32)
        t = rng.randint(c, size=n)
        t[:c] = np.arange(c)  # every class present: the averages are defined
        batches.append((p, t))
        sh.update(r.shard(p), r.shard(t))
    got = sh.compute()
    if r.rank != 0:
        return got, None, 1e-6
    allp = np.concatenate([p for p, _ in batches])
    allt = np.concatenate([t for _, t in batches])
    if average:
        ex = r.exact(M.AUROC, num_classes=c, average=average)
        ex.update(r.tensor(allp), r.tensor(allt))
        return got, ex.compute(), 1e-6
    # per class: the binary AUROC of each one-vs-rest column
    want = [binary_auroc(r.tensor(allp[:, k]), r.tensor((allt == k).astype(np.int32))) for k in range(c)]
    return got, torch.stack(want), 1e-6


def _fz_ap_binary(rng, M, r: Rank):
    cap = int(rng.choice([16, 64]))
    sh, ex = M.ShardedAveragePrecision(capacity_per_device=cap, device=r.device), r.exact(M.AveragePrecision)
    for n in _batches(rng, cap * r.world, r.world):
        p, t = _both_classes(rng, n)
        sh.update(r.shard(p), r.shard(t))
        if ex is not None:
            ex.update(r.tensor(p), r.tensor(t))
    got = sh.compute()
    return got, ex.compute() if ex is not None else None, 1e-6


def _acceptance(sh_fn, ex_fn, r: Rank, check_type: bool = False):
    """Both sides' outcome; both must accept or both reject (with the same
    exception type where ``check_type``). Returns ``(got, want, atol)`` or
    an acceptance message, or ``(None, None, 0)`` when both rejected."""
    got, sh_err = _outcome(sh_fn)
    if r.rank != 0:
        return got, None, 1e-6
    want, ex_err = _outcome(ex_fn)
    if (ex_err is None) != (sh_err is None):
        return f"acceptance: sharded={sh_err!r} exact={ex_err!r}", None, 0
    if ex_err is not None:
        if check_type and type(ex_err) is not type(sh_err):
            return f"acceptance type: sharded={sh_err!r} exact={ex_err!r}", None, 0
        return None, None, 0
    return got, want, 1e-6


def _fz_curves(rng, M, r: Rank):
    cap = int(rng.choice([16, 64]))
    cls_sh, cls_ex = (M.ShardedROC, M.ROC) if rng.rand() < 0.5 else (
        M.ShardedPrecisionRecallCurve, M.PrecisionRecallCurve)
    sh, ex = cls_sh(capacity_per_device=cap, device=r.device), r.exact(cls_ex)
    for n in _batches(rng, cap * r.world, r.world):
        p, t = _tied_scores(rng, n), rng.randint(2, size=n)
        sh.update(r.shard(p), r.shard(t))
        if ex is not None:
            ex.update(r.tensor(p), r.tensor(t))
    # a single-class stream may raise (ROC without positives): both must agree
    return _acceptance(lambda: tuple(sh.compute()), lambda: tuple(ex.compute()), r)


def _retrieval_batches(rng, sizes, exclusions: bool):
    total, grand = 0, sum(sizes)
    for n in sizes:
        q = rng.randint(4, size=n).astype(np.int32)
        # unique across the trial: disjoint offset blocks
        p = rng.permutation((np.arange(n) + total + 1).astype(np.float32) / (grand + 1))
        t = rng.randint(2, size=n).astype(np.int32)
        if exclusions and rng.rand() < 0.3:
            t[rng.rand(n) < 0.2] = -100  # excluded entries
        total += n
        yield q, p, t


def _fz_retrieval(rng, M, r: Rank):
    cap = int(rng.choice([16, 64]))
    name = ["MAP", "MRR", "Precision", "Recall"][rng.randint(4)]
    kw = {}
    if name in ("Precision", "Recall") and rng.rand() < 0.5:
        kw["k"] = int(rng.randint(1, 5))
    action = ["skip", "neg", "pos"][rng.randint(3)]
    sh = getattr(M, f"ShardedRetrieval{name}")(capacity_per_device=cap, empty_target_action=action,
                                               device=r.device, **kw)
    ex = r.exact(getattr(M, f"Retrieval{name}"), empty_target_action=action, **kw)
    for q, p, t in _retrieval_batches(rng, _batches(rng, cap * r.world, r.world), exclusions=False):
        sh.update(r.shard(q), r.shard(p), r.shard(t))
        if ex is not None:
            ex.update(r.tensor(q), r.tensor(p), r.tensor(t))
    return _acceptance(sh.compute, lambda: ex.compute(), r, check_type=True)


def _fz_binned(rng, M, r: Rank):
    nb = int(rng.choice([64, 256]))
    which = rng.randint(3)
    n_total = _unit(r.world) * int(rng.randint(2, 9))
    # on the bin centres binning is lossless
    p = ((np.floor(rng.rand(n_total) * nb) + 0.5) / nb).astype(np.float32)
    t = rng.randint(2, size=n_total)
    t[:2] = [0, 1]
    cls, ex_cls = [(M.BinnedAUROC, M.AUROC), (M.BinnedAveragePrecision, M.AveragePrecision),
                   (M.BinnedPrecisionRecallCurve, None)][which]
    b = cls(num_bins=nb, device=r.device)
    b.update(r.shard(p), r.shard(t))  # compute() sums every rank's histograms
    got = b.compute()
    if r.rank != 0:
        return got, None, 1e-6
    if ex_cls is None:
        # every binned point equals the direct value at its threshold (score >=
        # threshold predicts positive; precision 1 where nothing does)
        prec, rec, thr = (_to_np(v) for v in got)
        sel = p[None, :] >= thr[:, None]
        pp = sel.sum(1).astype(np.float64)
        tp = (sel & (t == 1)[None, :]).sum(1).astype(np.float64)
        want_prec = np.where(pp > 0, tp / np.maximum(pp, 1), 1.0)
        want_rec = tp / max(int((t == 1).sum()), 1)
        return (prec, rec), (want_prec, want_rec), 1e-6
    ex = r.exact(ex_cls)
    ex.update(r.tensor(p), r.tensor(t))
    return got, ex.compute(), 1e-6


def _fz_samplesort_spmd(rng, M, r: Rank):
    """The sample sort called directly on the sharded buffers, against the
    exact AUROC and AP (``compute()`` at world 1 takes the masked kernel)."""
    from metrics_tpu_torch.parallel.sample_sort import sample_sort_auroc_ap

    cap = int(rng.choice([16, 64]))
    sh = M.ShardedAUROC(capacity_per_device=cap, device=r.device)
    ex_a, ex_p = r.exact(M.AUROC), r.exact(M.AveragePrecision)
    for n in _batches(rng, cap * r.world, r.world):
        p, t = _both_classes(rng, n)
        sh.update(r.shard(p), r.shard(t))
        for ex in (ex_a, ex_p):
            if ex is not None:
                ex.update(r.tensor(p), r.tensor(t))
    a, ap_v = sample_sort_auroc_ap(sh.buf_preds, sh.buf_target, sh._fill())
    if r.rank != 0:
        return None, None, 1e-5
    return np.asarray([float(a), float(ap_v)]), np.asarray([float(ex_a.compute()), float(ex_p.compute())]), 1e-5


def _fz_samplesort_retrieval(rng, M, r: Rank):
    """The sample sort's retrieval half called directly, against the
    retrieval metrics (excluded entries included)."""
    from metrics_tpu_torch.parallel.sample_sort import sample_sort_retrieval

    cap = int(rng.choice([16, 64]))
    name = ["MAP", "MRR", "Precision", "Recall"][rng.randint(4)]
    kw = {}
    if name in ("Precision", "Recall"):
        kw = {"k": int(rng.randint(1, 5)) if rng.rand() < 0.7 else None}
    action = ["skip", "neg", "pos"][rng.randint(3)]
    sh = getattr(M, f"ShardedRetrieval{name}")(capacity_per_device=cap, empty_target_action=action,
                                               device=r.device, **kw)
    ex = r.exact(getattr(M, f"Retrieval{name}"), empty_target_action=action, **kw)
    for q, p, t in _retrieval_batches(rng, _batches(rng, cap * r.world, r.world), exclusions=True):
        sh.update(r.shard(q), r.shard(p), r.shard(t))
        if ex is not None:
            ex.update(r.tensor(q), r.tensor(p), r.tensor(t))
    got = sample_sort_retrieval(sh.buf_idx, sh.buf_preds, sh.buf_target, sh._fill(), sh._samplesort_scorer(),
                                action, sh.exclude)
    return got, ex.compute() if ex is not None else None, 1e-6


def _fz_samplesort_adversarial(rng, M, r: Rank):
    """The sample sort on hand-staged buffers of adversarial raw floats with
    uneven fills, against the float64 Mann-Whitney oracle: the modules'
    probability checks never let such scores through, so this feeds the
    kernel directly."""
    from metrics_tpu_torch.parallel.sample_sort import sample_sort_auroc_ap

    cap = int(rng.choice([16, 64]))
    preds = np.stack([_adversarial_scores(rng, cap) for _ in range(r.world)])
    target = rng.randint(2, size=(r.world, cap)).astype(np.int32)
    fills = rng.randint(0, cap + 1, size=r.world)
    fills[rng.randint(r.world)] = cap  # at least one full shard
    a, ap_v = sample_sort_auroc_ap(r.tensor(preds[r.rank]), r.tensor(target[r.rank]), int(fills[r.rank]))
    if r.rank != 0:
        return None, None, 1e-5
    vp = np.concatenate([preds[i, : fills[i]] for i in range(r.world)])
    vt = np.concatenate([target[i, : fills[i]] for i in range(r.world)])
    key = _descending_key(vp)
    want = np.asarray([host_mw_auroc(key, vt), host_mw_average_precision(key, vt)])
    got = np.asarray([float(a), float(ap_v)])
    # NaN (a single-class stream) must agree position by position
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        return f"nan pattern: got={got} want={want}", None, 0
    return got, want, 1e-5


def _fz_samplesort_weighted(rng, M, r: Rank):
    """The weighted sample sort and the weighted module against the float64
    weighted oracles, with uniform, exponential and 0/1 weights."""
    from metrics_tpu_torch.parallel.sample_sort import sample_sort_auroc_ap

    cap = int(rng.choice([16, 64]))
    sh = M.ShardedAUROC(capacity_per_device=cap, with_sample_weights=True, device=r.device)
    all_p, all_t, all_w = [], [], []
    for n in _batches(rng, cap * r.world, r.world):
        p, t = _both_classes(rng, n)
        w = [
            lambda: rng.rand(n).astype(np.float32),
            lambda: rng.exponential(size=n).astype(np.float32),
            lambda: (rng.rand(n) < 0.7).astype(np.float32),  # exact zeros
        ][rng.randint(3)]()
        sh.update(r.shard(p), r.shard(t), sample_weights=r.shard(w))
        all_p.append(p)
        all_t.append(t)
        all_w.append(w)
    p, t, w = np.concatenate(all_p), np.concatenate(all_t), np.concatenate(all_w)
    if w[t == 1].sum() == 0 or w[t == 0].sum() == 0:
        return np.zeros(1), np.zeros(1), 1e-5  # degenerate: the oracle is undefined
    a_spmd, ap_spmd = sample_sort_auroc_ap(sh.buf_preds, sh.buf_target, sh._fill(), weights=sh.buf_weights)
    got = np.asarray([float(sh.compute()), float(a_spmd), float(ap_spmd)])
    want_a = roc_auc(t, p, w)
    return got, np.asarray([want_a, want_a, average_precision(t, p, w)]), 1e-5


DOMAINS: Dict[str, Callable] = {
    "sharded_auroc_binary": _fz_auroc_binary,
    "sharded_samplesort_spmd": _fz_samplesort_spmd,
    "sharded_samplesort_weighted": _fz_samplesort_weighted,
    "sharded_samplesort_adversarial": _fz_samplesort_adversarial,
    "sharded_samplesort_retrieval": _fz_samplesort_retrieval,
    "sharded_auroc_bf16": _fz_auroc_bf16,
    "sharded_auroc_ovr": _fz_auroc_ovr,
    "sharded_ap_binary": _fz_ap_binary,
    "sharded_curves": _fz_curves,
    "sharded_retrieval": _fz_retrieval,
    "binned_vs_exact": _fz_binned,
}


def run_trials(rank: int, world: int, device: torch.device, payload: dict) -> dict:
    """Every trial of ``payload`` (``trials``, ``seed``, ``names``) on this
    rank; rank 0's result counts ``matched`` and ``rejected`` and lists the
    ``mismatches``."""
    import metrics_tpu_torch as M

    r = Rank(rank, world, device)
    names = payload["names"]
    rng = np.random.RandomState(payload["seed"])
    matched = rejected = 0
    mismatches = []
    for trial in range(payload["trials"]):
        name = names[rng.randint(len(names))]
        seedhead = rng.get_state()[1][:2].tolist()
        value, err = _outcome(lambda: DOMAINS[name](rng, M, r))
        got, want, atol = value if err is None else (None, None, 0)
        if rank != 0:
            continue
        if err is not None:
            mismatches.append(f"MISMATCH {name} trial={trial} seedhead={seedhead}: raised {err!r}")
        elif isinstance(got, str):  # an acceptance message
            mismatches.append(f"MISMATCH {name} trial={trial} seedhead={seedhead}: {got}")
        elif got is None and want is None:
            rejected += 1
        else:
            diff = _compare(got, want, atol)
            if diff:
                mismatches.append(f"MISMATCH {name} trial={trial} seedhead={seedhead}: {diff}")
            else:
                matched += 1
    return {"matched": matched, "rejected": rejected, "mismatches": mismatches}


# ---- one process per rank -------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, world: int, port: int, device_type: str, payload: dict, results) -> None:
    import torch.distributed as dist

    from metrics_tpu_torch.parallel.backend import TorchDistributedBackend

    device = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
    if device_type == "cuda":
        torch.cuda.set_device(device)
    torch.set_num_threads(1)
    dist.init_process_group(TorchDistributedBackend.process_group_backend(device),
                            init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    try:
        results.put((rank, run_trials(rank, world, device, payload)))
    except BaseException as err:  # reported by the parent
        results.put((rank, err))
        raise
    finally:
        dist.destroy_process_group()


def run_world(world: int, device_type: str, payload: dict, timeout: float = 1800) -> dict:
    """``run_trials`` on every rank of a new world; returns rank 0's result.
    Stops every process it starts."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_entry, args=(r, world, port, device_type, payload, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                rank, result = results.get(timeout=1)
            except queue_module.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(f"a rank of the world of {world} failed (exit codes {dead}) or timed out")
                continue
            if isinstance(result, BaseException):
                raise result
            got[rank] = result
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    return got[0]


def fuzz(trials: int, seed: int, device: torch.device, world: int, domain: Optional[str] = None) -> dict:
    """The whole fuzz: in this process at world 1, else one spawned process
    per rank. Returns rank 0's counts and mismatch lines."""
    names = [domain] if domain else sorted(DOMAINS)
    payload = {"trials": trials, "seed": seed, "names": names}
    if world == 1:
        return run_trials(0, 1, device, payload)
    return run_world(world, device.type, payload)


def summary(trials: int, world: int, device: torch.device, result: dict) -> str:
    return (f"torch_fuzz_sharded: {trials} trials on {world} ranks ({device.type}), {result['matched']} matched,"
            f" {result['rejected']} rejected-by-both, {len(result['mismatches'])} MISMATCHES")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default: NCCL, one card per rank) or cpu (gloo)")
    ap.add_argument("--world", type=int, default=None, help="ranks (default: the cards present, or 4 on the CPU)")
    ap.add_argument("--trials", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--domain", default=None, choices=sorted(DOMAINS))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch_fuzz_sharded: no CUDA device is available (pass --device cpu for gloo)")
        world = args.world or torch.cuda.device_count()
        if world > torch.cuda.device_count():
            raise SystemExit(f"torch_fuzz_sharded: --world {world} needs {world} cards,"
                             f" {torch.cuda.device_count()} present")
        if world == 1:
            device = torch.device("cuda", 0)
    else:
        world = args.world or 4
    result = fuzz(args.trials, args.seed, device, world, args.domain)
    for line in result["mismatches"]:
        print(line)
    print(summary(args.trials, world, device, result))
    return 1 if result["mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())
