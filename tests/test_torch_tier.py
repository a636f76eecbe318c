"""The port's correctness tier (``scripts/torch_correctness.py``) on the CPU.

The tier itself is for the card; these cases pin what surrounds it, as
``tests/test_tpu_tier.py`` does for the JAX package's: the 32 check names
and the ``CHECK`` line protocol at a reduced scale, a failed check making
the script exit non-zero, the kernel-against-plain record of an adversarial
launch, and each float64 oracle of the tier against scikit-learn's (which
the card's machine does not have) on seeded inputs.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn import metrics as sk

from metrics_tpu.ops.auroc_kernel import _descending_key as jax_descending_key
from metrics_tpu_torch.ops import tie_scan
from metrics_tpu_torch.ops.auroc_kernel import _co_sort, _descending_key as port_descending_key
from tests.test_tpu_tier import EXPECTED_CHECKS

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import torch_correctness as tier  # noqa: E402

SHARDED_CHECKS = {
    "sharded_auroc_mesh", "samplesort_spmd_auroc", "samplesort_spmd_ap", "samplesort_weighted_auroc",
    "samplesort_weighted_spmd_auroc", "samplesort_weighted_spmd_ap", "weighted_ovr_macro",
}


def _run_tier(*argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(REPO / "scripts" / "torch_correctness.py"), *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)


def test_protocol_names_and_tolerances_on_the_cpu():
    """Every one of the 32 checks prints one in-tolerance CHECK line; the
    sharded ones say their world; nothing launches on the CPU."""
    proc = _run_tier("--device", "cpu", "--scale", "0.02")
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[0] == "PLATFORM cpu" and lines[-1] == "DONE"
    checks = {}
    for line in lines:
        parts = line.split()
        if parts[0] != "CHECK":
            continue
        name = parts[1]
        # CHECK <name> <abs_err> <tol> <want_min> <want_max> <n> [world=<W>]
        assert len(parts) == (8 if name in SHARDED_CHECKS else 7), line
        if name in SHARDED_CHECKS:
            assert parts[7] == "world=1", line
        float(parts[4]), float(parts[5]), int(parts[6])
        checks[name] = (float(parts[2]), float(parts[3]))
    assert set(checks) == EXPECTED_CHECKS and len(checks) == 32
    for name, (abs_err, tol) in checks.items():
        assert abs_err <= tol, (name, abs_err, tol)
    launches = [line for line in lines if line.startswith("LAUNCHES ")]
    assert len(launches) == 1 and lines.index(launches[0]) < len(lines) - 1
    assert launches[0] == ('LAUNCHES {"tie_scan": 0, "tie_scan_w": 0, "tie_scan_rows": 0, "tie_scan_rows_w": 0,'
                           ' "offsets": 0}')
    assert not [line for line in lines if line.startswith("ADV ")]  # the CPU launches nothing


def test_a_failed_check_exits_non_zero(monkeypatch, capsys):
    """A wrong answer (here, the R2 oracle moved by 0.01, past its 1e-3
    tolerance) makes ``main`` return 1 and name the check."""
    right = tier.r2_score
    monkeypatch.setattr(tier, "r2_score", lambda t, p: right(t, p) + 0.01)
    assert tier.main(["--device", "cpu", "--scale", "0.004"]) == 1
    out, err = capsys.readouterr()
    assert "FAIL r2score_moments" in err and "DONE" in out
    assert not [n for n in EXPECTED_CHECKS - {"r2score_moments"} if f"FAIL {n}\n" in err]


def test_the_card_is_the_default_and_a_missing_one_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = _run_tier()
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert "CHECK" not in proc.stdout


def _stream(n, seed, ties=0):
    rng = np.random.RandomState(seed)
    scores = rng.rand(n).astype(np.float32)
    if ties:
        scores = np.round(scores * ties).astype(np.float32) / ties
    target = rng.randint(2, size=n).astype(np.int32)
    target[:2] = [0, 1]
    return scores, target, rng.exponential(size=n).astype(np.float32)


def test_kernel_against_plain_reads_a_launch_record():
    """The record of a launch (its sorted streams and output) against its
    plain version: equal outputs agree, and a moved area or a moved class
    total is a failure."""
    scores, target, weights = _stream(4_099, 0, ties=50)
    key_s, payload_s, w_s = _co_sort(torch.from_numpy(scores), torch.from_numpy(target).float(), None,
                                     torch.from_numpy(weights))
    for args, rows in (((key_s, payload_s, None, None), False), ((key_s, payload_s, None, w_s), False),
                       ((key_s[None], payload_s[None], None, None), True)):
        plain = (tie_scan.tie_group_reduce_rows_reference if rows else tie_scan.tie_group_reduce_reference)(*args)
        record = {"entry": "tie_scan", "rows": rows, "args": args, "out": plain.clone()}
        same = tier.kernel_against_plain(record)
        assert same["ok"] and same["abs_err"] == 0.0 and same["kernel"] == same["plain"]
        moved = plain.clone()
        moved[..., 0] += 1e-3 * moved[..., 2] * moved[..., 3]  # AUROC + 1e-3
        assert not tier.kernel_against_plain({**record, "out": moved})["ok"]
        recount = plain.clone()
        recount[..., 2] += 1
        assert tier.kernel_against_plain({**record, "out": recount})["abs_err"] == float("inf")


def test_the_scan_tap_restores_the_wrappers_and_skips_the_cpu():
    from metrics_tpu_torch.ops import auroc_kernel
    from metrics_tpu_torch.parallel import sample_sort

    before = (auroc_kernel.tie_group_reduce, auroc_kernel.tie_group_reduce_rows, sample_sort.tie_group_reduce)
    scores, target, weights = _stream(1_000, 1)
    records = []
    with tier.scan_tap(records):
        assert auroc_kernel.tie_group_reduce is not before[0]
        auroc_kernel.masked_weighted_binary_auroc(torch.from_numpy(scores), torch.from_numpy(target),
                                                  torch.ones(1_000), torch.from_numpy(weights))
    assert records == []  # a wrapper call on CPU tensors runs the plain version: no launch
    assert (auroc_kernel.tie_group_reduce, auroc_kernel.tie_group_reduce_rows, sample_sort.tie_group_reduce) == before


# ---- the tier's float64 oracles against scikit-learn's ------------------------------------


ADVERSARIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-42, -1e-42, 0.5, -0.5, 3.4e38, -3.4e38, 1.0],
                       dtype=np.float32)


def test_the_key_is_the_jax_packages_and_the_ports_bit_for_bit():
    rng = np.random.RandomState(3)
    p = np.concatenate([ADVERSARIAL, rng.randn(4_000).astype(np.float32),
                        rng.randn(100).astype(np.float32).view(np.uint32).astype(np.float32)])
    key = tier._descending_key(p)
    assert key.dtype == np.uint32
    np.testing.assert_array_equal(key, np.asarray(jax_descending_key(jnp.asarray(p))))
    np.testing.assert_array_equal(key, port_descending_key(torch.from_numpy(p)).view(torch.int32).numpy()
                                  .view(np.uint32))
    finite = ~np.isnan(p)
    order = np.argsort(key[finite], kind="stable")
    assert np.all(np.diff(p[finite][order].astype(np.float64)) <= 0)  # ascending key, descending score


@pytest.mark.parametrize("ties", [0, 7, 1000])
def test_auroc_and_ap_oracles_equal_sklearn(ties):
    scores, target, weights = _stream(20_011, 10 + ties, ties)
    assert tier.roc_auc(target, scores) == pytest.approx(sk.roc_auc_score(target, scores), abs=1e-12)
    assert tier.roc_auc(target, scores, weights) == pytest.approx(
        sk.roc_auc_score(target, scores, sample_weight=weights), abs=1e-12)
    assert tier.average_precision(target, scores) == pytest.approx(
        sk.average_precision_score(target, scores), abs=1e-12)
    zero_one = (weights > 1).astype(np.float32)  # exact zeros among the weights
    assert tier.average_precision(target, scores, zero_one) == pytest.approx(
        sk.average_precision_score(target, scores, sample_weight=zero_one), abs=1e-12)
    assert tier.average_precision(target, scores, weights) == pytest.approx(
        sk.average_precision_score(target, scores, sample_weight=weights), abs=1e-12)


def test_mann_whitney_oracles_on_adversarial_keys_equal_sklearn():
    """The host oracles read only the key: on ±0, ±inf, subnormals and tie
    storms they equal scikit-learn's scores of the negated key."""
    rng = np.random.RandomState(4)
    p = rng.choice(ADVERSARIAL[~np.isnan(ADVERSARIAL)], size=30_000).astype(np.float32)
    p[:10_000] = (rng.randint(8, size=10_000) / 8.0).astype(np.float32)
    rel = (rng.rand(30_000) < 0.4).astype(np.int32)
    key = tier._descending_key(p)
    as_score = -key.astype(np.float64)
    assert tier.host_mw_auroc(key, rel) == pytest.approx(sk.roc_auc_score(rel, as_score), abs=1e-12)
    assert tier.host_mw_average_precision(key, rel) == pytest.approx(
        sk.average_precision_score(rel, as_score), abs=1e-12)
    assert np.isnan(tier.host_mw_auroc(key, np.ones_like(rel)))
    assert np.isnan(tier.host_mw_average_precision(key, np.zeros_like(rel)))


def test_roc_curve_oracle_equals_sklearn():
    scores, target, _ = _stream(5_003, 5, ties=100)
    fpr, tpr, thr = tier.roc_curve(target, scores)
    s_fpr, s_tpr, s_thr = sk.roc_curve(target, scores, drop_intermediate=False)
    np.testing.assert_allclose(fpr, s_fpr, rtol=0, atol=1e-15)
    np.testing.assert_allclose(tpr, s_tpr, rtol=0, atol=1e-15)
    np.testing.assert_array_equal(thr[1:], s_thr[1:])


def test_label_oracles_equal_sklearn():
    rng = np.random.RandomState(6)
    preds, target = rng.randint(6, size=40_000), rng.randint(6, size=40_000)
    assert tier.f1_macro(target, preds) == pytest.approx(sk.f1_score(target, preds, average="macro"), abs=1e-12)
    assert tier.cohen_kappa_quadratic(target, preds) == pytest.approx(
        sk.cohen_kappa_score(target, preds, weights="quadratic"), abs=1e-12)
    np.testing.assert_array_equal(tier.confusion_matrix(target, preds, 6), sk.confusion_matrix(target, preds))
    # a class absent from both sides is left out of the macro mean, as scikit-learn does
    preds[preds == 5], target[target == 5] = 4, 4
    assert tier.f1_macro(target, preds) == pytest.approx(sk.f1_score(target, preds, average="macro"), abs=1e-12)
    t = rng.randn(10_000) * 3 + 1
    p = t + rng.randn(10_000)
    assert tier.r2_score(t, p) == pytest.approx(sk.r2_score(t, p), abs=1e-12)


def test_retrieval_map_oracle_equals_sklearn():
    rng = np.random.RandomState(8)
    qi, qp = rng.randint(40, size=4_000), rng.rand(4_000).astype(np.float32)
    qt = (rng.rand(4_000) < 0.1).astype(np.int32)
    want = np.mean([sk.average_precision_score(qt[qi == q], qp[qi == q]) for q in np.unique(qi)
                    if qt[qi == q].sum()])
    assert tier.oracle_map(qi, qp, qt) == pytest.approx(want, abs=1e-12)
