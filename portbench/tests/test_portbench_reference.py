"""The float64 reference against brute-force pair counting, with ties."""
import numpy as np
import pytest
import torch

from portbench.oracles import AUROC, Accuracy, AveragePrecision
from portbench.oracles._ranking import auroc_ap_rows, ordered_bits


def brute(scores, rel):
    pos, neg = scores[rel].astype(np.float64), scores[~rel].astype(np.float64)
    auroc = ((pos[:, None] > neg[None, :]).sum() + 0.5 * (pos[:, None] == neg[None, :]).sum()) / (pos.size * neg.size)
    ap, before = 0.0, 0
    for threshold in np.unique(scores)[::-1]:
        tp = int((rel & (scores >= threshold)).sum())
        fp = int((~rel & (scores >= threshold)).sum())
        ap += (tp - before) * tp / (tp + fp)
        before = tp
    return auroc, ap / rel.sum()


@pytest.mark.parametrize("seed", range(12))
def test_one_stream_with_ties_equals_pair_counting(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 80))
    scores = (rng.integers(-4, 6, n) / 4).astype(np.float32)
    scores[rng.random(n) < 0.15] = -0.0
    rel = rng.random(n) < 0.4
    rel[0], rel[-1] = True, False
    auroc, ap = auroc_ap_rows(torch.from_numpy(scores).reshape(1, -1), torch.from_numpy(rel).reshape(1, -1))
    want_auroc, want_ap = brute(scores, rel)
    assert auroc.dtype == torch.float64
    assert abs(auroc.item() - want_auroc) < 1e-12 and abs(ap.item() - want_ap) < 1e-12


def test_rows_in_blocks_equal_rows_one_by_one(monkeypatch):
    rng = np.random.default_rng(7)
    scores = torch.from_numpy((rng.integers(0, 30, (9, 40)) / 29).astype(np.float32))
    rel = torch.from_numpy(rng.random((9, 40)) < 0.3)
    rel[:, 0], rel[:, 1] = True, False
    whole = auroc_ap_rows(scores, rel)
    monkeypatch.setattr("portbench.oracles._ranking.ROW_ELEMENTS", 80)  # two rows a block
    blocked = auroc_ap_rows(scores, rel)
    for r in range(9):
        want = brute(scores[r].numpy(), rel[r].numpy())
        assert abs(whole[0][r].item() - want[0]) < 1e-12 and abs(whole[1][r].item() - want[1]) < 1e-12
    assert torch.equal(whole[0], blocked[0]) and torch.equal(whole[1], blocked[1])


def test_a_row_without_a_class_reads_nan():
    scores = torch.tensor([[0.1, 0.2, 0.3]])
    auroc, ap = auroc_ap_rows(scores, torch.tensor([[False, False, False]]))
    assert torch.isnan(auroc).all() and torch.isnan(ap).all()


def test_ordered_bits_follow_the_scores():
    s = torch.tensor([-float("inf"), -2.5, -1e-30, -0.0, 0.0, 1e-30, 0.5, 3.0, float("inf")])
    keys = ordered_bits(s)
    assert torch.all(keys[1:] >= keys[:-1])
    assert keys[3] == keys[4]  # -0.0 and +0.0 are one score
    assert int(keys.min()) >= 0 and int(keys.max()) < 2**32
    with pytest.raises(ValueError):
        ordered_bits(torch.tensor([float("nan")]))


def test_member_references():
    rng = np.random.default_rng(3)
    probs = torch.softmax(torch.from_numpy(rng.standard_normal((60, 4)).astype(np.float32)), 1)
    labels = torch.arange(60) % 4
    top1 = probs.argmax(1)
    assert Accuracy.reference(probs, labels, {})[0] == (top1 == labels).double().mean().item()
    per_class = AUROC.reference(probs, labels, {"num_classes": 4, "average": None})
    macro = AUROC.reference(probs, labels, {"num_classes": 4})
    assert per_class.shape == (4,) and abs(macro[0] - per_class.mean()) < 1e-15
    for c in range(4):
        want = brute(probs[:, c].numpy(), (labels == c).numpy())
        assert abs(per_class[c] - want[0]) < 1e-12
        assert abs(AveragePrecision.reference(probs, labels, {"num_classes": 4})[c] - want[1]) < 1e-12
    binary = probs[:, 0]
    clicks = (labels == 0).to(torch.int64)
    assert Accuracy.reference(binary, clicks, {})[0] == ((binary >= 0.5).long() == clicks).double().mean().item()
    want = brute(binary.numpy(), clicks.numpy() == 1)
    assert abs(AUROC.reference(binary, clicks, {"pos_label": 1})[0] - want[0]) < 1e-12
    assert abs(AveragePrecision.reference(binary, clicks, {"pos_label": 1})[0] - want[1]) < 1e-12
