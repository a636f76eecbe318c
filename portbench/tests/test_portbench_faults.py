"""A run whose timed path is broken underneath comes out not correct: the
harness runs as on the card, past its look for one, over tiny cells on the
CPU, with each fault a cell can have planted in the port."""
import pytest

import metrics_tpu_torch
from metrics_tpu_torch.ops import auroc_kernel
from portbench.tests.tiny import CELLS, run_tiny

SEED = 2**32 + 101


def _state_unchanged(monkeypatch):
    """Every update returns the state as it was."""
    monkeypatch.setattr(metrics_tpu_torch.MetricCollection, "update", lambda self, *args, **kwargs: None)


def _half_batch(monkeypatch):
    """Half of each batch is left out: the values are the mean over the rest."""
    update = metrics_tpu_torch.MetricCollection.update

    def half(self, preds, target, **kwargs):
        keep = max(1, preds.shape[0] // 2)
        return update(self, preds[:keep], target[:keep], **kwargs)

    monkeypatch.setattr(metrics_tpu_torch.MetricCollection, "update", half)


def _answer_altered(monkeypatch):
    """AUROC is altered where the scan's sums become it."""
    scores = auroc_kernel._scores

    def altered(*args, **kwargs):
        auroc, ap = scores(*args, **kwargs)
        return auroc + 1e-3, ap

    monkeypatch.setattr(auroc_kernel, "_scores", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch, "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = run_tiny(workload, SEED, 0.2, False)
    assert result["correct"] is False
    assert result["failed"] > 0
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_the_same_run_without_a_fault_is_correct(workload):
    result = run_tiny(workload, SEED, 0.2, False)
    assert result["correct"] is True and result["failed"] == 0
