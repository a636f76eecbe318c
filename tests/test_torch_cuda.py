"""Tests of the port that need a CUDA device: the tie-scan kernel against its
plain PyTorch version, and the GPU entry points against their CPU runs.

Every test here is marked ``cuda`` and skips without a card. This file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest`` because the suite's conftest pins JAX to the CPU).
"""
import numpy as np
import pytest
import torch

from metrics_tpu_torch import AUROC, Accuracy, MetricCollection
from metrics_tpu_torch.ops.auroc_kernel import (
    _co_sort,
    binary_auroc,
    binary_average_precision,
    masked_binary_auroc,
    masked_binary_average_precision,
)
from metrics_tpu_torch.ops.tie_scan import tie_group_reduce, tie_group_reduce_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tie-scan kernel has no CPU mode")
    return torch.device("cuda")


def _stream(n, seed, device, masked=False):
    rng = np.random.default_rng(seed)
    preds = torch.from_numpy(np.round(rng.random(n), 2).astype(np.float32)).to(device)
    rel = torch.from_numpy(rng.integers(0, 2, n).astype(np.float32)).to(device)
    w = torch.from_numpy((rng.random(n) < 0.8).astype(np.float32)).to(device) if masked else None
    return preds, rel, w


@pytest.mark.parametrize("n", [1, 7, 4095, 4096, 4097, 32769, 1_000_003])
def test_kernel_matches_plain_version(cuda_device, n):
    preds, rel, w = _stream(n, n, cuda_device, masked=True)
    key_s, pay_s = _co_sort(preds, rel, w)
    before = tie_group_reduce.launches
    got = tie_group_reduce(key_s, pay_s, offsets=(3.0, 4.0))
    assert tie_group_reduce.launches == before + 1
    want = tie_group_reduce_reference(key_s, pay_s, offsets=(3.0, 4.0))
    torch.cuda.synchronize()
    assert torch.equal(got[2:], want[2:])  # counts are exact
    # the same f32 terms summed in f64 in another order
    torch.testing.assert_close(got[:2], want[:2], rtol=1e-6, atol=0.0)


def test_kernel_is_deterministic(cuda_device):
    preds, rel, _ = _stream(2_000_000, 1, cuda_device)
    key_s, pay_s = _co_sort(preds, rel)
    first = tie_group_reduce(key_s, pay_s)
    for _ in range(3):
        assert torch.equal(tie_group_reduce(key_s, pay_s), first)


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    key = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        tie_group_reduce(key, torch.zeros(8, dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):
        tie_group_reduce(key, torch.zeros(8))  # payload on the CPU
    with pytest.raises(ValueError):
        tie_group_reduce(key[::2], torch.zeros(4, device=cuda_device))  # not contiguous


@pytest.mark.parametrize(
    "fn, masked",
    [(binary_auroc, False), (binary_average_precision, False),
     (masked_binary_auroc, True), (masked_binary_average_precision, True)],
)
def test_gpu_scores_match_the_cpu_path(cuda_device, fn, masked):
    preds, rel, w = _stream(300_000, 7, cuda_device, masked=masked)
    target = rel.to(torch.int64)
    args = (preds, target) if not masked else (preds, target, w.bool())
    gpu = fn(*args)
    cpu = fn(*(a.cpu() for a in args))
    assert gpu.device.type == "cuda"
    assert abs(float(gpu) - float(cpu)) < 1e-5


def test_metrics_default_to_the_card(cuda_device):
    rng = np.random.default_rng(11)
    preds = torch.from_numpy(rng.random(50_000, dtype=np.float32))
    target = torch.from_numpy((rng.random(50_000) < preds.numpy()).astype(np.int64))
    on_card = MetricCollection([Accuracy(), AUROC(pos_label=1)])
    on_cpu = MetricCollection([Accuracy(device="cpu"), AUROC(pos_label=1, device="cpu")])
    for chunk in range(5):
        sl = slice(chunk * 10_000, (chunk + 1) * 10_000)
        on_card(preds[sl], target[sl])  # CPU inputs move to the metric's device
        on_cpu(preds[sl], target[sl])
    got, want = on_card.compute(), on_cpu.compute()
    assert on_card["Accuracy"].correct.device.type == "cuda"
    assert all(t.device.type == "cuda" for t in on_card["AUROC"].preds)
    assert float(got["Accuracy"]) == float(want["Accuracy"])
    assert abs(float(got["AUROC"]) - float(want["AUROC"])) < 1e-5
