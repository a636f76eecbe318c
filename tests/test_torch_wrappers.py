"""The port's wrappers and functional extras against the JAX package, on
the CPU: ``BootStrapper`` (both packages' ``_bootstrap_sampler`` patched to
the same seeded indices, so the replicas see the same resamplings; then the
port's own sampler: counts, range, the all-zero fallback, determinism for a
generator; pickling, checkpoints and ``state_from_jax`` of JAX replicas),
``bleu_score`` (with and without smoothing, a brevity-penalty case),
``image_gradients`` (exact, and the error texts), ``embedding_similarity``
(the six ``similarity`` x ``reduction`` forms) and ``utilities/imports.py``.

Tolerances: bootstrap statistics, BLEU and similarities within 1e-6
(float32 arithmetic of the same terms in another order); gradients exact.
"""
import importlib
import operator
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.functional as jf
import metrics_tpu_torch as tm
import metrics_tpu_torch.functional as tf
from metrics_tpu.utilities import imports as jax_imports
from metrics_tpu_torch.interop import state_from_jax
from metrics_tpu_torch.utilities import imports as port_imports

jax_boot = importlib.import_module("metrics_tpu.wrappers.bootstrapping")
port_boot = importlib.import_module("metrics_tpu_torch.wrappers.bootstrapping")

CPU = "cpu"
TOL = 1e-6


def _close(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL, err_msg=msg)


def _seeded_indices(strategy, size, count, seed):
    """``count`` index arrays as the JAX sampler draws them (with an all-zero
    Poisson draw among them, which falls back to one index)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(count):
        if strategy == "multinomial":
            out.append(rng.randint(0, size, size=size))
        else:
            n = np.zeros(size, np.int64) if i == 3 else rng.poisson(1.0, size=size)
            idx = np.repeat(np.arange(size), n)
            out.append(idx if idx.size else rng.randint(0, size, size=1))
    return out


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
def test_bootstrapper_matches_jax_on_the_same_resamplings(monkeypatch, strategy):
    """Both packages' samplers patched to one seeded sequence of indices:
    every forward's values and the epoch's mean, std, quantile and raw
    agree within 1e-6."""
    n, replicas, batches = 64, 20, 3
    # forward updates twice (accumulate, then the batch alone): 2 draws per replica per batch
    indices = _seeded_indices(strategy, n, 2 * replicas * batches, seed=7)
    jax_queue, port_queue = list(indices), list(indices)

    def jax_sampler(size, sampling_strategy="poisson"):
        assert size == n and sampling_strategy == strategy
        return jnp.asarray(jax_queue.pop(0).astype(np.int32))

    def port_sampler(size, sampling_strategy="poisson", num_samples=1, generator=None, device=None):
        assert size == n and sampling_strategy == strategy and num_samples == replicas
        return [torch.from_numpy(port_queue.pop(0)) for _ in range(num_samples)]

    monkeypatch.setattr(jax_boot, "_bootstrap_sampler", jax_sampler)
    monkeypatch.setattr(port_boot, "_bootstrap_sampler", port_sampler)
    kwargs = dict(num_bootstraps=replicas, quantile=0.9, raw=True, sampling_strategy=strategy)
    jb = jax_boot.BootStrapper(jm.Accuracy(), **kwargs)
    pb = tm.BootStrapper(tm.Accuracy(device=CPU), **kwargs)
    rng = np.random.RandomState(8)
    for _ in range(batches):
        p, t = rng.randint(5, size=n), rng.randint(5, size=n)
        got, want = pb(torch.from_numpy(p), torch.from_numpy(t)), jb(jnp.asarray(p), jnp.asarray(t))
        assert sorted(got) == sorted(want) == ["mean", "quantile", "raw", "std"]
        for k in want:
            _close(got[k], want[k], f"forward {k}")
    assert not jax_queue and not port_queue
    got, want = pb.compute(), jb.compute()
    for k in want:
        _close(got[k], want[k], f"epoch {k}")


def test_bootstrap_sampler_counts_range_fallback_and_determinism(monkeypatch):
    gen = torch.Generator().manual_seed(3)
    for idx in port_boot._bootstrap_sampler(50, "multinomial", 4, gen):
        assert idx.shape == (50,) and idx.dtype == torch.int64
        assert 0 <= int(idx.min()) and int(idx.max()) < 50
    poisson = port_boot._bootstrap_sampler(10_000, "poisson", 3, gen)
    for idx in poisson:
        # each sample repeated n ~ Poisson(1) times, in order: about N in all
        assert 9_000 < idx.numel() < 11_000 and bool(torch.all(idx[1:] >= idx[:-1]))
    # the same generator state gives the same indices
    a = port_boot._bootstrap_sampler(100, "poisson", 2, torch.Generator().manual_seed(5))
    b = port_boot._bootstrap_sampler(100, "poisson", 2, torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # an all-zero draw falls back to one uniform index
    monkeypatch.setattr(torch, "poisson", lambda x, generator=None: torch.zeros_like(x))
    fallback = port_boot._bootstrap_sampler(7, "poisson", 2, gen)
    assert [idx.numel() for idx in fallback] == [1, 1] and all(0 <= int(i) < 7 for i in fallback)
    with pytest.raises(ValueError, match="Unknown sampling strategy"):
        port_boot._bootstrap_sampler(7, "bogus")


def test_bootstrapper_errors_checkpoints_and_pickle():
    with pytest.raises(ValueError, match="Expected base metric to be an instance"):
        tm.BootStrapper(object())
    with pytest.raises(ValueError, match="Expected argument ``sampling_strategy``"):
        tm.BootStrapper(tm.Accuracy(device=CPU), sampling_strategy="bogus")
    with pytest.raises(ValueError, match="None of the input contained tensors"):
        tm.BootStrapper(tm.Accuracy(device=CPU)).update([0, 1], [1, 1])
    boot = tm.BootStrapper(tm.Accuracy(device=CPU), num_bootstraps=5, raw=True,
                           generator=torch.Generator().manual_seed(11))
    p, t = torch.randint(3, (40,)), torch.randint(3, (40,))
    boot.update(p, t)
    copy = pickle.loads(pickle.dumps(boot))
    boot.update(p, t)
    copy.update(p, t)  # the generator's state travelled with the pickle
    assert torch.equal(copy.compute()["raw"], boot.compute()["raw"])
    boot.persistent(True)
    state = boot.state_dict()
    assert sorted(state)[:2] == ["metrics.0.correct", "metrics.0.total"] and len(state) == 10
    fresh = tm.BootStrapper(tm.Accuracy(device=CPU), num_bootstraps=5, raw=True)
    fresh.load_state_dict(state)
    assert torch.equal(fresh.compute()["raw"], boot.compute()["raw"])
    boot.reset()
    assert all(float(m.total) == 0 for m in boot.metrics)


def test_state_from_jax_carries_bootstrapper_replicas():
    """A JAX BootStrapper's replicas, one numpy state dict each, load into
    the port's BootStrapper: the same raw values."""
    jb = jax_boot.BootStrapper(jm.Accuracy(), num_bootstraps=6, raw=True)
    rng = np.random.RandomState(12)
    for _ in range(2):
        jb.update(jnp.asarray(rng.randint(4, size=30)), jnp.asarray(rng.randint(4, size=30)))
    replicas = []
    for m in jb.metrics:
        m.persistent(True)
        replicas.append({k: np.asarray(v) for k, v in m.state_dict().items()})
    pb = tm.BootStrapper(tm.Accuracy(device=CPU), num_bootstraps=6, raw=True)
    pb.load_state_dict(state_from_jax(replicas), strict=True)
    got, want = pb.compute(), jb.compute()
    for k in want:
        _close(got[k], want[k], k)


TRANSLATIONS = [
    "the cat is on the mat".split(),
    "it is a guide to action which ensures that the military always obeys the commands of the party".split(),
    "he read the book because he was interested in world history".split(),
]
REFERENCES = [
    ["there is a cat on the mat".split(), "a cat is on the mat".split()],
    ["it is a guide to action that ensures that the military will forever heed party commands".split(),
     "it is the guiding principle which guarantees the military forces always being under the command of the"
     " party".split()],
    ["he was interested in world history because he read the book".split()],
]


@pytest.mark.parametrize("n_gram", [1, 2, 3, 4])
@pytest.mark.parametrize("smooth", [False, True])
def test_bleu_score_matches_jax(n_gram, smooth):
    got = tf.bleu_score(TRANSLATIONS, REFERENCES, n_gram=n_gram, smooth=smooth, device=CPU)
    want = jf.bleu_score(TRANSLATIONS, REFERENCES, n_gram=n_gram, smooth=smooth)
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want)


def test_bleu_score_brevity_penalty_and_zero_precision():
    short = [["the", "cat"]]
    refs = [["the cat is on the mat".split()]]
    for smooth in (False, True):
        got = tf.bleu_score(short, refs, n_gram=2, smooth=smooth, device=CPU)
        _close(got, jf.bleu_score(short, refs, n_gram=2, smooth=smooth))
        assert 0 < float(got) < 1  # the brevity penalty e^(1 - r/c)
    # no 4-gram in common: 0 without smoothing
    assert float(tf.bleu_score(short, refs, device=CPU)) == float(jf.bleu_score(short, refs)) == 0.0
    with pytest.raises(RuntimeError, match="pass device='cpu'") if not torch.cuda.is_available() else _no_error():
        tf.bleu_score(short, refs)


class _no_error:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("shape", [(1, 1, 5, 5), (2, 3, 7, 11), (4, 1, 1, 6)])
def test_image_gradients_match_jax_exactly(shape):
    img = np.random.RandomState(13).standard_normal(shape).astype(np.float32)
    dy, dx = tf.image_gradients(torch.from_numpy(img))
    jdy, jdx = jf.image_gradients(jnp.asarray(img))
    assert np.array_equal(dy.numpy(), np.asarray(jdy)) and np.array_equal(dx.numpy(), np.asarray(jdx))


def test_image_gradients_errors():
    with pytest.raises(TypeError, match="The `img` expects a value of <torch.Tensor> type"):
        tf.image_gradients(np.zeros((1, 1, 2, 2)))
    with pytest.raises(RuntimeError, match="The `img` expects a 4D tensor but got 3D tensor"):
        tf.image_gradients(torch.zeros(1, 2, 2))


@pytest.mark.parametrize("similarity", ["cosine", "dot"])
@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_embedding_similarity_matches_jax(similarity, reduction):
    batch = np.random.RandomState(14).standard_normal((48, 16)).astype(np.float32)
    for zero_diagonal in (True, False):
        got = tf.embedding_similarity(torch.from_numpy(batch), similarity, reduction, zero_diagonal)
        want = jf.embedding_similarity(jnp.asarray(batch), similarity, reduction, zero_diagonal)
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL * 16)


def test_embedding_similarity_restores_the_callers_precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        tf.embedding_similarity(torch.ones(3, 2))
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("name", ["os", "numpy", "bla.bla", "numpy.linalg", "no_such_package"])
def test_module_available_matches_jax(name):
    assert port_imports._module_available(name) == jax_imports._module_available(name)


@pytest.mark.parametrize("version,want", [("1.26.4", (1, 26, 4)), ("0.4.30", (0, 4, 30)), ("2.0", (2, 0)),
                                          ("2.11.0+cu128", (2, 11, 0)), ("1.2.0rc3", (1, 2, 0)), ("1.2.rc3", (1, 2))])
def test_version_tuple(version, want):
    assert port_imports._version_tuple(version) == want
    if version.replace(".", "").isdigit():
        # the JAX helper agrees on plain versions; it reads the digits of a
        # suffix ("+cu128", "rc3") into the number
        assert jax_imports._version_tuple(version) == want


@pytest.mark.parametrize("op,version", [(operator.ge, "1.0"), (operator.lt, "99.0"), (operator.ge, "99.0")])
def test_compare_version_matches_jax(op, version):
    assert port_imports._compare_version("numpy", op, version) == jax_imports._compare_version("numpy", op, version)
    assert port_imports._compare_version("no_such_package", op, version) is False
    assert port_imports._compare_version("torch", operator.ge, "1.0") is True
    assert port_imports._TORCH_AVAILABLE and port_imports._cuda_available() == torch.cuda.is_available()


def test_bootstrapper_runs_eager_under_the_engine():
    """The wrapper registers no state (its replicas hold it): the step
    engine keeps it eager with JAX's reason, and its values are the eager
    wrapper's."""
    gens = [torch.Generator().manual_seed(17) for _ in range(2)]
    eager = tm.BootStrapper(tm.Accuracy(device=CPU), num_bootstraps=4, raw=True, generator=gens[0])
    boot = tm.BootStrapper(tm.Accuracy(device=CPU), num_bootstraps=4, raw=True, generator=gens[1])
    engine, jengine = tm.CompiledStepEngine(boot), jm.CompiledStepEngine(jax_boot.BootStrapper(jm.Accuracy()))
    assert engine.eager_fallbacks == jengine.eager_fallbacks
    assert list(engine.eager_fallbacks) == ["metric"]
    p, t = torch.randint(3, (50,)), torch.randint(3, (50,))
    for _ in range(2):
        got, want = engine(p, t), eager(p, t)
        assert torch.equal(got["raw"], want["raw"])
    assert engine.trace_count == 0
