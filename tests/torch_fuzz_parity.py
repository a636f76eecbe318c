"""Randomized differential fuzz: the port against the JAX package.

The parity tests hold the port against the JAX package at the seeds and
shapes they chose. This drives every domain of the JAX package's own fuzz
(``scripts/fuzz_parity.py``: ``DOMAINS``, 34 exported functionals, and
``MODULE_DOMAINS``, 30 stateful classes) through both packages on the same
numpy inputs, drawn by that file's generators, and compares values *and*
acceptance: both must accept or reject the same call, constructor, batch,
pickle and ``compute``. The JAX package is the reference (on the CPU); the
port runs on ``--device``. Tolerances are the JAX file's ``atol``.

The module layer keeps that file's ``_run_module_trial`` protocol: two
rounds of one to three batches through ``forward`` (``update`` for the
arithmetic domain), a pickle round trip at batch 1 half the time, an epoch
``compute`` and a ``reset`` between the rounds.

A difference that ``ROADMAP.md`` records as deliberate (Queue 3 item 4), or
as a fault of the JAX package (item 5), is counted as carved out, never as
a match, and only through a named predicate of :data:`CARVE_OUTS` that
matches the inputs the difference concerns. Everything else that differs is
a mismatch.

Usage (from the repo root; it imports JAX, so it runs where JAX is)::

    python -m tests.torch_fuzz_parity --trials 1000 [--seed 0] [--device cpu]

Prints one line per mismatch and, last, ``torch_fuzz_parity: <n> trials,
<m> matched, <r> rejected-by-both, <c> carved-out, <k> MISMATCHES``; exits 0
only when k is 0.
"""
import argparse
import functools
import inspect
import os
import pickle
import sys
from collections import Counter
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np

_SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
if _SCRIPTS not in sys.path:
    sys.path.insert(0, _SCRIPTS)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# the generators, builders and comparison the repo fuzzes its own package with
from fuzz_parity import DOMAINS, MODULE_DOMAINS, _compare, _default_builder  # noqa: E402

import metrics_tpu as J  # noqa: E402
import metrics_tpu.functional as JF  # noqa: E402
import metrics_tpu_torch as P  # noqa: E402
import metrics_tpu_torch.functional as PF  # noqa: E402


class CarveOut(NamedTuple):
    """A recorded difference: ``applies(layer, name, kwargs, inputs)`` is
    true only for the inputs it concerns; ``cites`` names its line of
    ``ROADMAP.md``."""

    applies: Callable[[str, str, Dict[str, Any], Tuple[Any, ...]], bool]
    cites: str


CARVE_OUTS: Dict[str, CarveOut] = {}


# ---- the port's side -------------------------------------------------------------


class _PortNamespace:
    """The port's classes, each ``Metric`` built on ``device``; every other
    name as the package exports it."""

    def __init__(self, device: torch.device):
        self.device = device

    def __getattr__(self, name: str):
        obj = getattr(P, name)
        if isinstance(obj, type) and issubclass(obj, P.Metric):
            return functools.partial(obj, device=self.device)
        return obj


def _to_port(a, device: torch.device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _host(x):
    """A port result as numpy, structure kept (tuples, lists, dicts)."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return x


def _call(fn, args, kwargs):
    try:
        return fn(*args, **kwargs), None
    except Exception as err:  # noqa: BLE001 — acceptance parity needs every failure
        return None, err


def _carved(layer: str, name: str, kwargs: Dict[str, Any], inputs: Tuple[Any, ...]) -> Optional[str]:
    for key, carve in CARVE_OUTS.items():
        if carve.applies(layer, name, kwargs, inputs):
            return key
    return None


# ---- one trial of each layer ----------------------------------------------------------


def run_function_trial(name: str, rng: np.random.RandomState, device: torch.device) -> Tuple[str, Optional[str]]:
    """One functional trial: ``("match" | "reject" | "carved:<key>" |
    "mismatch", detail or None)``."""
    gen, atol, tensorize = DOMAINS[name]
    call_args, kwargs = gen(rng)
    if tensorize:
        jax_args = tuple(jnp.asarray(a) for a in call_args)
        port_args = tuple(_to_port(a, device) for a in call_args)
    else:
        jax_args = port_args = call_args
    port_fn = getattr(PF, name)
    port_kwargs = dict(kwargs)
    if "device" in inspect.signature(port_fn).parameters:
        port_kwargs["device"] = device  # list inputs carry no device
    want, jax_err = _call(getattr(JF, name), jax_args, kwargs)
    got, port_err = _call(port_fn, port_args, port_kwargs)
    shapes = [np.asarray(a).shape for a in call_args] if tensorize else "-"
    if (jax_err is None) != (port_err is None):
        detail = f"acceptance kwargs={kwargs} shapes={shapes} port={port_err!r} jax={jax_err!r}"
    elif jax_err is not None:
        return "reject", None
    else:
        err = _compare(_host(got), want, atol)
        if not err:
            return "match", None
        detail = f"value kwargs={kwargs} shapes={shapes}: {err}"
    key = _carved("fn", name, kwargs, call_args)
    return (f"carved:{key}", detail) if key else ("mismatch", detail)


def run_module_trial(name: str, rng: np.random.RandomState, device: torch.device) -> Tuple[str, Optional[str]]:
    """One stateful trial under ``scripts/fuzz_parity.py::_run_module_trial``'s
    protocol and random draws, with the JAX package as the reference."""
    entry = MODULE_DOMAINS[name]
    gen, atol = entry[0], entry[1]
    builder = entry[2] if len(entry) > 2 else _default_builder
    drive = entry[3] if len(entry) > 3 else "forward"
    ctor_kwargs, batch_gen = gen(rng)
    seen = []

    def verdict(detail):
        key = _carved("mod", name, ctor_kwargs, tuple(seen))
        return (f"carved:{key}", detail) if key else ("mismatch", detail)

    jax_m, jax_err = _call(builder, (J, name, ctor_kwargs), {})
    port_m, port_err = _call(builder, (_PortNamespace(device), name, ctor_kwargs), {})
    if (jax_err is None) != (port_err is None):
        return verdict(f"ctor acceptance: port={port_err!r} jax={jax_err!r} kwargs={ctor_kwargs}")
    if jax_err is not None:
        return "reject", None

    for round_ in range(2):  # the second round exercises reset()
        n_batches = int(rng.randint(1, 4))
        batches = [batch_gen(rng) for _ in range(n_batches)]
        for bi, b in enumerate(batches):
            seen.append(b)
            if bi == 1 and rng.rand() < 0.5:
                # a pickle round trip mid-accumulation; the remaining batches
                # and computes run on the clones
                jax_m2, jax_err = _call(lambda m: pickle.loads(pickle.dumps(m)), (jax_m,), {})
                port_m2, port_err = _call(lambda m: pickle.loads(pickle.dumps(m)), (port_m,), {})
                if (jax_err is None) != (port_err is None):
                    return verdict(f"pickle acceptance r{round_}: port={port_err!r} jax={jax_err!r}"
                                   f" kwargs={ctor_kwargs}")
                if jax_err is not None:
                    return "reject", None
                jax_m, port_m = jax_m2, port_m2
            jax_call = jax_m.update if drive == "update" else jax_m
            port_call = port_m.update if drive == "update" else port_m
            want, jax_err = _call(jax_call, [jnp.asarray(a) for a in b], {})
            got, port_err = _call(port_call, [_to_port(a, device) for a in b], {})
            if (jax_err is None) != (port_err is None):
                return verdict(f"forward acceptance r{round_} b{bi}: port={port_err!r} jax={jax_err!r}"
                               f" kwargs={ctor_kwargs}")
            if jax_err is not None:
                return "reject", None  # rejected alike; the states are unusable
            if drive == "update":
                continue  # update() returns no step value
            err = _compare(_host(got), want, atol)
            if err:
                return verdict(f"forward value r{round_} b{bi} kwargs={ctor_kwargs}: {err}")
        want, jax_err = _call(jax_m.compute, (), {})
        got, port_err = _call(port_m.compute, (), {})
        if (jax_err is None) != (port_err is None):
            return verdict(f"compute acceptance r{round_}: port={port_err!r} jax={jax_err!r} kwargs={ctor_kwargs}")
        if jax_err is None:
            err = _compare(_host(got), want, atol)
            if err:
                return verdict(f"epoch compute r{round_} kwargs={ctor_kwargs}: {err}")
        jax_m.reset()
        port_m.reset()
    return "match", None


def run_trials(trials: int, seed: int, device: torch.device, names, log=print) -> Counter:
    """``trials`` draws over ``names`` (``[(layer, name), ...]``), in the
    JAX file's order of random draws; returns the outcome counts (``match``,
    ``reject``, ``carved``, ``mismatch``, and ``carved:<key>`` per entry)."""
    rng = np.random.RandomState(seed)
    counts = Counter()
    for trial in range(trials):
        layer, name = names[rng.randint(len(names))]
        seedhead = rng.get_state()[1][:2]
        run = run_module_trial if layer == "mod" else run_function_trial
        status, detail = run(name, rng, device)
        if status.startswith("carved:"):
            counts["carved"] += 1
        counts[status] += 1
        if status == "mismatch":
            log(f"MISMATCH {layer} {name} trial={trial} seedhead={seedhead}: {detail}")
    return counts


def domain_names(layer: str = "all", domain: Optional[str] = None):
    fn = sorted(DOMAINS) if layer in ("functional", "all") else []
    mod = sorted(MODULE_DOMAINS) if layer in ("module", "all") else []
    names = [("fn", n) for n in fn] + [("mod", n) for n in mod]
    return [(lay, n) for lay, n in names if domain is None or n == domain]


def summary(trials: int, counts: Counter) -> str:
    return (f"torch_fuzz_parity: {trials} trials, {counts['match']} matched, {counts['reject']} rejected-by-both,"
            f" {counts['carved']} carved-out, {counts['mismatch']} MISMATCHES")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu", help="the port's device (the JAX package runs on the CPU)")
    ap.add_argument("--domain", default=None, help="restrict to one metric")
    ap.add_argument("--layer", choices=["functional", "module", "all"], default="all")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_fuzz_parity: --device cuda needs a CUDA device")
    names = domain_names(args.layer, args.domain)
    if not names:
        print(f"no domain matches {args.domain!r}")
        return 2
    counts = run_trials(args.trials, args.seed, device, names)
    for key in sorted(k for k in counts if k.startswith("carved:")):
        print(f"{key}: {counts[key]} ({CARVE_OUTS[key.split(':', 1)[1]].cites})")
    print(summary(args.trials, counts))
    return 1 if counts["mismatch"] else 0


if __name__ == "__main__":
    sys.exit(main())
