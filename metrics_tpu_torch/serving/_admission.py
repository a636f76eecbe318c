"""Admission checks of the asynchronous serving path.

The port's own copy of what ``AsyncServingEngine``'s admission needs from
the JAX package's ``analysis/concurrency.py`` (its double-buffer rule):

* :func:`_host_reference_hazards` (with :func:`_bare_self_attrs`): the AST
  check over a metric class's own methods for a registered state stashed
  bare into a plain attribute, or reseeded bare from one;
* :func:`writeback_generation_monotonic`: the AST check that
  ``CompiledStepEngine.step`` reads the states it steps from
  (``_current_states``) and installs the new ones (``_write_back``) inside
  one ``with self._lock`` extent, so two steps can never install their
  generations out of order;
* :func:`first_dispatch_hazards`: the check on real tensors after the first
  batch. The JAX package traces a two-generation program and audits its
  jaxpr; the port has no jaxpr and donates no buffer, so it compares the
  storages of the states the first step installed with the engine's graph
  buffers, static inputs and captured outputs, the metrics' defaults, each
  other and the values the step returned. It reports the JAX package's
  four hazard kinds.

Nothing here imports JAX or the JAX package.
"""
import ast
import inspect
import textwrap
from typing import Any, Dict, Iterable, List, Set, Tuple

import torch

__all__ = [
    "first_dispatch_hazards",
    "writeback_generation_monotonic",
]

_WRITEBACK_CACHE: Dict[str, bool] = {}


def writeback_generation_monotonic() -> bool:
    """True iff ``CompiledStepEngine.step`` calls ``_current_states`` (the
    states generation N steps from) and ``_write_back`` (installing
    generation N+1) inside one ``with self._lock`` extent. AST-checked once
    per process against the shipped engine source."""
    if "locked" in _WRITEBACK_CACHE:
        return _WRITEBACK_CACHE["locked"]
    from metrics_tpu_torch.engine import CompiledStepEngine

    verdict = False
    try:
        tree = ast.parse(textwrap.dedent(inspect.getsource(CompiledStepEngine.step)))
    except (OSError, TypeError, SyntaxError):
        _WRITEBACK_CACHE["locked"] = False
        return False

    def _is_engine_lock(expr: ast.AST) -> bool:
        return (
            isinstance(expr, ast.Attribute)
            and expr.attr == "_lock"
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
        )

    for node in ast.walk(tree):
        if not isinstance(node, ast.With):
            continue
        if not any(_is_engine_lock(item.context_expr) for item in node.items):
            continue
        called = {n.func.attr for n in ast.walk(node) if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
        if {"_current_states", "_write_back"} <= called:
            verdict = True
            break
    _WRITEBACK_CACHE["locked"] = verdict
    return verdict


def _bare_self_attrs(value: ast.AST) -> List[str]:
    """Attribute names read as bare ``self.<attr>`` expressions at the top
    level of an assignment value (the whole value, or the elements of a
    tuple / list / dict literal). Wrapped reads (``torch.sum(self.acc)``,
    ``self.acc + 0``) make new tensors and are no reference escape."""
    out: List[str] = []
    candidates: List[ast.AST] = [value]
    if isinstance(value, (ast.Tuple, ast.List)):
        candidates = list(value.elts)
    elif isinstance(value, ast.Dict):
        candidates = [v for v in value.values if v is not None]
    for node in candidates:
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) and node.value.id == "self":
            out.append(node.attr)
    return out


def _host_reference_hazards(cls: type, state_names: Set[str]) -> List[Tuple[str, str, str, int]]:
    """``(flavor, method, attr, lineno)`` for every assignment in the metric
    class's own methods (the package's base classes excluded) that

    * ``state_ref_escape``: stashes a registered state bare into a non-state
      attribute (``self._cache = self.acc``): a host reference to a state
      the next generation replaces;
    * ``host_cached_seed``: (re)seeds a registered state bare from a
      non-state attribute (``self.acc = self._zeros``): every generation
      after it starts on the same held tensor.

    ``__init__`` is exempt: it runs before any step."""
    hazards: List[Tuple[str, str, str, int]] = []
    skip_modules = ("metrics_tpu_torch.metric", "metrics_tpu_torch.collections", "builtins")
    for klass in cls.__mro__:
        if klass.__module__ in skip_modules or klass is object:
            continue
        try:
            tree = ast.parse(textwrap.dedent(inspect.getsource(klass)))
        except (OSError, TypeError, SyntaxError):
            continue
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) or fn.name == "__init__":
                continue
            for node in ast.walk(fn):
                # plain assignments only: an AugAssign computes a new tensor
                if not isinstance(node, ast.Assign):
                    continue
                sources = _bare_self_attrs(node.value)
                if not sources:
                    continue
                for target in node.targets:
                    if not (
                        isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"
                    ):
                        continue
                    tname = target.attr
                    if tname not in state_names and any(s in state_names for s in sources):
                        hazards.append(("state_ref_escape", fn.name, tname, node.lineno))
                    elif (
                        tname in state_names
                        and any(s not in state_names and not s.startswith("_defaults") for s in sources)
                        and not any(s in state_names for s in sources)
                    ):
                        hazards.append(("host_cached_seed", fn.name, tname, node.lineno))
    return hazards


def _storage(t: Any) -> Any:
    """The storage address of a non-empty tensor, else None."""
    if isinstance(t, torch.Tensor) and t.numel():
        return t.untyped_storage().data_ptr()
    return None


def tensor_leaves(tree: Any) -> Iterable[torch.Tensor]:
    """Every tensor in a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensor_leaves(v)


def engine_owned(engine: Any) -> Set[int]:
    """Storages the step engine owns and writes on a later step: its state
    buffers and every graph's static inputs, state buffers and captured
    outputs."""
    owned = {_storage(b) for b in engine._state_buffers.values()}
    for program in list(engine._compiled.values()):
        if program is not None:
            owned |= {_storage(t) for t in tensor_leaves((program.inputs, program.states, program.outputs))}
    owned.discard(None)
    return owned


def first_dispatch_hazards(
    states: List[Tuple[str, torch.Tensor]], owned: Set[int], defaults: Set[int], values: Any
) -> List[Dict[str, Any]]:
    """Hazards after the first step, on real tensors: each installed state
    must own its storage (no engine buffer: ``donated_passthrough``; no
    default: ``const_state_output``; no other state:
    ``duplicate_state_output``), and no value the step returned may share
    storage with a state or an engine buffer (``cross_generation_alias``).
    An empty list: the next generation cannot write what this one holds."""
    hazards: List[Dict[str, Any]] = []
    seen: Dict[int, str] = {}
    for pos, (name, t) in enumerate(states):
        ptr = _storage(t)
        if ptr is None:
            continue
        if ptr in defaults:
            hazards.append({"kind": "const_state_output", "position": pos, "state": name})
            continue
        if ptr in owned:
            hazards.append({"kind": "donated_passthrough", "position": pos, "state": name})
        if ptr in seen:
            hazards.append({"kind": "duplicate_state_output", "position": pos, "state": name, "shares": seen[ptr]})
        seen.setdefault(ptr, name)
    for off, t in enumerate(tensor_leaves(values)):
        ptr = _storage(t)
        if ptr is not None and (ptr in seen or ptr in owned):
            hazards.append({"kind": "cross_generation_alias", "position": len(states) + off, "state": seen.get(ptr)})
    return hazards
