"""Pass 5 — numerical-soundness prover: overflow horizons, cancellation
detection, and a committed per-family error-budget baseline.

Port of ``metrics_tpu/analysis/numerics.py``. Passes 1–4 prove properties
of one *step*: its program shape, its cross-replica merge, its buffer
lifetimes. A serving process runs millions of rows over its lifetime, which
makes *state lifetime* the numerical hazard nothing per-step can see: an
int32 row counter that is fine in a unit test saturates after 2³¹ rows, an
f32 running sum silently stops absorbing increments after enough traffic,
and an E[x²]−E[x]² compute loses every significant digit the moment the
data is mean-shifted. This pass makes each of those a measured, committed,
CI-gated number:

* **MTA010 — overflow/saturation horizon.** Interval arithmetic over the
  family's traced update program (an FX graph from ``make_fx`` over fake
  tensors, :func:`eval_jaxpr_intervals`; nested graphs of ``torch.cond``
  are walked and their branches joined), given the family's *declared
  per-batch input domains*, yields a per-state max per-step increment — and
  therefore a per-state horizon in ROWS: steps-until-int-overflow for
  integer accumulators, steps-until-ulp-absorption for float ones (the
  point after which ``acc + x == acc`` even for the family's largest
  per-step contribution, ``2^(mantissa+1)`` steps at the declared serving
  batch shape). Horizons below the fleet floor (default 2⁴⁰ rows) flag;
  every horizon is recorded in the committed ``NUMERICS_BASELINE.json`` so
  a dtype narrowing is a *gated regression* even when it stays above the
  floor. The graphs are not functionalized: an in-place write (``index_add_``
  into a ``zeros`` buffer) rebinds the written interval to the buffer's
  storage root (``program._storage_root``), so a later read of the buffer,
  or of a view of it, sees what was written, not the buffer's default.
* **MTA011 — catastrophic cancellation.** Structural leg: a taint walk over
  the compute graph marks every value descended from an accumulated
  (sum/mean-reduced) state and flags subtraction of two accumulated-
  descended values (``sub``, ``rsub``, ``add`` with ``alpha=-1``, or an
  ``add`` of a negated value) — the E[x²]−E[x]² shape the shared regression
  sufficient-stats deliberately risk. Measured leg: every family's
  update→compute composite is evaluated on adversarial ill-conditioned
  probes (mean-shifted data at 1e6 scale, 1e−6 spreads) against a float64
  oracle fed the *identical f32-cast inputs*, and the observed relative
  error is committed per family to the baseline. The oracle leg starts from
  float64 copies of the float states (PyTorch keeps a 1-dim f32 state f32
  when a 0-dim f64 value is added to it) and must return float64 leaves,
  or it raises; probes that raise are named in the evidence.
* **MTA012 — scale/shift-equivariance probe.** Concrete metamorphic check
  against the declared equivariance class: scale-invariant metrics (AUROC,
  average precision, retrieval ranks, R²) must be BIT-stable under
  power-of-two input rescaling (×2, ×2⁻¹⁰ — exact in IEEE floats, so any
  drift is a hidden absolute-epsilon threshold or premature rounding);
  scale-equivariant ones (MSE ×s², MAE ×s) must transform exactly.

The concrete probes (the budget's legs, the equivariance runs) and the
compute trace run with the metrics' telemetry hooks muted: an analysis
probe is no step.

The committed baseline is the repo root's ``NUMERICS_BASELINE.json``, read
unchanged: entries are name-keyed with a recorded state inventory (a
different configuration of the same class is measured, not gated).
:func:`tighten_baseline` merges improvements only (horizons up, budgets
down) and writes nothing; fixture entries named in ``"fixtures"`` keep
their deliberately-tight values.
"""
import json
import math
import os
import threading
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from metrics_tpu_torch.analysis.program import (
    _aliases_first_arg,
    _dtype_name,
    _np,
    _outputs,
    _placeholders,
    _storage_root,
    _tensor_leaves,
)
from metrics_tpu_torch.analysis.rules import Finding
from metrics_tpu_torch.utilities.data import (
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
)

__all__ = [
    "DEFAULT_FLEET_FLOOR_ROWS",
    "DEFAULT_SERVING_ROWS_PER_STEP",
    "EQUIVARIANCE",
    "FAMILY_DOMAINS",
    "Interval",
    "NUMERICS_BASELINE_FILENAME",
    "build_numerics_entry",
    "cancellation_sites",
    "check_numerics",
    "equivariance_verdict",
    "eval_jaxpr_intervals",
    "load_numerics_baseline",
    "measure_error_budget",
    "min_horizon_rows",
    "state_horizons",
]

#: the fleet-scale horizon floor, in rows: any state whose horizon is below
#: this is reachable within a serving process lifetime and flags MTA010
DEFAULT_FLEET_FLOOR_ROWS = 2 ** 40

#: the declared serving batch shape, in rows per dispatched step. Float
#: ulp-absorption horizons scale linearly with it: batch-summed accumulation
#: absorbs whole-step contributions, so a bigger batch pushes absorption out
#: proportionally (f32 at 2^20 rows/step absorbs at 2^44 rows; the same
#: state fed row-at-a-time dies at 2^24)
DEFAULT_SERVING_ROWS_PER_STEP = 2 ** 20

#: cap on the committed relative-error budget: 1.0 means "all significant
#: digits lost" — beyond that, magnitudes are platform noise
ERROR_BUDGET_CAP = 1.0

#: the committed per-family numerics baseline at the repo root (next to
#: SEAM_BASELINE.json)
NUMERICS_BASELINE_FILENAME = "NUMERICS_BASELINE.json"

_INF = float("inf")


# ---------------------------------------------------------------------------
# interval arithmetic
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Interval:
    """A closed scalar interval ``[lo, hi]`` abstracting every element of a
    tensor. ``TOP`` (``[-inf, inf]``) is the unknown-value element."""

    lo: float
    hi: float

    def __post_init__(self):
        if self.lo > self.hi:  # normalize inverted constructions
            lo, hi = self.hi, self.lo
            object.__setattr__(self, "lo", lo)
            object.__setattr__(self, "hi", hi)

    @property
    def is_top(self) -> bool:
        return self.lo == -_INF and self.hi == _INF

    def union(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))


TOP = Interval(-_INF, _INF)
_BOOL = Interval(0.0, 1.0)


def _iv_add(a: Interval, b: Interval) -> Interval:
    return Interval(a.lo + b.lo, a.hi + b.hi)


def _iv_sub(a: Interval, b: Interval) -> Interval:
    return Interval(a.lo - b.hi, a.hi - b.lo)


def _iv_mul(a: Interval, b: Interval) -> Interval:
    prods = []
    for x in (a.lo, a.hi):
        for y in (b.lo, b.hi):
            p = x * y
            # 0 * inf is nan under IEEE; the product of a zero bound and an
            # unbounded one is bounded by the OTHER corner products
            prods.append(0.0 if math.isnan(p) else p)
    return Interval(min(prods), max(prods))


def _iv_div(a: Interval, b: Interval) -> Interval:
    if b.lo <= 0.0 <= b.hi:
        return TOP  # divisor interval spans zero: unbounded quotient
    recips = Interval(1.0 / b.hi, 1.0 / b.lo)
    return _iv_mul(a, recips)


def _iv_neg(a: Interval) -> Interval:
    return Interval(-a.hi, -a.lo)


def _iv_abs(a: Interval) -> Interval:
    if a.lo >= 0:
        return a
    if a.hi <= 0:
        return _iv_neg(a)
    return Interval(0.0, max(-a.lo, a.hi))


def _mono(fn: Callable[[float], float]) -> Callable[[Interval], Interval]:
    """Lift a monotone-increasing scalar function to intervals; domain
    errors at a bound widen that side to ±inf rather than crash."""

    def apply(a: Interval) -> Interval:
        def at(x: float, side: float) -> float:
            try:
                v = fn(x)
            except (ValueError, OverflowError):
                return side
            return side if math.isnan(v) else v

        return Interval(at(a.lo, -_INF), at(a.hi, _INF))

    return apply


_IV_LOG = _mono(math.log)
_IV_LOG1P = _mono(math.log1p)
_IV_EXP = _mono(math.exp)
_IV_SQRT = _mono(lambda x: math.sqrt(x) if x >= 0 else float("nan"))
_IV_TANH = _mono(math.tanh)


def _iv_int_pow(a: Interval, y: int) -> Interval:
    if y == 0:
        return Interval(1.0, 1.0)
    if y < 0:
        return _iv_div(Interval(1.0, 1.0), _iv_int_pow(a, -y))
    out = a
    for _ in range(y - 1):
        out = _iv_mul(out, a)
    if y % 2 == 0:
        out = _iv_abs(out)  # even powers are nonnegative; tighten
        out = Interval(0.0 if a.lo <= 0 <= a.hi else out.lo, out.hi)
    return out


def _const_interval(value: Any) -> Interval:
    """The interval of a concrete value: a tensor (any device), an array or
    a Python number."""
    arr = _np(value) if isinstance(value, torch.Tensor) else np.asarray(value)
    if arr.size == 0:
        return Interval(0.0, 0.0)
    if arr.dtype == bool:
        return _BOOL
    try:
        return Interval(float(arr.min()), float(arr.max()))
    except (TypeError, ValueError):
        return TOP


# ---------------------------------------------------------------------------
# interval evaluation over FX graphs
# ---------------------------------------------------------------------------
#: ops whose output holds only values of their first operand (views,
#: copies, casts, gathers, layout changes)
_PASSTHROUGH = frozenset((
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t", "squeeze", "unsqueeze",
    "slice", "select", "index_select", "gather", "index", "clone", "contiguous", "alias", "detach",
    "lift_fresh_copy", "_to_copy", "flip", "diagonal", "repeat", "as_strided", "split", "split_with_sizes",
    "unbind",
))
#: ops whose output is a truth value
_PREDICATES = frozenset((
    "eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or", "logical_not", "logical_xor",
    "isnan", "isinf", "isfinite", "any", "all",
))
#: reductions whose output holds values of their input
_VALUE_REDUCTIONS = frozenset(("amax", "amin", "mean", "cummax", "cummin"))
#: contractions: products summed over the last axis of the left operand
_CONTRACTIONS = frozenset(("mm", "bmm", "mv", "dot", "matmul"))


def _base_name(node: Any) -> str:
    """``add`` for ``aten.add.Tensor`` and ``aten.add_.Tensor``; the
    operator's own name for a custom operator; the function's name for
    anything else."""
    target = node.target
    if isinstance(target, torch._ops.OpOverload):
        name = target._schema.name.split("::", 1)[-1]
        return name[:-1] if name.endswith("_") and not name.endswith("__") else name
    if isinstance(target, torch._ops.HigherOrderOperator):
        return target.name()
    return getattr(target, "__name__", None) or str(target)


def _namespace(node: Any) -> str:
    target = node.target
    if isinstance(target, torch._ops.OpOverload):
        return target._schema.name.split("::", 1)[0]
    return ""


def _val(a: Any) -> Any:
    return a.meta.get("val") if isinstance(a, torch.fx.Node) else a


def _shape(a: Any) -> Tuple[int, ...]:
    v = _val(a)
    if isinstance(v, torch.Tensor):
        try:
            return tuple(int(s) for s in v.shape)
        except (TypeError, ValueError):
            return ()
    return ()


def _numel(a: Any) -> int:
    shape = _shape(a)
    return int(np.prod(shape)) if shape else 1


def _is_bool_val(v: Any) -> bool:
    return isinstance(v, torch.Tensor) and v.dtype == torch.bool


def _reduced_count(node: Any) -> int:
    """Number of elements folded together by a sum-like reduction node."""
    shape = _shape(node.args[0])
    dims = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim")
    if dims is None or (isinstance(dims, (list, tuple)) and len(dims) == 0):
        return int(np.prod(shape)) if shape else 1
    if isinstance(dims, int):
        dims = [dims]
    k = 1
    for ax in dims:
        if shape and -len(shape) <= ax < len(shape):
            k *= int(shape[ax])
    return max(k, 1)


def _attr_value(owner: Any, target: str) -> Any:
    obj = owner
    for part in str(target).split("."):
        obj = getattr(obj, part, None)
    return obj


def _attr_interval(obj: Any) -> Any:
    """The interval of a ``get_attr`` constant; None for a nested graph. A
    fake constant has no values: its real twin (``.constant``) when the fake
    mode kept one, else ``TOP``."""
    if isinstance(obj, torch.fx.GraphModule):
        return None
    if isinstance(obj, torch.Tensor):
        from torch._subclasses.fake_tensor import FakeTensor

        if isinstance(obj, FakeTensor):
            const = getattr(obj, "constant", None)
            return TOP if const is None else _const_interval(const)
        return _const_interval(obj)
    return _const_interval(obj) if isinstance(obj, (int, float, bool)) else None


def _literal(a: Any) -> Any:
    """The interval of a non-node argument: a number, a list of them, or
    None for anything else (dtypes, devices, layouts)."""
    if isinstance(a, bool):
        return Interval(float(a), float(a))
    if isinstance(a, (int, float)):
        return Interval(float(a), float(a))
    if isinstance(a, (list, tuple)):
        return [_literal(x) for x in a]
    return None


def _first_iv(x: Any) -> Interval:
    return x if isinstance(x, Interval) else TOP


def _union_all(ivs: Sequence[Any]) -> Interval:
    out: Optional[Interval] = None
    for iv in ivs:
        iv = _first_iv(iv)
        out = iv if out is None else out.union(iv)
    return out if out is not None else TOP


def eval_jaxpr_intervals(
    graph: Any,
    in_intervals: Sequence[Interval],
    unhandled: Optional[Set[str]] = None,
) -> List[Interval]:
    """Propagate element-wise value intervals through a traced FX program
    (a ``GraphModule`` from ``make_fx``; the JAX package's name is kept),
    recursing into the nested graphs of ``torch.cond`` (the union of its
    branches); returns one :class:`Interval` per output. Placeholders take
    ``in_intervals`` in order, ``get_attr`` constants their real values,
    non-node arguments are literals, and reduction counts come from the
    nodes' traced shapes. An in-place write rebinds its interval to the
    written tensor's storage root. Unknown ops produce ``TOP`` (sound, never
    wrong — just loose) and are recorded in ``unhandled`` for evidence."""
    owner = graph if isinstance(graph, torch.fx.GraphModule) else None
    g = graph.graph if owner is not None else graph
    if unhandled is None:
        unhandled = set()
    env: Dict[Any, Any] = {}
    written: Dict[Any, Interval] = {}
    for node, iv in zip(_placeholders(g), in_intervals):
        env[node] = iv

    def read(a: Any) -> Any:
        if isinstance(a, torch.fx.Node):
            v = env.get(a, TOP)
            if isinstance(v, Interval) and written:
                root = _storage_root(a)
                if root is not a and root in written:
                    v = v.union(written[root])
            return v
        if isinstance(a, (list, tuple)):
            return [read(x) for x in a]
        return _literal(a)

    for node in g.nodes:
        if node.op == "get_attr":
            env[node] = _attr_interval(_attr_value(owner, node.target)) if owner is not None else TOP
        elif node.op == "call_function":
            out = _eval_node(node, read, owner, unhandled)
            env[node] = out
            if _aliases_first_arg(node) and not node.target.is_view and isinstance(node.args[0], torch.fx.Node):
                # an in-place write: the written tensor (and, through any
                # view, its base) now holds the written interval
                target = node.args[0]
                new = _first_iv(out)
                env[target] = new
                root = _storage_root(target)
                if root is not target:
                    env[root] = _first_iv(env.get(root, TOP)).union(new)
                written[root] = written[root].union(new) if root in written else new
    return [_first_iv(read(o)) if isinstance(o, torch.fx.Node) else _first_iv(_literal(o))
            for o in _outputs(g)]


def _kwarg(node: Any, name: str, pos: int, default: Any = None) -> Any:
    if name in node.kwargs:
        return node.kwargs[name]
    return node.args[pos] if len(node.args) > pos else default


def _eval_node(node: Any, read: Callable, owner: Any, unhandled: Set[str]) -> Any:
    name = _base_name(node)
    val = node.meta.get("val")
    n_out = len(val) if isinstance(val, (tuple, list)) else 1

    def all_out(iv: Interval) -> Any:
        return [iv] * n_out if isinstance(val, (tuple, list)) else iv

    def arg(i: int) -> Any:
        return read(node.args[i]) if len(node.args) > i else None

    if name == "getitem":
        base = read(node.args[0])
        idx = node.args[1]
        if isinstance(base, list) and isinstance(idx, int) and -len(base) <= idx < len(base):
            return base[idx]
        return base if isinstance(base, Interval) else TOP

    # --- structural: nested graphs ---------------------------------------
    if name == "cond":
        operands = node.args[3] if len(node.args) > 3 else ()
        ins = [_first_iv(read(o)) for o in operands]
        merged: Optional[List[Interval]] = None
        for branch in (node.args[1], node.args[2]):
            sub = _attr_value(owner, branch.target) if isinstance(branch, torch.fx.Node) and owner is not None else None
            if not isinstance(sub, torch.fx.GraphModule):
                return all_out(TOP)
            out = eval_jaxpr_intervals(sub, ins, unhandled)
            merged = out if merged is None else [a.union(b) for a, b in zip(merged, out)]
        if merged is not None and len(merged) == n_out:
            return merged if isinstance(val, (tuple, list)) else merged[0]
        return all_out(TOP)

    # any op whose output is boolean holds values in {0, 1}
    if _is_bool_val(val):
        return _BOOL
    if name in _PREDICATES:
        return all_out(_BOOL)

    a0 = _first_iv(arg(0)) if node.args else TOP

    # --- arithmetic -------------------------------------------------------
    if name in ("add", "sub", "rsub"):
        # add/sub: a ± alpha·b; rsub: b − alpha·a
        alpha = _kwarg(node, "alpha", 2, 1)
        scaled, other = (a0, _first_iv(arg(1))) if name == "rsub" else (_first_iv(arg(1)), a0)
        if alpha != 1:
            scaled = _iv_mul(scaled, _first_iv(_literal(alpha)))
        return _iv_add(other, scaled) if name == "add" else _iv_sub(other, scaled)
    if name == "mul":
        if isinstance(node.args[1], torch.fx.Node) and node.args[0] is node.args[1]:
            # x*x of the SAME node is a square: nonnegative, which a bare
            # product interval cannot see
            return _iv_int_pow(a0, 2)
        return _iv_mul(a0, _first_iv(arg(1)))
    if name == "div":
        q = _iv_div(a0, _first_iv(arg(1)))
        if _kwarg(node, "rounding_mode", 2) is not None and not q.is_top:
            return Interval(q.lo - 1.0, q.hi + 1.0)
        return q
    if name == "neg":
        return _iv_neg(a0)
    if name == "abs":
        return _iv_abs(a0)
    if name in ("sign", "sgn"):
        return Interval(-1.0, 1.0)
    if name == "maximum" or (name == "max" and len(node.args) > 1 and isinstance(node.args[1], torch.fx.Node)):
        b = _first_iv(arg(1))
        return Interval(max(a0.lo, b.lo), max(a0.hi, b.hi))
    if name == "minimum" or (name == "min" and len(node.args) > 1 and isinstance(node.args[1], torch.fx.Node)):
        b = _first_iv(arg(1))
        return Interval(min(a0.lo, b.lo), min(a0.hi, b.hi))
    if name in ("max", "min"):
        if isinstance(val, (tuple, list)):  # max.dim: (values, indices)
            dim = node.args[1] if len(node.args) > 1 else 0
            return [a0, _index_interval(node.args[0], dim)]
        return a0
    if name == "exp":
        return _IV_EXP(a0)
    if name == "log":
        return _IV_LOG(a0)
    if name == "log1p":
        return _IV_LOG1P(a0)
    if name == "sqrt":
        return _IV_SQRT(_iv_abs(a0))
    if name == "tanh":
        return _IV_TANH(a0)
    if name == "sigmoid":
        return Interval(0.0, 1.0)
    if name in ("pow", "square"):
        if name == "square":
            return _iv_int_pow(a0, 2)
        y = node.args[1] if len(node.args) > 1 else 1
        if isinstance(y, bool) or not isinstance(y, (int, float)):
            unhandled.add(str(node.target))
            return TOP
        if float(y).is_integer():
            return _iv_int_pow(a0, int(y))
        if a0.lo >= 0:
            return _mono(lambda x: x ** y)(a0) if y > 0 else _iv_div(Interval(1.0, 1.0), _mono(lambda x: x ** -y)(a0))
        return TOP
    if name == "floor":
        return Interval(a0.lo - 1.0, a0.hi)
    if name in ("round", "nearbyint"):
        # round-to-nearest moves a value by at most 0.5 in EITHER direction
        return Interval(a0.lo - 1.0, a0.hi + 1.0)
    if name == "ceil":
        return Interval(a0.lo, a0.hi + 1.0)
    if name in ("clamp", "clip", "clamp_min", "clamp_max"):
        lo_v = hi_v = None
        if name == "clamp_min":
            lo_v = arg(1)
        elif name == "clamp_max":
            hi_v = arg(1)
        else:
            lo_v = read(_kwarg(node, "min", 1))
            hi_v = read(_kwarg(node, "max", 2))
        lo_iv = _first_iv(lo_v) if lo_v is not None else Interval(-_INF, -_INF)
        hi_iv = _first_iv(hi_v) if hi_v is not None else Interval(_INF, _INF)
        # clamp is monotone in x: map both bounds through it (an
        # intersection formula inverts when x is disjoint from the range)
        return Interval(
            min(max(a0.lo, lo_iv.lo), hi_iv.hi),
            min(max(a0.hi, lo_iv.lo), hi_iv.hi),
        )
    if name == "bitwise_not":
        return Interval(-a0.hi - 1.0, -a0.lo - 1.0)

    # --- selection --------------------------------------------------------
    if name == "where":
        return _first_iv(arg(1)).union(_first_iv(arg(2)))
    if name in ("cat", "stack"):
        parts = arg(0)
        return _union_all(parts if isinstance(parts, list) else [parts])
    if name == "constant_pad_nd":
        value = _kwarg(node, "value", 2, 0.0)
        return a0.union(_literal(value) if isinstance(value, (int, float)) else TOP)
    if name in _PASSTHROUGH:
        return all_out(a0)
    if name == "copy":  # copy and copy_: the source's values
        return _first_iv(arg(1))

    # --- factories --------------------------------------------------------
    if name in ("zeros", "zeros_like", "new_zeros", "zero"):
        return Interval(0.0, 0.0)
    if name in ("ones", "ones_like", "new_ones"):
        return Interval(1.0, 1.0)
    if name in ("full", "full_like", "new_full", "fill"):
        fill = node.args[1] if len(node.args) > 1 else node.kwargs.get("fill_value")
        return _first_iv(read(fill))
    if name == "scalar_tensor":
        return _first_iv(read(node.args[0]))
    if name == "arange":
        nums = [a for a in node.args if isinstance(a, (int, float)) and not isinstance(a, bool)]
        if len(nums) == 1:
            start, end = 0.0, float(nums[0])
        elif len(nums) >= 2:
            start, end = float(nums[0]), float(nums[1])
        else:
            return TOP
        return Interval(min(start, end), max(start, end))

    # --- index outputs ----------------------------------------------------
    if name in ("argmax", "argmin", "argsort"):
        dim = _kwarg(node, "dim", 1)
        return _index_interval(node.args[0], dim)
    if name in ("sort", "topk"):
        dim = _kwarg(node, "dim", 1 if name == "sort" else 2, -1)
        return [a0, _index_interval(node.args[0], -1 if isinstance(dim, bool) else dim)]

    # --- reductions / contractions ----------------------------------------
    if name == "sum":
        k = _reduced_count(node)
        return Interval(k * a0.lo, k * a0.hi)
    if name == "cumsum":
        shape = _shape(node.args[0])
        dim = _kwarg(node, "dim", 1, 0)
        k = int(shape[dim]) if shape and -len(shape) <= dim < len(shape) else 1
        return Interval(min(a0.lo, k * a0.lo), max(a0.hi, k * a0.hi))
    if name in _VALUE_REDUCTIONS:
        if isinstance(val, (tuple, list)):  # cummax/cummin: (values, indices)
            return [a0, _index_interval(node.args[0], _kwarg(node, "dim", 1, 0))]
        return a0
    if name in _CONTRACTIONS:
        # products summed over the contracted axis
        shape = _shape(node.args[0])
        k = int(shape[-1]) if shape else 1
        p = _iv_mul(a0, _first_iv(arg(1)))
        return Interval(k * p.lo, k * p.hi)
    if name in ("index_add", "scatter_add"):
        # scatter-add: every element of the source may land on one slot
        u = _first_iv(arg(3))
        alpha = _kwarg(node, "alpha", 4, 1)
        if name == "index_add" and alpha != 1:
            u = _iv_mul(u, _first_iv(_literal(alpha)))
        return _scatter_add(a0, u, _numel(node.args[3]))
    if name == "index_put":
        values = _first_iv(arg(2))
        if _kwarg(node, "accumulate", 3, False):
            return _scatter_add(a0, values, _numel(node.args[2]))
        return a0.union(values)
    if name == "scatter":
        src = arg(3) if len(node.args) > 3 else read(node.kwargs.get("src", node.kwargs.get("value")))
        return a0.union(_first_iv(src))
    if _namespace(node) == "metrics_tpu_torch" and name == "label_counts":
        # label_bincount as an operator: scatter-add of ones (or weights)
        # into a zeroed count buffer
        weights = _kwarg(node, "weights", 2)
        u = Interval(1.0, 1.0) if weights is None else _first_iv(read(weights))
        return _scatter_add(Interval(0.0, 0.0), u, _numel(node.args[0]))
    if _namespace(node) == "metrics_tpu_torch" and name == "bucket_sums":
        return _scatter_add(Interval(0.0, 0.0), _first_iv(arg(1)), _numel(node.args[1]))

    unhandled.add(str(node.target) if isinstance(node.target, torch._ops.OpOverload) else name)
    return all_out(TOP)


def _scatter_add(o: Interval, u: Interval, k: int) -> Interval:
    k = max(int(k), 1)
    return Interval(o.lo + k * min(u.lo, 0.0), o.hi + k * max(u.hi, 0.0))


def _index_interval(src: Any, dim: Any) -> Interval:
    """Indices into ``src`` along ``dim`` (every element when None)."""
    shape = _shape(src)
    if dim is None or isinstance(dim, bool):
        size = int(np.prod(shape)) if shape else 1
    elif shape and -len(shape) <= int(dim) < len(shape):
        size = int(shape[int(dim)])
    else:
        size = 1
    return Interval(0.0, float(max(size - 1, 0)))


# ---------------------------------------------------------------------------
# declared per-batch input domains
# ---------------------------------------------------------------------------
#: declared element domains per family, one ``(lo, hi)`` per positional
#: update argument. ``UNBOUNDED`` marks arguments whose serving-time values
#: are mean-shifted/large-scale (the regression family) — these get the
#: mean-shifted MTA011 probe; bounded float args get the near-tie spread
#: probe instead. Families absent here derive a default from their sample
#: batch (floats → [0, 1], ints → observed range).
UNBOUNDED = (-1.0e6, 1.0e6)
FAMILY_DOMAINS: Dict[str, Tuple[Tuple[float, float], ...]] = {
    "MeanSquaredError": (UNBOUNDED, UNBOUNDED),
    "MeanAbsoluteError": (UNBOUNDED, UNBOUNDED),
    "MeanSquaredLogError": ((0.0, 1.0e6), (0.0, 1.0e6)),
    "R2Score": (UNBOUNDED, UNBOUNDED),
    "ExplainedVariance": (UNBOUNDED, UNBOUNDED),
    "PSNR": ((0.0, 1.0), (0.0, 1.0)),
    "Hinge": ((-16.0, 16.0), (0.0, 3.0)),
    "AUC": ((0.0, 1.0), (0.0, 1.0)),
}


def _leaf_domains(family: str, args: tuple, kwargs: dict) -> List[Interval]:
    """One declared :class:`Interval` per batch-input tensor leaf, in the
    order the update program was traced with (each positional argument's
    leaves share its declared domain)."""
    declared = FAMILY_DOMAINS.get(family)
    out: List[Interval] = []
    for i, a in enumerate(args):
        for leaf in _tensor_leaves(a):
            if declared is not None and i < len(declared):
                out.append(Interval(*declared[i]))
            else:
                out.append(_default_leaf_domain(leaf))
    for leaf in _tensor_leaves(kwargs):
        out.append(_default_leaf_domain(leaf))
    return out


def _default_leaf_domain(leaf: torch.Tensor) -> Interval:
    if leaf.is_floating_point():
        return Interval(0.0, 1.0)
    if leaf.dtype == torch.bool:
        return _BOOL
    return _const_interval(leaf)


def _rows_per_batch(args: tuple) -> int:
    for leaf in _tensor_leaves(tuple(args)):
        if leaf.dim():
            return max(int(leaf.shape[0]), 1)
    return 1


# ---------------------------------------------------------------------------
# MTA010 — per-state horizons
# ---------------------------------------------------------------------------
_BOUNDED_REDUCTIONS = {dim_zero_mean: "mean", dim_zero_min: "min", dim_zero_max: "max"}


def _array_update_closed(metric, args: tuple, kwargs: dict) -> Optional[Tuple[Any, List[str]]]:
    """The update traced as ``array_states -> new array_states`` (sorted key
    order on both sides, as the trace flattens dicts; list states enter as
    fresh ``[]`` and are not returned). None when the update does not
    trace."""
    from metrics_tpu_torch.analysis.program import _fake_trace, _update_program

    defaults = metric._defaults
    array_names = sorted(k for k, d in defaults.items() if not isinstance(d, list))
    list_names = [k for k, d in defaults.items() if isinstance(d, list)]
    run = _update_program(metric)

    def fn(array_states, a, kw):
        full = {**{k: [] for k in list_names}, **array_states}
        out = run(full, a, kw)
        return {k: out[k] for k in array_names}

    states = {k: defaults[k].clone() for k in array_names}
    try:
        graph, _ = _fake_trace(fn, (states, args, kwargs))
    except Exception:  # noqa: BLE001 — untraceable update: horizons unbounded
        return None
    return graph, array_names


def _mantissa_bits(dt: torch.dtype) -> int:
    return int(round(-math.log2(torch.finfo(dt).eps)))


def state_horizons(
    metric,
    args: tuple,
    kwargs: dict,
    family: Optional[str] = None,
    rows_per_step: int = DEFAULT_SERVING_ROWS_PER_STEP,
) -> Dict[str, Dict[str, Any]]:
    """Per-state overflow/absorption horizons in ROWS, derived by interval
    abstract interpretation of the traced update program under the
    family's declared per-batch input domains.

    Kinds: ``int-overflow`` (rows until an integer accumulator saturates at
    the declared per-row rate — exact accumulation, batch-size
    independent), ``float-ulp-absorption`` (rows until ``acc + x == acc``
    for the family's largest per-step contribution at the declared serving
    batch shape — ``2^(mantissa+1) × rows_per_step``),
    ``extremal``/``mean``/``static``/``cat`` (value-bounded or
    non-accumulating: no horizon), ``residual-exempt`` (error-feedback
    companions: library-managed, reset on every commit). ``rows: None``
    means unbounded/no horizon."""
    family = family or type(metric).__name__
    defaults = metric._defaults
    residuals = set(metric._sync_residual_names())
    reductions = getattr(metric, "_reductions", {})
    horizons: Dict[str, Dict[str, Any]] = {}

    out_ivs: Dict[str, Interval] = {}
    unhandled: Set[str] = set()
    traced = _array_update_closed(metric, args, kwargs)
    if traced is not None:
        graph, array_names = traced
        # state inputs get point intervals at their reset defaults, so for
        # additive updates the output interval minus the default IS the
        # per-step increment bound; batch inputs get the family's declared
        # per-batch domain
        state_ivs = [_const_interval(defaults[k]) for k in array_names]
        in_ivs = state_ivs + _leaf_domains(family, args, kwargs)
        if len(in_ivs) == len(_placeholders(graph)):
            try:
                outs = eval_jaxpr_intervals(graph, in_ivs, unhandled)
            except Exception:  # noqa: BLE001 — analysis must never crash the audit
                outs = []
            if len(outs) == len(array_names):
                out_ivs = dict(zip(array_names, outs))

    n_rows = _rows_per_batch(args)
    for name, default in defaults.items():
        if isinstance(default, list):
            horizons[name] = {"kind": "cat", "rows": None}
            continue
        if name in residuals:
            horizons[name] = {"kind": "residual-exempt", "rows": None}
            continue
        red = reductions.get(name)
        if red in _BOUNDED_REDUCTIONS:
            horizons[name] = {"kind": _BOUNDED_REDUCTIONS[red], "rows": None}
            continue
        dt = default.dtype
        d_iv = _const_interval(default)
        out_iv = out_ivs.get(name)
        inc = _iv_sub(out_iv, d_iv) if out_iv is not None else None
        entry: Dict[str, Any] = {
            "dtype": _dtype_name(dt),
            "per_step_increment": (
                None if inc is None else [_json_num(inc.lo), _json_num(inc.hi)]
            ),
        }
        if not dt.is_floating_point and not dt.is_complex and dt != torch.bool:
            entry["kind"] = "int-overflow"
            if inc is None:
                entry["rows"] = None
                entry["note"] = "update did not trace; increment unbounded"
            else:
                up_rate = max(inc.hi, 0.0) / n_rows
                dn_rate = max(-inc.lo, 0.0) / n_rows
                info = torch.iinfo(dt)
                if math.isinf(up_rate) or math.isinf(dn_rate):
                    # a TOP increment (unhandled op, zero-spanning divisor):
                    # saturation cannot be bounded away — flag at horizon 0
                    # rather than certify an unknown
                    entry["rows"] = 0.0
                    entry["note"] = "increment unbounded by the declared domain"
                elif up_rate == 0.0 and dn_rate == 0.0:
                    entry["kind"] = "static"
                    entry["rows"] = None
                else:
                    rows = _INF
                    if up_rate > 0:
                        rows = min(rows, (float(info.max) - d_iv.hi) / up_rate)
                    if dn_rate > 0:
                        rows = min(rows, (d_iv.lo - float(info.min)) / dn_rate)
                    entry["rows"] = float(rows)
        elif dt.is_floating_point:
            accumulates = inc is None or inc.lo != 0.0 or inc.hi != 0.0
            if not accumulates:
                entry["kind"] = "static"
                entry["rows"] = None
            else:
                # absorption: after 2^(mantissa+1) steps at the declared
                # serving batch shape, even the LARGEST per-step
                # contribution satisfies acc + x == acc (partial ulp loss
                # begins earlier; the MTA011 measured budget covers the
                # conditioning side)
                p = _mantissa_bits(dt) + 1
                entry["kind"] = "float-ulp-absorption"
                entry["rows"] = float(2 ** p) * float(rows_per_step)
        else:
            entry["kind"] = "static"
            entry["rows"] = None
        horizons[name] = entry
    if unhandled:
        horizons["__approximated__"] = {
            "kind": "note", "rows": None,
            "unhandled_primitives": sorted(unhandled),
        }
    return horizons


def _json_num(x: float) -> Optional[float]:
    return None if math.isinf(x) or math.isnan(x) else float(x)


# ---------------------------------------------------------------------------
# MTA011 — cancellation: structural taint + measured budget
# ---------------------------------------------------------------------------
_ACCUMULATED = (dim_zero_sum, dim_zero_mean)
#: ops whose outputs are truth values or signs: they launder magnitude
#: information and cannot cancel catastrophically
_TAINT_CLEARS = _PREDICATES | {"sign", "sgn", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not"}


def _compute_closed(metric) -> Optional[Tuple[Any, List[str]]]:
    """The compute program traced abstractly as a function of the array
    states (telemetry muted), plus the state-leaf order; None when compute
    does not trace (eager-only families: list states, host reads)."""
    from metrics_tpu_torch.analysis.program import _fake_trace
    from metrics_tpu_torch.metric import _san_allow_ctx

    names = sorted(k for k, d in metric._defaults.items() if not isinstance(d, list))
    if len(names) != len(metric._defaults):
        return None  # list states: compute concatenates on the host

    def fn(states):
        saved = metric._snapshot_state()
        try:
            with _san_allow_ctx():
                for k, v in states.items():
                    setattr(metric, k, v)
                metric._computed = None
                return metric.compute()
        finally:
            metric._restore_state(saved)
            metric._computed = None

    states = {k: metric._defaults[k].clone() for k in names}
    try:
        graph, _ = _fake_trace(fn, (states,))
    except Exception:  # noqa: BLE001 — untraceable compute: structural leg skipped
        return None
    return graph, names


def _shape_str(node: Any) -> str:
    v = node.meta.get("val")
    shape = tuple(int(s) for s in v.shape) if isinstance(v, torch.Tensor) else ()
    return str(shape)


def cancellation_sites(metric) -> Optional[List[Dict[str, Any]]]:
    """Structural MTA011 leg: subtractions whose BOTH operands descend from
    accumulated (sum/mean-reduced) states — ``sub``, ``rsub``, ``add`` with
    ``alpha=-1``, or an ``add`` of a negated value — found by a taint walk
    over the compute graph (nested graphs included). Returns the site list,
    or None when compute does not trace."""
    traced = _compute_closed(metric)
    if traced is None:
        return None
    graph, names = traced
    reductions = getattr(metric, "_reductions", {})
    residuals = set(metric._sync_residual_names())
    tainted_roots = [
        reductions.get(n) in _ACCUMULATED and n not in residuals for n in names
    ]
    sites: List[Dict[str, Any]] = []

    def walk(gm: Any, taint_in: List[bool]) -> List[bool]:
        owner = gm if isinstance(gm, torch.fx.GraphModule) else None
        g = gm.graph if owner is not None else gm
        taint: Dict[Any, Any] = {}
        negated: Set[Any] = set()
        for node, t in zip(_placeholders(g), taint_in):
            taint[node] = t

        def tainted(a: Any) -> bool:
            if isinstance(a, torch.fx.Node):
                t = taint.get(a, False)
                return any(t) if isinstance(t, list) else bool(t)
            if isinstance(a, (list, tuple)):
                return any(tainted(x) for x in a)
            return False

        for node in g.nodes:
            if node.op != "call_function":
                continue
            name = _base_name(node)
            if name == "getitem":
                base = taint.get(node.args[0], False)
                idx = node.args[1]
                taint[node] = base[idx] if isinstance(base, list) and isinstance(idx, int) else tainted(node.args[0])
                continue
            if name == "cond":
                operands = node.args[3] if len(node.args) > 3 else ()
                ins = [tainted(o) for o in operands]
                outs: Optional[List[bool]] = None
                for branch in (node.args[1], node.args[2]):
                    sub = _attr_value(owner, branch.target) if owner is not None else None
                    if isinstance(sub, torch.fx.GraphModule):
                        got = walk(sub, ins)
                        outs = got if outs is None else [a or b for a, b in zip(outs, got)]
                taint[node] = outs if outs is not None else [tainted(node.args)]
                continue
            tensor_args = list(node.args[:2])
            is_sub = False
            if name in ("sub", "rsub") and len(tensor_args) == 2 and all(tainted(a) for a in tensor_args):
                is_sub = True
            elif name == "add" and len(tensor_args) == 2 and all(tainted(a) for a in tensor_args):
                alpha = _kwarg(node, "alpha", 2, 1)
                if alpha == -1 or any(a in negated for a in tensor_args if isinstance(a, torch.fx.Node)):
                    is_sub = True
            if is_sub:
                sites.append({"primitive": name, "shape": _shape_str(node)})
            out = False if name in _TAINT_CLEARS else tainted(list(node.args) + list(node.kwargs.values()))
            taint[node] = out
            if name == "neg" and tainted(node.args[0]):
                negated.add(node)
            if _aliases_first_arg(node) and not node.target.is_view and isinstance(node.args[0], torch.fx.Node):
                # an in-place write taints the written tensor's storage
                taint[_storage_root(node.args[0])] = out or tainted(node.args[0])
        return [tainted(o) for o in _outputs(g)]

    walk(graph, tainted_roots[: len(_placeholders(graph))])
    return sites


def _adversarial_probes(
    family: str, args: tuple, seed: int = 0x1CE
) -> List[Tuple[str, tuple]]:
    """Ill-conditioned probe batches shaped like ``args`` (drawn in the JAX
    package's order from the same seed, so the probes are its bits).
    Unbounded float args get mean-shifted data (shift 1e6, unit spread — the
    variance killer) and a tiny-scale leg (1e-6 — underflow/absolute-
    epsilon); bounded float args get a near-tie spread around the domain
    midpoint (0.5 ± 1e-6). All float probes are cast to f32 FIRST — the
    float64 oracle consumes the identical f32 values, so the measured budget
    is computation error, not input quantization."""
    declared = FAMILY_DOMAINS.get(family)
    rng = np.random.RandomState(seed)

    def build(mode: str) -> tuple:
        out = []
        for i, a in enumerate(args):
            if not (isinstance(a, torch.Tensor) and a.is_floating_point()):
                out.append(a)
                continue
            shape = tuple(a.shape)
            r = rng.rand(*shape) if shape else rng.rand()
            lo, hi = (declared[i] if declared is not None and i < len(declared)
                      else (0.0, 1.0))
            unbounded = (hi - lo) > 1e3
            if mode == "shifted" and unbounded:
                vals = 1.0e6 + (r - 0.5) * 2.0 if lo < 0 else 1.0e6 + r
            elif mode == "tiny" and unbounded:
                vals = (r - 0.5) * 2.0e-6 if lo < 0 else r * 1.0e-6
            else:
                # bounded domain: near-tie spread at the midpoint
                vals = 0.5 + (r - 0.5) * 2.0e-6
                host = _np(a)
                if np.ndim(vals) >= 2 and bool((host >= 0).all()):
                    rowsum = host.sum(axis=-1)
                    if np.allclose(rowsum, 1.0, atol=1e-3):
                        vals = vals / vals.sum(axis=-1, keepdims=True)
            out.append(torch.as_tensor(np.asarray(vals, dtype=np.float32)).to(a.device))
        return tuple(out)

    return [("shifted", build("shifted")), ("tiny", build("tiny"))]


class Float64OracleError(RuntimeError):
    """The float64 oracle leg returned a float leaf narrower than float64:
    it did not run in float64, so it cannot stand as the oracle."""


def _float64_leg(metric, probe64: tuple) -> Any:
    """update→compute from float64 copies of the float default states on
    float64 probes; every float leaf of the result must be float64
    (:class:`Float64OracleError` otherwise: a family that pins float32 for
    its result has no float64 oracle)."""
    from metrics_tpu_torch.analysis.distributed import _compute_on_states, _muted
    from metrics_tpu_torch.analysis.program import _update_program

    states = {
        k: ([] if isinstance(d, list) else d.to(torch.float64) if d.is_floating_point() else d.clone())
        for k, d in metric._defaults.items()
    }
    with _muted():
        after = _update_program(metric)(states, probe64, {})
    value = _compute_on_states(metric, after)
    narrow = sorted({
        str(leaf.dtype).replace("torch.", "")
        for leaf in _tensor_leaves(value) if leaf.is_floating_point() and leaf.dtype != torch.float64
    })
    if narrow:
        raise Float64OracleError(
            f"the float64 oracle leg returned {narrow} leaves: it did not run in float64"
        )
    return value


def measure_error_budget(
    metric, args: tuple, family: Optional[str] = None
) -> Optional[Dict[str, Any]]:
    """Measured MTA011 leg: the family's update→compute composite evaluated
    on adversarial ill-conditioned probes in f32 against a float64 oracle
    fed the identical f32-cast inputs; returns the observed worst relative
    error (capped at :data:`ERROR_BUDGET_CAP`) with the per-probe
    breakdown, the probes whose f32 result went non-finite where the
    oracle's did not (``non_finite``: every digit lost, counted at the
    cap), the probes skipped (``{probe: error}``: a probe outside the
    family's domain raises), and ``"float64": True`` once every measured
    probe's oracle returned float64 leaves — or None when no probe could be
    measured. An oracle leg that returns a narrower float leaf raises
    :class:`Float64OracleError`: it is never reported as a budget."""
    from metrics_tpu_torch.analysis.distributed import _compute_on_states, _states_after_update

    family = family or type(metric).__name__
    per_probe: Dict[str, float] = {}
    skipped: Dict[str, str] = {}
    non_finite: List[str] = []
    worst = 0.0
    measured = False
    for probe_name, probe in _adversarial_probes(family, args):
        probe64 = tuple(
            a.to(torch.float64) if isinstance(a, torch.Tensor) and a.is_floating_point() else a
            for a in probe
        )
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                v32 = _compute_on_states(metric, _states_after_update(metric, probe, {}))
                v64 = _float64_leg(metric, probe64)
        except Float64OracleError:
            raise
        except Exception as err:  # noqa: BLE001 — a probe outside the family's domain
            msg = str(err).splitlines()[0] if str(err) else ""
            skipped[probe_name] = f"{type(err).__name__}: {msg}"[:200]
            continue
        rel = _relative_error(v32, v64)
        if rel is None:
            skipped[probe_name] = "no finite value to compare"
            continue
        measured = True
        if math.isinf(rel):
            non_finite.append(probe_name)
            rel = ERROR_BUDGET_CAP
        per_probe[probe_name] = rel
        worst = max(worst, rel)
    if not measured:
        return None
    out: Dict[str, Any] = {
        "budget": min(worst, ERROR_BUDGET_CAP),
        "per_probe": per_probe,
        "oracle": "float64",
        "float64": True,
    }
    if non_finite:
        out["non_finite"] = non_finite
    if skipped:
        out["skipped"] = skipped
    return out


def _relative_error(v32: Any, v64: Any) -> Optional[float]:
    """The worst relative error of ``v32`` against the oracle ``v64`` over
    their finite pairs; ``inf`` where the f32 result is not finite and the
    oracle is (every digit lost: a cancellation that rounds to a zero
    divisor on one device and to garbage on another must read alike);
    None when nothing compares."""
    from metrics_tpu_torch.analysis.distributed import _value_leaves

    l32 = [np.asarray(x, dtype=np.float64) for x in _value_leaves(v32)]
    l64 = [np.asarray(x, dtype=np.float64) for x in _value_leaves(v64)]
    if len(l32) != len(l64):
        return None
    worst = 0.0
    seen = False
    for a, b in zip(l32, l64):
        if a.shape != b.shape or not a.size:
            continue
        if (~np.isfinite(a) & np.isfinite(b)).any():
            return _INF
        ok = np.isfinite(a) & np.isfinite(b)
        if not ok.any():
            continue
        seen = True
        denom = np.maximum(np.abs(b[ok]), 1e-12)
        worst = max(worst, float((np.abs(a[ok] - b[ok]) / denom).max()))
    return worst if seen else None


def committed_budget_ceiling(observed: float) -> float:
    """The value the baseline commits for an observed budget: the next power
    of two above 4× the observation (headroom for FMA/platform drift),
    floored at 2⁻²⁴ and capped at :data:`ERROR_BUDGET_CAP` — deterministic,
    and still sensitive to a genuine conditioning regression (anything worse
    than ~8× the committed measurement)."""
    if observed <= 0.0:
        return 2.0 ** -24
    ceil = 2.0 ** math.ceil(math.log2(max(observed * 4.0, 2.0 ** -24)))
    return min(ceil, ERROR_BUDGET_CAP)


# ---------------------------------------------------------------------------
# MTA012 — scale/shift-equivariance probes
# ---------------------------------------------------------------------------
#: declared equivariance classes, keyed by family/class name. ``scale_args``
#: are the update-argument positions the probe rescales; ``factor_exp`` is
#: the exponent k with compute(s·x) == s^k · compute(x) (k = 0:
#: scale-invariant). Scales are powers of two, so IEEE multiplication is
#: EXACT and the expected transform is checked BITWISE — any drift is a
#: hidden absolute-epsilon threshold or premature rounding. Families whose
#: canonicalization is legitimately scale-dependent (0.5 probability
#: thresholds, fixed [0, 1] bin edges, rowsum-based input-format
#: classification, PSNR's fixed data_range, MSLE's log1p) are deliberately
#: absent.
EQUIVARIANCE: Dict[str, Dict[str, Any]] = {
    "AUROC": {"scale_args": (0,), "scales": (0.5, 2.0 ** -10), "factor_exp": 0},
    "AveragePrecision": {"scale_args": (0,), "scales": (0.5, 2.0 ** -10), "factor_exp": 0},
    "RetrievalMAP": {"scale_args": (1,), "scales": (0.5, 2.0 ** -10), "factor_exp": 0},
    "RetrievalMRR": {"scale_args": (1,), "scales": (0.5, 2.0 ** -10), "factor_exp": 0},
    "RetrievalPrecision": {"scale_args": (1,), "scales": (0.5, 2.0 ** -10), "factor_exp": 0},
    "RetrievalRecall": {"scale_args": (1,), "scales": (0.5, 2.0 ** -10), "factor_exp": 0},
    "R2Score": {"scale_args": (0, 1), "scales": (2.0, 0.5), "factor_exp": 0},
    "ExplainedVariance": {"scale_args": (0, 1), "scales": (2.0, 0.5), "factor_exp": 0},
    "MeanSquaredError": {"scale_args": (0, 1), "scales": (2.0, 0.5), "factor_exp": 2},
    "MeanAbsoluteError": {"scale_args": (0, 1), "scales": (2.0, 0.5), "factor_exp": 1},
    # the MTA012 fixture: declared scale-invariant, hides an absolute
    # epsilon — the probe must catch it
    "EpsilonThresholdAUROC": {"scale_args": (0,), "scales": (0.5, 2.0 ** -10), "factor_exp": 0},
}


def _scaled(a: Any, scale: float) -> Any:
    """``a × scale`` in float32 (exact for a power of two), on ``a``'s
    device."""
    return torch.as_tensor(_np(a) * np.float32(scale)).to(a.device)


def equivariance_verdict(
    metric, args: tuple, family: Optional[str] = None
) -> Optional[Dict[str, Any]]:
    """Concrete metamorphic MTA012 check against the declared class; None
    when the family declares no equivariance. The verdict carries every
    probed scale with its bitwise result."""
    from metrics_tpu_torch.analysis.distributed import (
        _compute_on_states,
        _states_after_update,
        _value_leaves,
    )

    family = family or type(metric).__name__
    spec = EQUIVARIANCE.get(family)
    if spec is None:
        return None
    try:
        base = _compute_on_states(metric, _states_after_update(metric, args, {}))
    except Exception:  # noqa: BLE001
        return {"kind": _kind(spec), "checked": False, "error": "base evaluation failed"}
    base_leaves = _value_leaves(base)
    results: List[Dict[str, Any]] = []
    stable = True
    for scale in spec["scales"]:
        scaled_args = tuple(
            _scaled(a, scale) if i in spec["scale_args"] else a
            for i, a in enumerate(args)
        )
        try:
            got = _compute_on_states(
                metric, _states_after_update(metric, scaled_args, {})
            )
        except Exception as err:  # noqa: BLE001
            results.append({"scale": scale, "bit_stable": False,
                            "error": f"{type(err).__name__}"})
            stable = False
            continue
        factor = float(scale) ** int(spec["factor_exp"])
        got_leaves = _value_leaves(got)
        ok = len(got_leaves) == len(base_leaves)
        delta = 0.0
        if ok:
            for g, b in zip(got_leaves, base_leaves):
                expected = (
                    b if spec["factor_exp"] == 0
                    else np.asarray(b, dtype=g.dtype) * g.dtype.type(factor)
                    if g.dtype.kind == "f" else b
                )
                if g.shape != np.asarray(expected).shape or not np.array_equal(
                    g, expected, equal_nan=True
                ):
                    ok = False
                    with np.errstate(all="ignore"):
                        d = np.abs(
                            np.asarray(g, dtype=np.float64)
                            - np.asarray(expected, dtype=np.float64)
                        )
                        delta = float(np.nanmax(d)) if d.size else float("inf")
                    break
        results.append({
            "scale": scale, "factor": factor, "bit_stable": ok,
            **({} if ok else {"max_delta": delta}),
        })
        stable = stable and ok
    return {"kind": _kind(spec), "checked": True, "bit_stable": stable,
            "scales": results}


def _kind(spec: Dict[str, Any]) -> str:
    return "scale-invariant" if spec["factor_exp"] == 0 else "scale-equivariant"


# ---------------------------------------------------------------------------
# the committed baseline
# ---------------------------------------------------------------------------
def _repo_root() -> str:
    import metrics_tpu_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(metrics_tpu_torch.__file__)))


_BASELINE_CACHE: Dict[str, Optional[Dict[str, Any]]] = {}
_BASELINE_LOCK = threading.Lock()


def load_numerics_baseline(path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The committed per-family numerics entries (``family -> entry``), or
    None when no baseline is committed. Cached per path."""
    path = path or os.path.join(_repo_root(), NUMERICS_BASELINE_FILENAME)
    with _BASELINE_LOCK:
        if path not in _BASELINE_CACHE:
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    _BASELINE_CACHE[path] = json.load(fh).get("entries") or {}
            except (OSError, ValueError):
                _BASELINE_CACHE[path] = None
        return _BASELINE_CACHE[path]


def build_numerics_entry(evidence: Dict[str, Any]) -> Dict[str, Any]:
    """The committed-baseline entry derived from one family's fresh
    ``evidence["numerics"]``: the state inventory, every numeric horizon,
    and the error-budget ceiling."""
    horizons = {
        name: {"kind": h.get("kind"), "rows": h.get("rows")}
        for name, h in (evidence.get("horizons") or {}).items()
        if not name.startswith("__")
    }
    entry: Dict[str, Any] = {
        "states": sorted(horizons),
        "horizons": horizons,
    }
    cancel = evidence.get("cancellation") or {}
    budget = cancel.get("budget")
    entry["error_budget"] = (
        None if budget is None else committed_budget_ceiling(float(budget))
    )
    return entry


def min_horizon_rows(
    evidence_by_family: Optional[Dict[str, Any]]
) -> Optional[float]:
    """The shortest FINITE horizon, in rows, across a mapping of
    ``evidence["numerics"]`` dicts — the registry's first state to
    numerically exhaust. None when nothing carries a numeric horizon. The
    fold behind the ``analysis.numerics.horizon_min`` gauge."""
    worst: Optional[float] = None
    for ev in (evidence_by_family or {}).values():
        for h in ((ev or {}).get("horizons") or {}).values():
            rows = h.get("rows") if isinstance(h, dict) else None
            if rows is not None:
                worst = float(rows) if worst is None else min(worst, float(rows))
    return worst


def tighten_baseline(
    baseline: Dict[str, Any], fresh: Dict[str, Dict[str, Any]]
) -> Tuple[Dict[str, Any], List[str]]:
    """Merge a green audit's fresh entries into the committed baseline,
    IMPROVEMENTS ONLY: horizons never drop, error budgets never grow, a
    committed-unbounded horizon stays unbounded. Fixture entries named in
    ``baseline["fixtures"]`` keep their deliberately-tight committed
    values; retired/renamed families are pruned (returned second). Pure:
    returns the merged baseline and writes nothing."""
    old_entries = baseline.get("entries", {}) or {}
    keep = set(baseline.get("fixtures", []) or [])
    entries: Dict[str, Any] = {
        fam: old_entries[fam] for fam in sorted(keep) if fam in old_entries
    }
    for fam, fresh_entry in sorted(fresh.items()):
        if fam in entries:
            continue  # a fixture name: the committed gate wins
        old = old_entries.get(fam)
        entry = dict(fresh_entry)
        if old is not None and old.get("states") == fresh_entry.get("states"):
            horizons: Dict[str, Any] = {}
            for name, h in (fresh_entry.get("horizons") or {}).items():
                oh = (old.get("horizons") or {}).get(name)
                rows = h.get("rows")
                if oh is not None:
                    o_rows = oh.get("rows")
                    if o_rows is None:
                        rows = None
                    elif rows is not None:
                        rows = max(float(o_rows), float(rows))
                    else:
                        rows = None  # fresh unbounded: an improvement
                horizons[name] = {**h, "rows": rows}
            entry["horizons"] = horizons
            ob = old.get("error_budget")
            fb = fresh_entry.get("error_budget")
            if ob is not None and fb is not None:
                entry["error_budget"] = min(float(ob), float(fb))
            elif fb is None:
                entry["error_budget"] = ob
        entries[fam] = entry
    pruned = sorted(set(old_entries) - set(entries))
    out = dict(baseline)
    out["entries"] = entries
    return out, pruned


def check_numerics(
    metric,
    findings: List[Finding],
    infos: List[str],
    args: tuple = (),
    kwargs: Optional[dict] = None,
    family: Optional[str] = None,
    baseline: Optional[Dict[str, Any]] = None,
    cache: Optional[Dict[str, Any]] = None,
    floor_rows: float = DEFAULT_FLEET_FLOOR_ROWS,
    rows_per_step: int = DEFAULT_SERVING_ROWS_PER_STEP,
) -> Dict[str, Any]:
    """Pass 5 over one metric: derive horizons (MTA010), cancellation sites
    + measured budget (MTA011), and the equivariance verdict (MTA012); gate
    horizons and budget against the committed baseline. Returns the
    ``evidence["numerics"]`` dict.

    ``cache`` (shared per family root across the @cohort/@int8/@bf16
    variant audits) carries the measured budget, equivariance verdict and
    base horizons — the variant namespaces share the family's math, so only
    their state inventory (residual companions) differs."""
    from metrics_tpu_torch.analysis.program import _widest_float_input

    cls = type(metric).__name__
    family = family or cls
    kwargs = dict(kwargs or {})
    cache = cache if cache is not None else {}

    root_key = "numerics:root"
    if root_key in cache:
        root = cache[root_key]
        base_horizons = dict(root["horizons"])
        # variant inventories add residual companions (and never remove a
        # base state); recompute only the states the base audit didn't see
        horizons: Dict[str, Dict[str, Any]] = {}
        residuals = set(metric._sync_residual_names())
        for name, default in metric._defaults.items():
            if name in base_horizons:
                horizons[name] = base_horizons[name]
            elif name in residuals:
                horizons[name] = {"kind": "residual-exempt", "rows": None}
            else:
                horizons[name] = {"kind": "cat" if isinstance(default, list) else "static",
                                  "rows": None}
        cancellation = root["cancellation"]
        equivariance = root["equivariance"]
    else:
        try:
            horizons = state_horizons(
                metric, args, kwargs, family=family, rows_per_step=rows_per_step,
            )
        except Exception:  # noqa: BLE001 — analysis must never crash the audit
            horizons = {}
        sites: Optional[List[Dict[str, Any]]]
        try:
            sites = cancellation_sites(metric)
        except Exception:  # noqa: BLE001
            sites = None
        try:
            measured = measure_error_budget(metric, args, family=cls)
        except Float64OracleError as err:
            # the family pins float32 for its result: no float64 oracle, so
            # no budget — recorded, never reported as a measurement
            measured = {"budget": None, "oracle": "float64", "float64": False, "error": str(err)}
            infos.append(f"{cls}: MTA011 measured budget not taken — {err}")
        except Exception as err:  # noqa: BLE001 — analysis must never crash the audit
            measured = {"budget": None, "error": f"{type(err).__name__}: {err}"[:300]}
        cancellation = {
            "sites": sites,
            **(measured or {"budget": None}),
        }
        if sites is None:
            infos.append(
                f"{cls}: MTA011 structural leg skipped — compute does not"
                " trace (eager-only family); measured budget still applies"
            )
        try:
            equivariance = equivariance_verdict(metric, args, family=cls)
        except Exception:  # noqa: BLE001
            equivariance = None
        cache[root_key] = {
            "horizons": {k: v for k, v in horizons.items() if not k.startswith("__")},
            "cancellation": cancellation,
            "equivariance": equivariance,
        }

    evidence: Dict[str, Any] = {
        "horizons": horizons,
        "cancellation": cancellation,
        "equivariance": equivariance,
        "floor_rows": float(floor_rows),
        "rows_per_step": int(rows_per_step),
    }

    # --- MTA010: fleet floor ---------------------------------------------
    # one defect, one diagnosis: a float accumulator narrower than its input
    # is MTA001's finding (whether or not this audit ran that pass — the
    # slim variant audits deliberately skip it), and its short absorption
    # horizon is the same defect seen from the lifetime side
    mta001_states = {
        f.subject.split(".", 1)[1]
        for f in findings
        if f.rule == "MTA001" and "." in f.subject
    }
    widest = _widest_float_input(args, kwargs)
    if widest is not None:
        for name, default in metric._defaults.items():
            if isinstance(default, list):
                continue
            if default.is_floating_point() and default.dtype.itemsize < widest.itemsize:
                mta001_states.add(name)
    for name, h in horizons.items():
        if name.startswith("__"):
            continue
        rows = h.get("rows")
        if rows is None or rows >= floor_rows:
            continue
        if name in mta001_states:
            infos.append(
                f"{cls}.{name}: horizon {rows:.3g} rows below the fleet floor"
                " — already diagnosed as MTA001 (narrow accumulator)"
            )
            continue
        findings.append(Finding(
            "MTA010", f"{cls}.{name}",
            f"{h.get('kind')} horizon is {rows:.4g} rows — below the fleet"
            f" floor of {float(floor_rows):.4g} rows: this accumulator"
            " saturates (or stops absorbing increments) within a serving"
            " process lifetime. Widen the state dtype, or suppress with a"
            " written rationale and arm StateGuard(overflow_margin=...) as"
            " the runtime mitigation",
            detail={"state": name, "rows": rows, "floor": float(floor_rows),
                    "kind": h.get("kind")},
        ))

    # --- MTA012 (baseline-independent: the declared class either holds
    # bitwise or it does not) ------------------------------------------------
    _equivariance_findings(cls, equivariance, findings)

    # --- the committed-baseline gate ---------------------------------------
    base = load_numerics_baseline() if baseline is None else baseline
    entry = (base or {}).get(family)
    if entry is None:
        return evidence
    fresh_states = sorted(k for k in horizons if not k.startswith("__"))
    recorded = entry.get("states")
    if recorded is not None and list(recorded) != fresh_states:
        infos.append(
            f"{cls}: committed numerics baseline for {family!r} records states"
            f" {list(recorded)} but this configuration registers"
            f" {fresh_states}; measured, not gated"
        )
        return evidence
    for name, committed in (entry.get("horizons") or {}).items():
        c_rows = committed.get("rows")
        f_rows = (horizons.get(name) or {}).get("rows")
        if c_rows is None:
            continue
        if f_rows is None:
            continue  # unbounded now: an improvement
        if name in mta001_states:
            continue  # the narrowing is MTA001's diagnosis
        if f_rows < float(c_rows):
            findings.append(Finding(
                "MTA010", f"{cls}.{name}",
                f"horizon regression: {f_rows:.4g} rows vs the committed"
                f" baseline of {float(c_rows):.4g} — a dtype narrowing or a"
                " larger per-step increment shortened this state's life."
                " If intended, hand-edit this family's entry in"
                " NUMERICS_BASELINE.json and justify it in review",
                detail={"state": name, "rows": f_rows, "baseline": float(c_rows)},
            ))
    c_budget = entry.get("error_budget")
    f_budget = cancellation.get("budget")
    if c_budget is not None and f_budget is not None and float(f_budget) > float(c_budget):
        findings.append(Finding(
            "MTA011", cls,
            f"measured cancellation error budget blown: observed relative"
            f" error {float(f_budget):.4g} on the adversarial probes vs the"
            f" committed budget of {float(c_budget):.4g} — a refactor"
            " worsened this family's conditioning (the E[x²]−E[x]² class of"
            " loss), even if the program shape is unchanged. If the new"
            " formulation is intended, hand-edit the committed budget in"
            " NUMERICS_BASELINE.json and justify it in review",
            detail={"observed": float(f_budget), "baseline": float(c_budget),
                    "sites": len(cancellation.get("sites") or [])},
        ))

    return evidence


def _equivariance_findings(cls: str, equivariance, findings: List[Finding]) -> None:
    if equivariance is not None and equivariance.get("checked") and not equivariance.get("bit_stable"):
        bad = [r for r in equivariance["scales"] if not r.get("bit_stable")]
        findings.append(Finding(
            "MTA012", cls,
            f"declared {equivariance['kind']} family is not bit-stable under"
            f" power-of-two input rescaling (failing scales:"
            f" {[r['scale'] for r in bad]}): a hidden absolute-epsilon"
            " threshold or premature rounding makes the result depend on"
            " the input's SCALE, not its order statistics",
            detail={"failing": bad},
        ))
