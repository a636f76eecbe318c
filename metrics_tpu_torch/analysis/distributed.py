"""Pass 3 — distributed-equivalence prover + state-lifecycle analyzer.

Port of ``metrics_tpu/analysis/distributed.py``. Passes 1 and 2 prove
properties of a *single replica's* program: its graph has no host
transfers, its accumulator dtypes are stable, its source respects the
repo invariants. Every scale-out path — multi-tenant vmapped cohorts,
hierarchical sync, async double-buffered dispatch — additionally depends
on invariants those passes cannot see:

* **MTA005 — distributed equivalence.** R replicas that each ``update``
  on a shard and then sync must equal one replica that saw the whole
  batch: ``compute(reduce(states_1..R)) == compute(update-on-concat)``.
  This pass *proves it on concrete probe batches* for R ∈ {1, 2, 4},
  evaluating the real update → ``dist_reduce_fx`` → compute composite on
  explicit per-replica states, on the metric's device. The exact sync tier
  is held to bit-identity — probe batches are **grid-valued** (multiples
  of 1/256; probability rows built from integer multinomials) so floating
  accumulation is exactly associative and a mismatch is structural, not
  rounding; a documented ≤8-ulp re-association allowance covers
  transcendental per-element terms (``log1p`` sums re-associate at the
  last ulp). The bf16/int8 tiers quantize through the REAL codec
  (:mod:`metrics_tpu_torch.parallel.quantize`) and are held to the
  documented per-state bound ``R · absmax/254`` (int8) / ``R · absmax ·
  2⁻⁸`` (bf16). Replica-ORDER dependence (rank-index leakage,
  order-sensitive state) is flagged by re-merging a permutation of the
  same per-replica states.
* **MTA006 — lifecycle soundness.** Each registered state is modeled as
  a reset → update\\* → sync → compute → restore machine: the reset
  default must be the identity of its ``dist_reduce_fx`` (a non-identity
  reset silently corrupts the second sync round by exactly the reset
  value), ``compute`` must never mutate state (verified by before/after
  values on concrete probes AND a trace-time identity check that catches
  bitwise-invisible rewrites; PyTorch adds in-place writes that keep the
  attribute bound to the same tensor, caught by each state tensor's
  ``_version`` in both checks), and ``__qres`` error-feedback residual
  companions must be coherent (paired, zero-default, f32, shape-matched).
* **MTA007 — donation lifetime.** A state that passes through the update
  (and hence the step program) unchanged — its output is its input, or an
  in-place write into it — hands the input buffer back as the "new"
  state: the engine's buffers and the metric's attributes would share
  storage, and two disjoint buffer generations are structurally
  impossible for that state. ``load_state_dict`` overrides that import
  checkpoint values without the :func:`~metrics_tpu_torch.metric._device_owned`
  copy are refused statically.

:func:`fingerprint_jaxpr` (the JAX package's name) digests a traced FX
program for the drift sentinel. Its digests leave devices out, so the
card's program and the CPU's digest alike; they differ from the JAX
package's, whose IR is another.
"""
import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.analysis.program import (
    _default_states,
    _fake_trace,
    _np,
    _op_name,
    _outputs,
    _placeholders,
    _storage_root,
    _tensor_leaves,
    _trace_update,
    _update_program,
    iter_eqns,
)
from metrics_tpu_torch.analysis.rules import Finding
from metrics_tpu_torch.metric import _san_allow_ctx
from metrics_tpu_torch.parallel import quantize as _q
from metrics_tpu_torch.utilities.data import (
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
)

__all__ = [
    "REPLICA_COUNTS",
    "check_donation_lifetime",
    "check_lifecycle",
    "check_replica_equivalence",
    "fingerprint_jaxpr",
    "grid_probe_args",
    "quantized_state_tolerance",
]

#: virtual replica meshes the equivalence prover evaluates
REPLICA_COUNTS = (1, 2, 4)

#: probe grid: values are integer multiples of 1/256, so partial sums of
#: products/differences stay exactly representable in f32 and split-sum
#: order cannot change the result
_GRID = 256.0

#: re-association allowance for exact-tier floating states whose
#: per-element terms are transcendental (log1p et al.): IEEE addition of
#: identical term vectors in a different order differs by at most a few
#: ulps — 8 is generous and still 10^5 below any structural mismatch
_ULP_SLACK = 8.0


# ---------------------------------------------------------------------------
# probe construction
# ---------------------------------------------------------------------------
def _is_float_array(a: Any) -> bool:
    return isinstance(a, torch.Tensor) and a.is_floating_point()


def grid_probe_args(args: Sequence[Any], seed: int = 0x5D) -> Tuple[Any, ...]:
    """A probe batch shaped like ``args`` whose float leaves live on the
    1/256 grid (probability-row leaves are rebuilt from integer
    multinomials, so rows still sum to exactly 1.0). Integer leaves pass
    through unchanged. On grid values every sum the registry's update
    programs accumulate is exact in f32, which is what lets MTA005 demand
    bit-identity from the exact tier. The values are the JAX package's
    (the same numpy draws), on each leaf's device."""
    rng = np.random.RandomState(seed)
    out: List[Any] = []
    for a in args:
        if not _is_float_array(a):
            out.append(a)
            continue
        vals = _np(a)
        shape = tuple(vals.shape)
        rowsum = vals.sum(axis=-1) if vals.ndim >= 2 else None
        if (
            vals.ndim >= 2
            and bool((vals >= 0).all())
            and rowsum is not None
            and bool(np.allclose(rowsum, 1.0, atol=1e-4))
        ):
            # probability rows: integer compositions of 256 divided by 256
            # sum to exactly 1.0 and sit on the grid
            flat = np.stack(
                [
                    rng.multinomial(int(_GRID), np.ones(shape[-1]) / shape[-1])
                    for _ in range(int(np.prod(shape[:-1])))
                ]
            )
            g = (flat / _GRID).reshape(shape)
        else:
            lo = int(np.floor(float(vals.min()) * _GRID))
            hi = int(np.ceil(float(vals.max()) * _GRID))
            g = rng.randint(lo, max(hi, lo + 1) + 1, size=shape) / _GRID
        out.append(torch.as_tensor(g).to(device=a.device, dtype=a.dtype))
    return tuple(out)


def _shard_args(args: tuple, kwargs: dict, replicas: int) -> Optional[List[Tuple[tuple, dict]]]:
    """Split the probe batch into ``replicas`` equal shards along axis 0,
    or None when the batch is not evenly shardable (leading dims disagree
    or do not divide)."""
    leaves = _tensor_leaves((args, kwargs))
    if not leaves:
        return None
    n0 = leaves[0].shape[0] if leaves[0].ndim else 0
    if not n0 or n0 % replicas:
        return None
    for leaf in leaves:
        if not leaf.ndim or leaf.shape[0] != n0:
            return None
    per = n0 // replicas

    def cut(tree: Any, r: int) -> Any:
        if isinstance(tree, torch.Tensor):
            return tree[r * per:(r + 1) * per]
        if isinstance(tree, dict):
            return {k: cut(v, r) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(cut(v, r) for v in tree)
        return tree

    return [(cut(args, r), cut(kwargs, r)) for r in range(replicas)]


def _muted():
    from metrics_tpu_torch.observability import trace as _trace

    return _trace.muted()


def _states_after_update(metric, args: tuple, kwargs: dict) -> Dict[str, Any]:
    """One update on fresh default state (the per-replica leg of the
    composite); live metric state is snapshot/restored around it. The
    probe is no step of the metric's: its telemetry hooks are muted."""
    with _muted():
        return _update_program(metric)(_default_states(metric), args, kwargs)


def _compute_on_states(metric, states: Dict[str, Any]) -> Any:
    """``compute`` evaluated on an explicit state dict (epoch-end
    semantics), leaving the live metric untouched. Telemetry is muted and
    MetricSan's allow scope open: the probe is no step and no violation."""
    saved = metric._snapshot_state()
    try:
        with _muted(), _san_allow_ctx():
            for k, v in states.items():
                setattr(metric, k, v)
            metric._computed = None
            return metric.compute()
    finally:
        metric._restore_state(saved)
        metric._computed = None


# ---------------------------------------------------------------------------
# comparison machinery
# ---------------------------------------------------------------------------
def quantized_state_tolerance(stacked: np.ndarray, precision: str, replicas: int) -> float:
    """The documented per-element bound for a quantized R-replica merge:
    each replica contributes at most ``absmax/254`` (int8, half a
    quantization step) or ``absmax·2⁻⁸`` (bf16, one round) of error; R
    contributions sum; ×4 covers block-padding edges, exactly like the
    MTA004 probe."""
    absmax = float(np.abs(stacked).max()) if stacked.size else 0.0
    per_row = absmax / 254.0 if precision == "int8" else absmax * 2.0 ** -8
    return 4.0 * replicas * per_row + 1e-6


def _exact_state_close(a: np.ndarray, b: np.ndarray) -> Tuple[bool, bool]:
    """``(within_allowance, bit_identical)`` for an exact-tier state pair:
    bitwise first, then the ≤8-ulp re-association allowance for floating
    states (identical term vectors summed in a different order)."""
    if a.shape != b.shape:
        return False, False
    if np.array_equal(a, b):
        return True, True
    if a.dtype.kind != "f":
        return False, False
    a64 = np.asarray(a, dtype=np.float64)
    b64 = np.asarray(b, dtype=np.float64)
    scale = np.maximum(np.maximum(np.abs(a64), np.abs(b64)), 1.0)
    tol = _ULP_SLACK * float(np.finfo(a.dtype).eps) * scale
    return bool(np.all(np.abs(a64 - b64) <= tol)), False


def _value_leaves(value: Any) -> List[np.ndarray]:
    if isinstance(value, (tuple, list)):
        return [x for v in value for x in _value_leaves(v)]
    if isinstance(value, dict):
        return [x for k in sorted(value) for x in _value_leaves(value[k])]
    if value is None:
        return []
    return [_np(value)]


def _max_value_delta(a: Any, b: Any) -> float:
    la, lb = _value_leaves(a), _value_leaves(b)
    if len(la) != len(lb):
        return float("inf")
    worst = 0.0
    for x, y in zip(la, lb):
        if x.shape != y.shape:
            return float("inf")
        if x.size:
            worst = max(
                worst,
                float(np.abs(x.astype(np.float64) - y.astype(np.float64)).max()),
            )
    return worst


def _merge_replica_states(
    metric,
    per_replica: List[Dict[str, Any]],
    order: Optional[Sequence[int]] = None,
    precisions: Optional[Dict[str, str]] = None,
) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """The cross-replica sync composite on explicit per-replica states:
    stack each non-residual state over the (virtual) world and fold it
    with its registered reduction — quantizing each replica's
    contribution through the real wire codec for states on a quantized
    tier, exactly as ``Metric._sync_dist`` would. Returns the merged
    state dict (residual companions at their defaults) and the per-state
    documented tolerance (0.0 for exact states). ``precisions`` overrides
    the metric's registered tiers (``{}`` = force-exact: the hierarchy's
    level-0 merge)."""
    order = list(order) if order is not None else list(range(len(per_replica)))
    precisions = metric.sync_precisions() if precisions is None else precisions
    residual_names = set(metric._sync_residual_names())
    merged: Dict[str, Any] = {}
    tols: Dict[str, float] = {}
    for sname in metric._defaults:
        if sname in residual_names:
            merged[sname] = metric._defaults[sname].clone()
            continue
        rows = [per_replica[r][sname] for r in order]
        stacked = torch.stack(rows)
        precision = precisions.get(sname, "exact")
        if precision != "exact":
            merged[sname] = _q.merge_dequantized(
                [_q.quantize_payload(row, precision) for row in rows],
                tuple(rows[0].shape),
                metric._defaults[sname].dtype,
            )
            tols[sname] = quantized_state_tolerance(_np(stacked), precision, len(rows))
        else:
            red = metric._reductions[sname]
            merged[sname] = red(stacked) if red is not None else stacked
            tols[sname] = 0.0
    return merged, tols


def _merge_replica_states_two_level(
    metric,
    per_replica: List[Dict[str, Any]],
    num_slices: int = 2,
) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """The HIERARCHICAL sync composite on explicit per-replica states,
    mirroring ``hierarchy.sync_states`` under the default
    ``level_precisions=("exact", None)``: replicas group into
    ``num_slices`` equal slices, each slice folds EXACTLY at level 0 (the
    fast intra-node hop), and the slice partials merge at level 1 under the
    state's registered tier (the slow hop — where int8 + error feedback
    lives). Returns ``(merged, level1_tols)``; the caller compares against
    the flat merge within ``flat_tol + level1_tol`` (both paths approximate
    the same exact sum from different quantization points)."""
    replicas = len(per_replica)
    if replicas % num_slices:
        raise ValueError(
            f"{replicas} replicas do not partition into {num_slices} equal"
            " slices — a truncating split would silently drop trailing"
            " replicas and report bogus divergence"
        )
    slice_size = replicas // num_slices
    partials = [
        _merge_replica_states(
            metric,
            per_replica[s * slice_size : (s + 1) * slice_size],
            precisions={},
        )[0]
        for s in range(num_slices)
    ]
    return _merge_replica_states(metric, partials)


# ---------------------------------------------------------------------------
# MTA005 — distributed equivalence
# ---------------------------------------------------------------------------
def check_replica_equivalence(
    metric,
    args: tuple,
    kwargs: dict,
    findings: List[Finding],
    infos: List[str],
    probe_cache: Optional[Dict[str, Any]] = None,
) -> Optional[Dict[str, Any]]:
    """Prove ``compute(reduce(states_1..R)) == compute(update-on-concat)``
    on concrete probe batches for every R in :data:`REPLICA_COUNTS`, plus
    replica-order independence of the merge. Returns an evidence dict for
    the report (None when the batch shape is not shardable).

    ``probe_cache`` (a per-family dict the registry audit threads through
    the base audit and its ``sync_precision=`` variant audits) memoizes
    the expensive concrete legs — probe construction, the per-replica
    update states, and the full-batch compute. They are identical across
    tiers: ``update`` never writes residual companions, and both the
    comparisons and the merge skip (or default) residuals — only the
    MERGE itself (exact fold vs quantize→dequantize composite) differs
    per tier, and that is exactly what each variant re-evaluates. A probe
    update that raises is reported as an info, not caught into a pass."""
    cls = type(metric).__name__
    cache = probe_cache if probe_cache is not None else {}
    if "probe" in cache:
        probe = cache["probe"]
        on_grid = cache["on_grid"]
        full_states = cache["full_states"]
        if probe is None:
            infos.append(
                f"{cls}: MTA005 probe update failed on the base audit;"
                " distributed equivalence not verified"
            )
            return None
    else:
        try:
            probe = grid_probe_args(args)
            full_states = _states_after_update(metric, probe, kwargs)
            on_grid = True
        except Exception:  # noqa: BLE001 — validation rejected the grid probe
            probe = tuple(args)
            on_grid = False
            try:
                full_states = _states_after_update(metric, probe, kwargs)
            except Exception as err:  # noqa: BLE001 — reported as an info
                cache.update(probe=None, on_grid=False, full_states=None)
                infos.append(
                    f"{cls}: MTA005 probe update failed ({type(err).__name__});"
                    " distributed equivalence not verified"
                )
                return None
        cache.update(probe=probe, on_grid=on_grid, full_states=full_states)
    if "full_value" in cache:
        full_value = cache["full_value"]
    else:
        try:
            full_value = _compute_on_states(metric, full_states)
        except Exception as err:  # noqa: BLE001 — reported as an info
            infos.append(
                f"{cls}: MTA005 compute failed on the probe state"
                f" ({type(err).__name__}); value-level equivalence not verified"
            )
            full_value = None
        cache["full_value"] = full_value

    precisions = metric.sync_precisions()
    residual_names = set(metric._sync_residual_names())
    evidence: Dict[str, Any] = {
        "replicas": [],
        "on_grid": on_grid,
        "bit_identical": True,
        "max_state_err": 0.0,
        "max_value_err": 0.0,
        "quantized_states": sorted(precisions),
    }
    flagged: set = set()

    per_cache = cache.setdefault("per_replica", {})
    topo_flat: Optional[tuple] = None
    for replicas in REPLICA_COUNTS:
        if replicas in per_cache:
            per = per_cache[replicas]
            if per is None:
                continue
        else:
            shards = _shard_args(probe, kwargs, replicas)
            if shards is None:
                per_cache[replicas] = None
                continue
            try:
                per = [_states_after_update(metric, a, k) for a, k in shards]
            except Exception as err:  # noqa: BLE001 — reported as an info
                per_cache[replicas] = None
                infos.append(
                    f"{cls}: MTA005 shard update failed at R={replicas}"
                    f" ({type(err).__name__}); that replica count not verified"
                )
                continue
            per_cache[replicas] = per
        evidence["replicas"].append(replicas)
        merged, tols = _merge_replica_states(metric, per)
        if replicas >= 2 and replicas % 2 == 0:
            # the largest verified EVEN replica count feeds the topology
            # (two-level, 2-slice) equivalence leg below
            topo_flat = (replicas, per, merged, tols)
        permuted, _ = _merge_replica_states(
            metric, per, order=list(reversed(range(replicas)))
        )
        all_bit_identical = True
        for sname in metric._defaults:
            if sname in residual_names:
                continue
            a = _np(full_states[sname])
            b = _np(merged[sname])
            c = _np(permuted[sname])
            tol = tols.get(sname, 0.0)
            if a.shape != b.shape:
                err, ok, order_ok = float("inf"), False, b.shape == c.shape
            elif tol > 0.0:  # quantized tier: the documented bound is the contract
                err = float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max()) if a.size else 0.0
                # integer states re-round onto their lattice after the merge,
                # so a sub-half-step reconstruction lands exactly; allow the
                # rounding grain on top of the analog bound
                bound = max(tol, 1.0) if np.issubdtype(a.dtype, np.integer) else tol
                ok = err <= bound
                order_ok = bool(
                    np.all(np.abs(b.astype(np.float64) - c.astype(np.float64)) <= bound)
                )
                evidence["bit_identical"] = False
            else:
                err = float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max()) if a.size else 0.0
                ok, bit = _exact_state_close(a, b)
                order_ok = _exact_state_close(b, c)[0]
                if not bit:
                    evidence["bit_identical"] = False
                    all_bit_identical = False
            if tol > 0.0 or a.shape != b.shape:
                all_bit_identical = False
            evidence["max_state_err"] = max(evidence["max_state_err"], err)
            key = ("split", sname)
            if not ok and key not in flagged:
                flagged.add(key)
                tier = precisions.get(sname, "exact")
                findings.append(Finding(
                    "MTA005", f"{cls}.{sname}",
                    f"R={replicas} sync-then-compute diverges from"
                    f" compute-on-concat: merged state differs from the"
                    f" single-replica state by {err:.4g}"
                    + (f" (documented {tier} bound {tol:.4g})" if tol else
                       " (exact tier: must be bit-identical on grid probes)")
                    + " — data parallelism changes this metric's answer",
                    detail={"replicas": replicas, "tier": tier, "err": err},
                ))
            okey = ("order", sname)
            if not order_ok and okey not in flagged:
                flagged.add(okey)
                findings.append(Finding(
                    "MTA005", f"{cls}.{sname}",
                    f"merged state depends on replica ORDER at R={replicas}:"
                    " reduce(states) != reduce(permuted states) — axis-index"
                    " leakage or order-sensitive state; every replica layout"
                    " computes a different answer",
                    detail={"replicas": replicas, "kind": "order"},
                ))
        if all_bit_identical:
            # compute is a pure function of the states: bit-identical
            # inputs give bit-identical values — the merged compute would
            # re-prove a tautology, so skip the (eager, expensive) call
            continue
        if full_value is not None:
            try:
                merged_value = _compute_on_states(metric, merged)
            except Exception as err:  # noqa: BLE001 — reported as an info
                infos.append(
                    f"{cls}: MTA005 compute failed on the merged R={replicas}"
                    f" state ({type(err).__name__})"
                )
                continue
            vdelta = _max_value_delta(full_value, merged_value)
            evidence["max_value_err"] = max(evidence["max_value_err"], vdelta)
            if not precisions:
                # exact tier: states already proven (bit-)identical, so the
                # value check only needs to forgive the ulp allowance as
                # amplified by compute; a structural mismatch is orders
                # beyond this
                leaves = _value_leaves(full_value)
                scale = max((float(np.abs(v).max()) for v in leaves if v.size), default=1.0)
                vkey = ("value",)
                if vdelta > 1e-5 * max(scale, 1.0) + 1e-6 and vkey not in flagged:
                    flagged.add(vkey)
                    findings.append(Finding(
                        "MTA005", f"{cls}.compute",
                        f"compute on the merged R={replicas} state diverges"
                        f" from compute-on-concat by {vdelta:.4g} though the"
                        " states agree — compute reads something outside the"
                        " registered, reduced state",
                        detail={"replicas": replicas, "err": vdelta},
                    ))
    # ---- topology equivalence: the two-level (hierarchical) composite
    # must agree with the flat path on the SAME per-replica states —
    # bit-identical on the exact tier (grid sums are exactly associative,
    # so re-bracketing by slice cannot move a bit), within the SUMMED
    # per-level documented bounds on quantized tiers (flat quantizes R
    # replica contributions, the hierarchy quantizes num_slices slice
    # partials at level 1; both approximate the same exact sum)
    if topo_flat is not None:
        from metrics_tpu_torch.parallel.hierarchy import two_level_fold

        t_replicas, t_per, flat_merged, flat_tols = topo_flat
        two_merged, two_tols = _merge_replica_states_two_level(
            metric, t_per, num_slices=2
        )
        t_ev: Dict[str, Any] = {
            "replicas": t_replicas,
            "num_slices": 2,
            "bit_identical": True,
            "max_state_err": 0.0,
        }
        for sname in metric._defaults:
            if sname in residual_names:
                continue
            if two_level_fold(metric._reductions.get(sname)) is None or isinstance(
                metric._defaults.get(sname), list
            ):
                # non-fold reductions (mean/cat/custom/None) and list
                # states ride the COMPOSED FLAT gather at runtime
                # (rank-ordered world list): flat semantics by
                # construction, nothing separate to prove
                continue
            a = _np(flat_merged[sname])
            b = _np(two_merged[sname])
            tol = flat_tols.get(sname, 0.0) + two_tols.get(sname, 0.0)
            err = (
                float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())
                if a.size and a.shape == b.shape
                else (0.0 if a.shape == b.shape else float("inf"))
            )
            if a.shape != b.shape:
                ok = False
            elif tol > 0.0:
                # both results land back on the state's dtype; integer
                # states re-round, so the two roundings may differ by one
                # grain on top of the analog bound
                bound = tol + (1.0 if np.issubdtype(a.dtype, np.integer) else 0.0)
                ok = err <= bound
                t_ev["bit_identical"] = False
            else:
                ok, bit = _exact_state_close(a, b)
                if not bit:
                    t_ev["bit_identical"] = False
            t_ev["max_state_err"] = max(t_ev["max_state_err"], err)
            key = ("topology", sname)
            if not ok and key not in flagged:
                flagged.add(key)
                tier = precisions.get(sname, "exact")
                findings.append(Finding(
                    "MTA005", f"{cls}.{sname}",
                    f"two-level (2-slice) hierarchical reduction diverges from"
                    f" the flat path at R={t_replicas}: |flat - hierarchical| ="
                    f" {err:.4g}"
                    + (f" (summed per-level {tier} bound {tol:.4g})" if tol else
                       " (exact tier: must be bit-identical on grid probes)")
                    + " — moving this metric onto a hierarchical topology"
                    " changes its answer",
                    detail={
                        "replicas": t_replicas,
                        "num_slices": 2,
                        "tier": tier,
                        "err": err,
                    },
                ))
        evidence["topology"] = t_ev
    if not evidence["replicas"]:
        infos.append(
            f"{cls}: MTA005 batch not shardable into"
            f" {REPLICA_COUNTS} replicas; distributed equivalence not verified"
        )
        return None
    return evidence


# ---------------------------------------------------------------------------
# MTA006 — state lifecycle soundness
# ---------------------------------------------------------------------------
def _reduction_identity_violation(red: Callable, default: Any, probe: Any) -> Optional[str]:
    """Is ``default`` the identity of ``red``? Probes
    ``red(stack([default, v])) == v`` in both orders with a realistic v.
    None = sound (or not applicable)."""
    if red is None or red is dim_zero_cat or red is dim_zero_mean:
        # cat: the empty list IS the concat identity; mean: has no
        # identity by construction — its soundness (paired counts) is
        # MTA004's contract, not a reset question
        return None
    d = default
    v = probe.to(d.device)
    if v.shape != d.shape:
        return None
    if bool(torch.all(v == d)):
        v = v + torch.ones((), dtype=d.dtype, device=d.device)  # need a probe distinct from the default
    # probe BOTH sides of the default: a zero-seeded `max` looks like an
    # identity against positive states and only betrays itself on negative
    # ones (and vice versa for `min`) — one-sided probing would bless it
    probes = [v]
    if d.dtype not in (torch.uint8, torch.uint16, torch.uint32, torch.uint64, torch.bool):
        probes.append(-v - torch.ones((), dtype=d.dtype, device=d.device))
    for w in probes:
        try:
            fwd = _np(red(torch.stack([d, w])))
            rev = _np(red(torch.stack([w, d])))
        except Exception:  # noqa: BLE001 — MTA004 owns reductions that crash
            return None
        want = _np(w)
        for got, side in ((fwd, "reduce([reset, state])"), (rev, "reduce([state, reset])")):
            if got.shape != want.shape or not np.allclose(got, want, rtol=1e-6, atol=1e-7):
                return (
                    f"reset default is not the identity of its dist_reduce_fx:"
                    f" {side} != state (off by"
                    f" {float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max()):.4g})"
                    " — an idle or freshly-reset replica corrupts every"
                    " subsequent sync round by exactly the reset value"
                )
    return None


def _trace_compute_mutations(metric, probe_states: Dict[str, Any]) -> Optional[List[str]]:
    """Trace-time purity check: run ``compute`` under ``make_fx`` with the
    states as fake tensors and report every state whose attribute no longer
    IS the input tensor afterwards, or whose tensor was written in place
    (its ``_version`` moved) — catches rewrites the concrete value check
    cannot see (``self.x = self.x + 0``, ``self.x.add_(0)``). None when the
    compute is untraceable (host densification: concrete check only)."""
    mutated: List[str] = []

    def fn(states):
        saved = metric._snapshot_state()
        try:
            versions = {k: v._version for k, v in states.items()}
            with _san_allow_ctx():
                for k, v in states.items():
                    setattr(metric, k, v)
                metric._computed = None
                value = metric.compute()
            for k in states:
                if getattr(metric, k) is not states[k] or states[k]._version != versions[k]:
                    mutated.append(k)
            return value
        finally:
            metric._restore_state(saved)
            metric._computed = None

    traceable = {
        k: v for k, v in probe_states.items() if not isinstance(v, list)
    }
    if len(traceable) != len(probe_states):
        return None  # list states: tracing compute is not meaningful
    try:
        _fake_trace(fn, (traceable,))
    except Exception:  # noqa: BLE001 — eager-only computes: concrete check only
        return None
    return mutated


def check_lifecycle(
    metric,
    args: tuple,
    kwargs: dict,
    findings: List[Finding],
    infos: List[str],
    residuals_only: bool = False,
    probe_cache: Optional[Dict[str, Any]] = None,
) -> None:
    """MTA006 over every registered state: reset-identity, compute
    purity (concrete values and versions + trace-time identity and
    versions), and residual-companion coherence. ``residuals_only`` limits
    the pass to the probe-independent residual checks — used for
    ``sync_precision=`` variant audits, where reset identity and compute
    purity are already proven on the base family (the tier changes
    neither)."""
    cls = type(metric).__name__
    residual_names = set(metric._sync_residual_names())
    precisions = metric.sync_precisions()

    # --- residual coherence first: it is probe-independent ---------------
    for primary in precisions:
        res = primary + "__qres"
        subject = f"{cls}.{res}"
        if res not in metric._defaults:
            findings.append(Finding(
                "MTA006", subject,
                f"state {primary!r} is on the {precisions[primary]!r} sync"
                " tier but has no registered __qres residual companion;"
                " repeated syncs will drift without error feedback",
            ))
            continue
        rd = metric._defaults[res]
        pd = metric._defaults[primary]
        if rd.dtype != torch.float32 or not bool(torch.all(rd == 0)):
            findings.append(Finding(
                "MTA006", subject,
                "residual companion default must be all-zero f32 (it holds"
                " sub-quantization-step corrections; any other reset value"
                " injects phantom error into the first sync)",
            ))
        elif tuple(rd.shape) != tuple(pd.shape):
            findings.append(Finding(
                "MTA006", subject,
                f"residual companion shape {tuple(rd.shape)} does not match"
                f" its state's {tuple(pd.shape)}; the compensation"
                " cannot describe the quantization error elementwise",
            ))
        if metric._persistent.get(res) != metric._persistent.get(primary):
            findings.append(Finding(
                "MTA006", subject,
                "residual companion persistence differs from its state's: a"
                " checkpoint would restore the state but reset (or orphan)"
                " the compensation it rides with",
            ))
    for sname in metric._defaults:
        if sname.endswith("__qres") and sname not in residual_names:
            findings.append(Finding(
                "MTA006", f"{cls}.{sname}",
                "orphaned __qres state: no sync_precision entry pairs it"
                " with a quantized state, so it is synced (and reduced)"
                " like ordinary state — the residual exemption only covers"
                " registered companions",
            ))

    if residuals_only:
        return

    # --- probe states for the identity + purity checks -------------------
    # the equivalence pass (when it ran) already paid for a grid probe and
    # a full-batch update — reuse them instead of re-running the eager
    # update per family
    cached = probe_cache or {}
    if cached.get("probe") is not None and cached.get("full_states") is not None:
        probe_states = cached["full_states"]
    else:
        try:
            probe_args = grid_probe_args(args) if args else args
            probe_states = _states_after_update(metric, probe_args, kwargs)
        except Exception:  # noqa: BLE001 — validation rejected the grid probe
            try:
                probe_args = tuple(args)
                probe_states = _states_after_update(metric, probe_args, kwargs)
            except Exception as err:  # noqa: BLE001 — reported as an info
                infos.append(
                    f"{cls}: MTA006 probe update failed ({type(err).__name__});"
                    " reset-identity and compute-purity not verified"
                )
                return

    # --- reset value must be the reduction's identity ---------------------
    # a reduction MTA004 already refuted gets ONE diagnosis, not two: the
    # identity question is only meaningful for otherwise-sound reductions
    mta004_subjects = {f.subject for f in findings if f.rule == "MTA004"}
    for sname, red in metric._reductions.items():
        if sname in residual_names or isinstance(metric._defaults[sname], list):
            continue
        if f"{cls}.{sname}" in mta004_subjects:
            continue
        note = _reduction_identity_violation(
            red, metric._defaults[sname], probe_states[sname]
        )
        if note is not None:
            findings.append(Finding("MTA006", f"{cls}.{sname}", note))

    # --- compute purity ---------------------------------------------------
    # compute runs on copies of the probe states (an in-place write must
    # not reach the cached probe), each copy's version read before it
    def copy(v):
        return [x.clone() for x in v] if isinstance(v, list) else v.clone()

    given = {k: copy(v) for k, v in probe_states.items()}
    before = {k: ([_np(x) for x in v] if isinstance(v, list) else _np(v)) for k, v in given.items()}
    versions = {k: v._version for k, v in given.items() if isinstance(v, torch.Tensor)}
    saved = metric._snapshot_state()
    mutated_concrete: List[str] = []
    try:
        with _muted(), _san_allow_ctx():
            for k, v in given.items():
                setattr(metric, k, v)
            metric._computed = None
            metric.compute()
        for k in metric._defaults:
            now = getattr(metric, k)
            if isinstance(before[k], list):
                same = (
                    isinstance(now, list)
                    and len(now) == len(before[k])
                    and all(np.array_equal(_np(a), b) for a, b in zip(now, before[k]))
                )
            else:
                same = (
                    not isinstance(now, list)
                    and np.array_equal(_np(now), before[k])
                    and given[k]._version == versions[k]
                )
            if not same:
                mutated_concrete.append(k)
    except Exception as err:  # noqa: BLE001 — reported as an info
        infos.append(
            f"{cls}: MTA006 compute raised on the probe state"
            f" ({type(err).__name__}); purity not verified"
        )
    finally:
        metric._restore_state(saved)
        metric._computed = None

    mutated_abstract = _trace_compute_mutations(metric, probe_states) or []
    for sname in sorted(set(mutated_concrete) | set(mutated_abstract)):
        findings.append(Finding(
            "MTA006", f"{cls}.{sname}",
            "compute mutates registered state: the state fingerprint"
            " changes across a compute"
            + ("" if sname in mutated_concrete else
               " (trace-time rewrite; bitwise-invisible on this probe)")
            + " — every compute-then-keep-accumulating loop double-counts"
            " or corrupts the epoch state",
            detail={"concrete": sname in mutated_concrete,
                    "abstract": sname in mutated_abstract},
        ))


# ---------------------------------------------------------------------------
# MTA007 — donation lifetime
# ---------------------------------------------------------------------------
def _state_leaf_names(metric) -> List[str]:
    """Names of the metric's state leaves in dict-flatten (sorted-key)
    order — the order their placeholders occupy in a traced
    ``states``-first program."""
    return sorted(metric._defaults)


def _update_passthrough_states(
    metric, args: tuple, kwargs: dict, update_closed: Any = None
) -> List[str]:
    """States whose update-program output IS the corresponding input, or an
    in-place write into it: ``update`` provably never gives them a buffer
    of their own, so the step would hand the input buffer back as the
    'new' state."""
    graph = update_closed
    if graph is None:
        try:
            graph, _ = _trace_update(metric, args, kwargs)
        except Exception:  # noqa: BLE001 — MTA002 owns trace failures
            return []
    names = _state_leaf_names(metric)
    n = len(names)
    residual_names = set(metric._sync_residual_names())
    passthrough = []
    for name, invar, outvar in zip(names, _placeholders(graph)[:n], _outputs(graph)[:n]):
        # residual companions are sync-stream state: update never writes
        # them BY DESIGN, and the engine's merge (prior + zero batch) gives
        # them a fresh buffer at step level, so no hazard exists
        if _storage_root(outvar) is invar and name not in residual_names:
            passthrough.append(name)
    return passthrough


def _donated_passthrough_positions(closed: Any, n_donated: int) -> List[int]:
    """Output positions of a step program that return one of its first
    ``n_donated`` inputs (the states) unchanged, or an in-place write into
    one."""
    donated = set(_placeholders(closed)[:n_donated])
    return [i for i, v in enumerate(_outputs(closed)) if _storage_root(v) in donated]


_SAFE_LOADER_MODULES = ("metrics_tpu_torch.metric", "metrics_tpu_torch.collections")


def _unsafe_load_override(cls: type) -> Optional[type]:
    """The class (if any) whose ``load_state_dict`` override imports
    checkpoint values without the `_device_owned` copy and without
    delegating to the library loader."""
    import inspect

    for klass in cls.__mro__:
        fn = klass.__dict__.get("load_state_dict")
        if fn is None:
            continue
        if klass.__module__ in _SAFE_LOADER_MODULES:
            return None  # first definition found is the library's own
        try:
            src = inspect.getsource(fn)
        except (OSError, TypeError):
            return None  # unverifiable: don't guess
        body = src.replace("def load_state_dict", "", 1)
        if "_device_owned" in body or "load_state_dict" in body:
            # delegates (super()/base .load_state_dict(...)) or copies
            return None
        return klass
    return None


def check_donation_lifetime(
    metric,
    args: tuple,
    kwargs: dict,
    findings: List[Finding],
    infos: List[str],
    engine_closed: Any = None,
    n_donated: int = 0,
    engine_eligible: bool = False,
    update_closed: Any = None,
) -> None:
    """MTA007: buffer lifetime hazards — update/step passthrough
    (engine-eligible metrics only; an eager metric has no engine buffers)
    and device-ownership of checkpoint loads (every metric: resumes feed
    the engine later). ``engine_closed`` / ``update_closed`` are the traced
    step and update graphs."""
    cls = type(metric).__name__
    if engine_eligible:
        for sname in _update_passthrough_states(metric, args, kwargs, update_closed):
            findings.append(Finding(
                "MTA007", f"{cls}.{sname}",
                "update never writes this state (its output IS the donated"
                " input buffer): the compiled step donates it every"
                " dispatch only to hand the same storage back — host"
                " references (defaults, snapshots) die for a state that"
                " never changes, and ping-pong double-buffering cannot give"
                " it two disjoint generations. Make it a plain attribute,"
                " or write it in update",
            ))
        if engine_closed is not None:
            for pos in _donated_passthrough_positions(engine_closed, n_donated):
                findings.append(Finding(
                    "MTA007", f"{cls}.step",
                    f"the donated step program returns donated input buffer"
                    f" (output position {pos}) unchanged — the engine would"
                    " hand freshly-donated storage back as live state",
                    detail={"position": pos},
                ))
    bad = _unsafe_load_override(type(metric))
    if bad is not None:
        findings.append(Finding(
            "MTA007", f"{cls}.load_state_dict",
            f"{bad.__name__}.load_state_dict imports checkpoint values"
            " without the _device_owned copy (and without delegating to the"
            " library loader): loaded buffers alias host storage that the"
            " compiled engine's donation corrupts — the bit-garbled-resume"
            " hazard the durable-session work fixed",
        ))


# ---------------------------------------------------------------------------
# program fingerprints (drift sentinel)
# ---------------------------------------------------------------------------
def _stable_param_repr(value: Any) -> Optional[str]:
    """A process-stable repr for one static argument of a node, or None
    when it cannot be digested deterministically or must stay out of the
    digest. A node argument stands as ``%`` (its shape and dtype are among
    the node's inputs); devices are left out (a card's program and the
    CPU's digest alike); objects whose repr embeds a memory address
    (functions, graph modules) are skipped."""
    if isinstance(value, torch.fx.Node):
        return "%"
    if isinstance(value, torch.device):
        return None
    if isinstance(value, (tuple, list)):
        parts = [_stable_param_repr(v) for v in value]
        if any(p is None for p in parts):
            return None
        return "[" + ",".join(parts) + "]"
    r = repr(value)
    return None if " at 0x" in r else r


def _spec(value: Any) -> str:
    """``shape/dtype`` of a node's traced value (each item of a tuple)."""
    if isinstance(value, (tuple, list)):
        return ",".join(_spec(v) for v in value)
    if isinstance(value, torch.Tensor):
        return f"{tuple(value.shape)}/{str(value.dtype).replace('torch.', '')}"
    return "?"


def fingerprint_jaxpr(closed: Any) -> str:
    """A stable digest of a traced FX program's structure: every
    ``call_function`` node's op × input shapes and dtypes × output shapes
    and dtypes × static arguments, in program order, nested graphs
    included. Value-independent — two traces of the same program at the
    same shapes digest identically — so a digest change means the
    metric's PROGRAM changed. Node names, anything with a memory address,
    and devices are left out. Static arguments matter: an axis flip or a
    permutation can leave every shape identical while changing the
    computation. The digests are the port's own: they never equal the JAX
    package's, whose IR is another."""
    h = hashlib.sha256()
    for node in iter_eqns(closed):
        ins = ",".join(_spec(a.meta.get("val")) for a in node.all_input_nodes)
        outs = _spec(node.meta.get("val"))
        params = [
            f"{i}={rep}" for i, a in enumerate(node.args)
            if not isinstance(a, torch.fx.Node) and (rep := _stable_param_repr(a)) is not None
        ]
        params += [
            f"{k}={rep}" for k in sorted(node.kwargs)
            if (rep := _stable_param_repr(node.kwargs[k])) is not None
        ]
        h.update(f"{_op_name(node)}({ins})->({outs})[{';'.join(params)}];".encode())
    return h.hexdigest()[:16]
