"""The port's lint pass (``metrics_tpu_torch/analysis/lint.py``) against the
JAX package's, on the CPU.

Every case of ``tests/analysis/test_lint.py`` is mirrored under its own
name. The snippets of MTL103–MTL107 (and of the suppression syntax) go
through both linters, which must give the same ``(rule, line, suppressed)``
findings. MTL101 and MTL102 speak of PyTorch's idioms in the port (host
reads in a path a CUDA graph captures; graph capture or ``torch.compile``
outside ``engine.py``), so their snippets are written in those idioms and
their expectations are written out; where a suppression case needs a
finding to suppress, the JAX package's bare ``jax.jit`` and the port's bare
``torch.compile`` stand on the same line. Last, both linters run over the
port's own tree and agree finding for finding on MTL103–MTL107.
"""
import os
import textwrap

import pytest

from metrics_tpu.analysis import lint as jax_lint
from metrics_tpu.analysis import rules as jax_rules
from metrics_tpu_torch.analysis.lint import default_lint_root, lint_paths, lint_source
from metrics_tpu_torch.analysis.rules import parse_allow_comments

PORT_ROOT = default_lint_root()


def _lint(code, rel_path="pkg/mod.py"):
    return lint_source(textwrap.dedent(code), rel_path)


def _rules(findings, include_suppressed=False):
    return sorted(f.rule for f in findings if include_suppressed or not f.suppressed)


def _triples(findings):
    return [(f.rule, f.detail.get("line"), f.suppressed) for f in findings]


def _both(code, torch_code=None, rel_path="pkg/mod.py"):
    """Lint ``code`` with the JAX package's linter and ``torch_code``
    (default: the same snippet) with the port's; both must give the same
    findings. Returns the port's."""
    jax_found = jax_lint.lint_source(textwrap.dedent(code), rel_path)
    port_found = lint_source(textwrap.dedent(torch_code if torch_code is not None else code), rel_path)
    assert _triples(port_found) == _triples(jax_found)
    return port_found


# ---------------------------------------------------------------------------
# MTL101 — host ops in captured paths (PyTorch's idioms)
# ---------------------------------------------------------------------------
def test_numpy_in_update_method_fires():
    code = """
    import numpy as np
    class Foo:
        def update(self, preds):
            return np.asarray(preds)
    """
    assert _rules(_lint(code)) == ["MTL101"]


def test_numpy_alias_is_tracked_per_module():
    code = """
    import numpy as xnp
    class Foo:
        def forward(self, preds):
            return xnp.asarray(preds)
    """
    assert _rules(_lint(code)) == ["MTL101"]


def test_from_numpy_import_in_update_fires():
    """``from numpy import asarray`` is the same host op as ``np.asarray``:
    the bare-name spelling must not escape MTL101."""
    code = """
    from numpy import asarray as host_asarray
    class Foo:
        def update(self, preds):
            return host_asarray(preds)
    """
    assert _rules(_lint(code)) == ["MTL101"]


def test_from_numpy_import_outside_traced_scope_is_fine():
    code = """
    from numpy import asarray
    def helper(x):
        return asarray(x)
    class Foo:
        def compute(self):
            return asarray([1.0])
    """
    assert _rules(_lint(code)) == []


def test_numpy_outside_traced_scope_is_fine():
    code = """
    import numpy as np
    def helper(x):
        return np.asarray(x)
    def _foo_compute(x):
        return x.cpu().numpy().tolist()
    class Foo:
        def compute(self):
            return np.zeros(3) + self.acc.item()
    """
    assert _rules(_lint(code)) == []


def test_item_and_cast_in_jitted_function_fire():
    """A function handed to ``torch.compile``, as a decorator or as a call
    argument, is a captured path; each host read fires once. In
    ``engine.py`` (the capture home) no MTL102 joins them."""
    code = """
    import torch
    @torch.compile
    def f(x):
        return x.item() + float(x)
    def g(x):
        return x.cpu().numpy() + x.tolist()
    g_compiled = torch.compile(g)
    class Foo:
        def _step(self, x):
            return bool(x.any())
        def build(self):
            return torch.compile(self._step)
    """
    assert _rules(_lint(code, rel_path="engine.py")) == ["MTL101"] * 6
    assert _rules(_lint(code)) == ["MTL101"] * 6 + ["MTL102"] * 3


def test_is_concrete_guard_exempts_value_probes():
    code = """
    class Foo:
        def update(self, x):
            if _is_concrete(x):
                lo = float(x.min())
                hi = x.max().item()
            if debug_enabled() and _is_concrete(x):
                hi = int(x.max())
    """
    assert _rules(_lint(code)) == []


def test_guard_does_not_leak_into_else_branch():
    code = """
    class Foo:
        def update(self, x):
            if _is_concrete(x):
                pass
            else:
                lo = float(x)
    """
    assert _rules(_lint(code)) == ["MTL101"]


def test_negated_guard_body_runs_under_tracing_and_fires():
    """``if not _is_concrete(x):`` — the body runs precisely while a graph
    is being captured, so host ops there are the exact bug MTL101 exists to
    catch; guard detection must be polarity-aware, not mention-based."""
    code = """
    import numpy as np
    class Foo:
        def update(self, x):
            if not _is_concrete(x):
                y = np.asarray(x)
                return float(x)
            return x
    """
    assert _rules(_lint(code)) == ["MTL101", "MTL101"]


def test_or_compound_guard_does_not_exempt_body():
    """``_is_concrete(x) or flag`` can be true under capture (flag=True), so
    the body is NOT a concrete-only region."""
    code = """
    class Foo:
        def update(self, x, flag):
            if _is_concrete(x) or flag:
                return float(x)
    """
    assert _rules(_lint(code)) == ["MTL101"]


def test_negated_guard_else_branch_is_exempt():
    """The orelse of a negated guard (and of the repo's
    ``if not (_is_concrete(a) and _is_concrete(b)): return None`` idiom)
    only runs on concrete values."""
    code = """
    def _foo_update(preds, target):
        if not (_is_concrete(preds) and _is_concrete(target)):
            pass
        else:
            lo = float(preds.min())
    """
    assert _rules(_lint(code)) == []


def test_static_argnames_are_exempt():
    """The port's counterpart of a jit-static argument: a parameter
    annotated with a host type (``int``, ``bool``, ``Optional[float]``)."""
    code = """
    from typing import Optional
    import torch
    def _foo_update(x: torch.Tensor, k: int, flag: bool, threshold: Optional[float] = None):
        start = 1 - int(bool(flag))
        return x[:int(k)] * start * float(threshold or 0.5)
    """
    assert _rules(_lint(code)) == []


def test_static_argnums_resolve_to_positional_names():
    """Positional, keyword-only and string annotations all count: a cast of
    a host-annotated value is no device read."""
    code = """
    import torch
    class Foo:
        def update(self, x: "torch.Tensor", k: "int", *, scale: float = 1.0):
            return x[:int(k)] * float(scale)
    """
    assert _rules(_lint(code)) == []


def test_static_argnums_do_not_exempt_traced_positions():
    """A parameter annotated as a tensor (or as ``Any``, or not at all) may
    hold a tensor: its cast fires."""
    code = """
    from typing import Any, Union
    import torch
    def _foo_update(x: torch.Tensor, k: int, y: Any, z: Union[int, torch.Tensor], w):
        return float(x) + int(k) + int(y) + int(z) + int(w)
    """
    assert _rules(_lint(code)) == ["MTL101"] * 4


def test_callback_body_is_host_code_by_contract():
    """The function argument of ``torch.compiler.disable`` runs eagerly on
    the host (a graph break), as a JAX callback's body does; so does a
    function it decorates."""
    code = """
    import numpy as np
    import torch
    class Foo:
        def update(self, x):
            y = torch.compiler.disable(lambda v: np.asarray(v))(x)
            @torch._dynamo.disable
            def host(v):
                return float(v) + v.item()
            return host(y)
    """
    assert _rules(_lint(code)) == []


def test_bare_name_callback_import_is_also_exempt():
    """``from torch.compiler import disable`` spells the same contract."""
    code = """
    import numpy as np
    from torch.compiler import disable
    class Foo:
        def update(self, x):
            return disable(lambda v: np.asarray(v))(x)
    """
    assert _rules(_lint(code)) == []


def test_shape_metadata_reads_are_static_under_jit():
    """``x.shape``/``x.ndim``/``x.dtype``/``x.device`` and ``x.dim()``,
    ``x.size()``, ``x.numel()`` are host values even on a tensor being
    captured: casting them must not fire MTL101."""
    code = """
    import torch
    def _foo_update(x):
        scale = float(x.shape[0])
        rank = int(x.ndim) + int(x.dim())
        wide = bool(x.dtype.is_floating_point) and bool(x.device.type == "cuda")
        return x * scale * rank * wide

    class Foo:
        def update(self, preds):
            n = float(preds.size(0) * preds.size()[1])
            return preds / n / float(preds.numel())
    """
    assert _rules(_lint(code)) == []


def test_len_of_traced_value_is_static_under_jit():
    """``len(x)`` of a tensor reads ``shape[0]``: a host int, the same
    static category as ``.shape`` itself."""
    code = """
    class Foo:
        def forward(self, x):
            return x.sum() / float(len(x))
    """
    assert _rules(_lint(code)) == []


def test_value_reads_next_to_shape_reads_still_fire():
    code = """
    class Foo:
        def update(self, x):
            return float(x.shape[0] + x[0]) + int(x.size(0) * x.sum())
    """
    assert _rules(_lint(code)) == ["MTL101", "MTL101"]


# ---------------------------------------------------------------------------
# MTL102 — graph capture or compilation outside engine.py
# ---------------------------------------------------------------------------
def test_bare_jit_fires_everywhere_but_its_home():
    code = """
    import torch
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        pass
    f = torch.compile(lambda x: x)
    g = torch.cuda.make_graphed_callables(f, (torch.zeros(1),))
    """
    assert _rules(_lint(code)) == ["MTL102"] * 4
    assert _rules(_lint(code, rel_path="engine.py")) == []
    assert _rules(_lint(code, rel_path="serving/async_engine.py")) == ["MTL102"] * 4


def test_partial_jit_decorator_fires_once():
    code = """
    import torch
    from functools import partial
    @partial(torch.compile, mode="reduce-overhead")
    def f(x, k):
        return x
    """
    assert _rules(_lint(code)) == ["MTL102"]
    imported = """
    from torch.cuda import CUDAGraph as Graph
    g = Graph()
    """
    assert _rules(_lint(imported)) == ["MTL102"]


def test_tpu_jit_is_the_sanctioned_spelling():
    """Hot paths capture through the step engine: a compiled collection or
    a cohort names no capture API."""
    code = """
    from metrics_tpu_torch import Accuracy, MetricCohort, MetricCollection
    collection = MetricCollection([Accuracy()], compiled=True)
    cohort = MetricCohort(collection, tenants=4)
    graph_count = torch.cuda.graph_pool_handle
    """
    assert _rules(_lint(code)) == []


# ---------------------------------------------------------------------------
# MTL103 — step-rate warnings
# ---------------------------------------------------------------------------
def test_warn_in_update_method_and_update_functional_fire():
    code = """
    import warnings
    def _foo_update(x):
        rank_zero_warn("every step")
    class Foo:
        def update(self, x):
            warnings.warn("every step")
        def forward(self, x):
            rank_zero_warn("every step")
    """
    assert _rules(_both(code)) == ["MTL103", "MTL103", "MTL103"]


def test_warn_once_and_cold_paths_are_fine():
    code = """
    def _foo_update(x):
        warn_once("rate limited", key="k")
    def _foo_compute(x):
        rank_zero_warn("epoch-end is cold")
    class Foo:
        def __init__(self):
            rank_zero_warn("init-time is cold")
    """
    assert _rules(_both(code)) == []


# ---------------------------------------------------------------------------
# MTL104 — unreduced array states
# ---------------------------------------------------------------------------
def test_array_state_without_reduction_fires():
    code = """
    class Foo:
        def __init__(self):
            self.add_state("acc", default=torch.zeros(3))
            self.add_state("acc2", torch.zeros(3), None)
            self.add_state("acc3", default=torch.zeros(3), dist_reduce_fx=None)
    """
    assert _rules(_both(code)) == ["MTL104", "MTL104", "MTL104"]


def test_list_states_and_named_reductions_are_fine():
    code = """
    class Foo:
        def __init__(self, fx):
            self.add_state("cat", default=[], dist_reduce_fx=None)
            self.add_state("cat2", default=[])
            self.add_state("acc", default=torch.zeros(3), dist_reduce_fx="sum")
            self.add_state("acc2", default=torch.zeros(3), dist_reduce_fx=fx)
    """
    assert _rules(_both(code)) == []


# ---------------------------------------------------------------------------
# suppression syntax
# ---------------------------------------------------------------------------
def test_parse_allow_comments():
    source = "x = 1\n# metrics-tpu: allow(MTL101)\ny = 2  # metrics-tpu: allow(MTA001, MTL104)\n"
    allow = parse_allow_comments(source)
    assert allow == {2: {"MTL101"}, 3: {"MTA001", "MTL104"}}
    assert allow == jax_rules.parse_allow_comments(source)


@pytest.mark.parametrize(
    "placement",
    ["trailing", "line-above", "comment-block"],
    ids=["trailing", "line-above", "comment-block"],
)
def test_allow_comment_suppresses(placement):
    def body(call):
        if placement == "trailing":
            return f"    f = {call}(lambda x: x)  # metrics-tpu: allow(MTL102)"
        if placement == "line-above":
            return f"    # metrics-tpu: allow(MTL102)\n    f = {call}(lambda x: x)"
        return (
            "    # metrics-tpu: allow(MTL102) — rationale line one\n"
            "    # continues on a second comment line\n"
            f"    f = {call}(lambda x: x)"
        )

    findings = _both(
        "import jax\nif True:\n" + body("jax.jit") + "\n",
        "import torch\nif True:\n" + body("torch.compile") + "\n",
    )
    assert [f.rule for f in findings] == ["MTL102"]
    assert findings[0].suppressed


def test_allow_syntax_in_strings_is_not_a_suppression():
    """Docstrings that *document* the allow syntax must not widen anyone's
    suppression set: only real ``#`` comment tokens count."""
    code = (
        "def f():\n"
        '    """Suppress with # metrics-tpu: allow(MTA001)."""\n'
        '    s = "# metrics-tpu: allow(MTL102)"\n'
        "    return s\n"
        "# metrics-tpu: allow(MTL104)\n"
        "x = 1\n"
    )
    assert parse_allow_comments(code) == {5: {"MTL104"}}
    assert parse_allow_comments(code) == jax_rules.parse_allow_comments(code)


def test_allow_comment_is_rule_specific():
    findings = _both(
        "import jax\nf = jax.jit(lambda x: x)  # metrics-tpu: allow(MTL104)\n",
        "import torch\nf = torch.compile(lambda x: x)  # metrics-tpu: allow(MTL104)\n",
    )
    # the wrong-rule allow suppresses nothing: the MTL102 finding stays
    # live AND the useless allow is itself flagged stale (MTL105)
    assert [f.rule for f in findings] == ["MTL102", "MTL105"]
    assert not findings[0].suppressed and not findings[1].suppressed


# ---------------------------------------------------------------------------
# MTL105 — stale suppressions (unused-noqa analogue)
# ---------------------------------------------------------------------------
def test_used_allow_is_not_stale():
    findings = _both(
        "import jax\nf = jax.jit(lambda x: x)  # metrics-tpu: allow(MTL102)\n",
        "import torch\nf = torch.compile(lambda x: x)  # metrics-tpu: allow(MTL102)\n",
    )
    assert [f.rule for f in findings] == ["MTL102"]
    assert findings[0].suppressed  # used: no MTL105


def test_stale_allow_on_clean_line_flags():
    findings = _both("x = 1  # metrics-tpu: allow(MTL103)\n")
    assert [f.rule for f in findings] == ["MTL105"]
    assert "MTL103" in findings[0].message
    assert findings[0].detail["line"] == 1


def test_stale_allow_in_comment_block_flags_at_the_comment_line():
    code = (
        "# metrics-tpu: allow(MTL102) — rationale that no longer applies\n"
        "# (the capture below was moved into the engine long ago)\n"
        "x = 1\n"
    )
    findings = _both(code)
    assert [f.rule for f in findings] == ["MTL105"]
    assert findings[0].detail["line"] == 1


def test_mta_allows_are_exempt_from_lint_staleness():
    """Class-body MTA allows belong to the program audit (which runs its
    own staleness check); the lint pass must not second-guess them."""
    code = (
        "class Foo:\n"
        "    # metrics-tpu: allow(MTA001) — program-audit suppression\n"
        "    pass\n"
    )
    assert _both(code) == []


def test_mtl105_is_itself_suppressible():
    findings = _both("x = 1  # metrics-tpu: allow(MTL103, MTL105)\n")
    assert [f.rule for f in findings] == ["MTL105"]
    assert findings[0].suppressed


def test_one_use_marks_only_its_own_comment():
    """Two allows for the same rule, one used and one stale: staleness is
    tracked per comment line, not per rule."""
    findings = _both(
        "import jax\n"
        "f = jax.jit(lambda x: x)  # metrics-tpu: allow(MTL102)\n"
        "y = 2  # metrics-tpu: allow(MTL102)\n",
        "import torch\n"
        "f = torch.compile(lambda x: x)  # metrics-tpu: allow(MTL102)\n"
        "y = 2  # metrics-tpu: allow(MTL102)\n",
    )
    assert [f.rule for f in findings] == ["MTL102", "MTL105"]
    assert findings[0].suppressed
    assert findings[1].detail["line"] == 3


# ---------------------------------------------------------------------------
# MTL106 — thread-shared state (pass 4's lint leg)
# ---------------------------------------------------------------------------
def test_unlocked_write_to_thread_shared_attr_fires():
    code = """
    import threading
    class Worker:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0
        def start(self):
            threading.Thread(target=self._run, daemon=True).start()
        def _run(self):
            self.count = self.count + 1
        def bump(self):
            self.count = self.count + 1
    """
    findings = _both(code)
    assert _rules(findings) == ["MTL106", "MTL106"]
    assert all("count" in f.message for f in findings)


def test_locked_writes_to_shared_attr_are_clean():
    code = """
    import threading
    class Worker:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0
        def start(self):
            threading.Thread(target=self._run, daemon=True).start()
        def _run(self):
            with self._lock:
                self.count = self.count + 1
        def bump(self):
            with self._lock:
                self.count = self.count + 1
    """
    assert _rules(_both(code)) == []


def test_init_writes_are_exempt_and_single_side_attrs_are_not_shared():
    """__init__ happens-before the spawn; an attr only the worker touches
    has a single owning thread — neither is a race."""
    code = """
    import threading
    class Worker:
        def __init__(self):
            self.count = 0
            self.state = "idle"
        def start(self):
            threading.Thread(target=self._run).start()
        def _run(self):
            self.progress = 1  # worker-only: single owner
    """
    assert _rules(_both(code)) == []


def test_reachability_follows_the_call_graph_from_the_spawn_site():
    """The racy write sits two calls deep below the thread target; the
    analysis must walk the call graph, not just the target body."""
    code = """
    import threading
    class Worker:
        def start(self):
            threading.Thread(target=self._run).start()
        def _run(self):
            self._step()
        def _step(self):
            self.progress = self.progress + 1
        def report(self):
            self.progress = 0
    """
    assert _rules(_both(code)) == ["MTL106", "MTL106"]


def test_http_handler_methods_are_thread_entry_points():
    code = """
    class Handler:
        def do_GET(self):
            self.hits = self.hits + 1
        def reset(self):
            self.hits = 0
    """
    assert _rules(_both(code)) == ["MTL106", "MTL106"]


def test_timer_bodies_and_worker_closures_are_entries():
    code = """
    import threading
    def schedule():
        def tick():
            global beats
            beats = beats + 1
        threading.Timer(1.0, tick).start()
    def reset():
        global beats
        beats = 0
    beats = 0
    """
    findings = _both(code)
    assert _rules(findings) == ["MTL106", "MTL106"]
    assert all("beats" in f.message for f in findings)


def test_locked_global_writes_are_clean():
    code = """
    import threading
    _LOCK = threading.Lock()
    beats = 0
    def schedule():
        def tick():
            global beats
            with _LOCK:
                beats = beats + 1
        threading.Timer(1.0, tick).start()
    def reset():
        global beats
        with _LOCK:
            beats = 0
    """
    assert _rules(_both(code)) == []


def test_threadless_modules_produce_no_mtl106():
    """No spawn site, no analysis: a module full of unlocked attr writes
    is single-threaded by construction."""
    code = """
    class Plain:
        def a(self):
            self.x = 1
        def b(self):
            self.x = 2
    """
    assert _rules(_both(code)) == []


def test_mtl106_suppression_and_staleness():
    code = """
    import threading
    class Worker:
        def start(self):
            threading.Thread(target=self._run).start()
        def _run(self):
            self.n = self.n + 1  # metrics-tpu: allow(MTL106)
        def bump(self):
            self.n = self.n + 1  # metrics-tpu: allow(MTL106)
    """
    findings = _both(code)
    assert _rules(findings) == []
    assert sorted(f.rule for f in findings if f.suppressed) == ["MTL106", "MTL106"]
    # a stale MTL106 allow is flagged like any other lint allow
    stale = """
    x = 1  # metrics-tpu: allow(MTL106)
    """
    assert _rules(_both(stale)) == ["MTL105"]


def test_local_shadowing_a_global_is_not_a_shared_touch():
    """A main-side helper whose LOCAL variable shares a module global's
    name must not mark the global as main-touched: the thread-side owner
    of ``beats`` stays single-owner, no finding."""
    code = """
    import threading
    beats = 0
    def schedule():
        def tick():
            global beats
            beats = beats + 1
        threading.Timer(1.0, tick).start()
    def snapshot(x):
        beats = x * 2  # a LOCAL, shadowing the module global
        return beats
    def loop():
        for beats in range(3):  # loop target: also a local binding
            pass
    """
    assert _rules(_both(code)) == []


# ---------------------------------------------------------------------------
# the fixtures, stripped of their allows, fire exactly their rule
# ---------------------------------------------------------------------------
def test_unlocked_shared_counter_fixture_fires_mtl106_when_stripped():
    import inspect

    from metrics_tpu_torch.analysis import fixtures as fx

    src = "import threading\n" + textwrap.dedent(inspect.getsource(fx.UnlockedSharedCounter))
    assert {f.rule for f in lint_source(src, "analysis/fixtures.py") if f.suppressed} == {"MTL106"}
    stripped = "\n".join(line for line in src.splitlines() if "metrics-tpu: allow" not in line)
    fired = [f for f in lint_source(stripped, "analysis/fixtures.py") if not f.suppressed]
    assert [f.rule for f in fired] == ["MTL106", "MTL106"]


# ---------------------------------------------------------------------------
# the port's own tree under both linters
# ---------------------------------------------------------------------------
_SHARED = {"MTL103", "MTL104", "MTL106", "MTL107"}


def _shared_findings(findings):
    """Findings of the rules both linters define alike: MTL103, MTL104,
    MTL106, MTL107, and the MTL105 staleness of their allows (an allow of
    the port's MTL101 is stale to the JAX package's MTL101 by design)."""
    return sorted(
        (f.rule, f.subject, f.suppressed, f.detail.get("rule"))
        for f in findings
        if f.rule in _SHARED or (f.rule == "MTL105" and f.detail.get("rule") in _SHARED)
    )


def test_jax_and_port_linters_agree_on_the_port_tree():
    port = lint_paths()
    jax_found = jax_lint.lint_paths(root=PORT_ROOT)
    assert _shared_findings(port) == _shared_findings(jax_found)
    # the JAX package's linter finds no unsuppressed MTL103-MTL107 either,
    # and nothing of the port trips its jax.jit rule
    assert [f for f in jax_found if not f.suppressed and f.rule in _SHARED] == []
    assert [f for f in jax_found if f.rule == "MTL102"] == []
    assert os.path.basename(PORT_ROOT) == "metrics_tpu_torch"
