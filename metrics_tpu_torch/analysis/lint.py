"""Pass 2 — repo-invariant lint over the ``metrics_tpu_torch`` source tree.

Port of ``metrics_tpu/analysis/lint.py``. Where a program audit reasons
about one step program at a time, this pass enforces the *architectural*
invariants that keep every future program auditable — shallow, syntactic,
and designed for a zero-false-positive baseline:

* **MTL101** — host ops (``np.*``, ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``float()/int()/bool()`` of a tensor) inside a path a CUDA
  graph captures: ``update``/``forward`` methods, ``_*_update``
  functionals and functions handed to ``torch.compile``. The repo's
  eager-only value probes are exempt when guarded by
  ``_is_concrete``/``debug_enabled`` (the established idiom), as are reads
  of shape metadata (``.shape``, ``.ndim``, ``.dim()``, ``.size()``,
  ``.numel()``, ``.dtype``, ``.device``, ``len()``), of parameters
  annotated with a host type (``int``, ``Optional[float]``, ...: the
  counterpart of a jit-static argument) and of ``self`` configuration
  attributes. The function argument of ``torch.compiler.disable`` runs
  eagerly on the host by contract and is exempt.
* **MTL102** — ``torch.cuda.graph``, ``torch.cuda.CUDAGraph``,
  ``torch.cuda.make_graphed_callables`` or ``torch.compile`` anywhere
  outside ``engine.py``; hot paths capture through the step engine so
  capture policy has one home.
* **MTL103** — ``warnings.warn``/``rank_zero_warn`` inside update paths
  (``update``/``forward`` methods, ``_*_update`` functionals); step-rate
  warnings must rate-limit through ``warn_once``.
* **MTL104** — ``add_state`` registering an array state without a
  ``dist_reduce_fx`` (list states may omit it: rank-order concat is their
  implied reduction).
* **MTL106** — unprotected writes to thread-shared instance attributes /
  module globals (the analysis lives in
  :mod:`metrics_tpu_torch.analysis.concurrency` and routes findings
  through this pass's suppression machinery).
* **MTL107** — non-atomic durable writes (the analysis lives in
  :mod:`metrics_tpu_torch.analysis.protocol`, routed the same way).

Suppression: ``# metrics-tpu: allow(MTL104)`` on the flagged line or the
line directly above it.
"""
import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from metrics_tpu_torch.analysis.rules import (
    HOST_CALLBACKS,
    Finding,
    parse_allow_comments,
)

__all__ = ["lint_file", "lint_paths", "lint_source", "default_lint_root"]

_UPDATE_FUNCTIONAL_RE = re.compile(r"^_\w*_update$")
_CAPTURE_HOME = "engine.py"
_CAPTURE_APIS = (
    "torch.cuda.graph",
    "torch.cuda.CUDAGraph",
    "torch.cuda.make_graphed_callables",
    "torch.compile",
)
_COMPILE = "torch.compile"
_CAST_BUILTINS = {"float", "int", "bool"}
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
_CONCRETE_GUARDS = {"_is_concrete", "debug_enabled"}
# shape metadata: static on a tensor inside a captured step
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device"}
_STATIC_METHODS = {"dim", "size", "numel"}
# annotation names that may hold a tensor: a parameter annotated with any of
# them (or not annotated at all) is not a host value
_TENSORISH_ANNOTATIONS = {"Tensor", "Any", "ndarray", "object"}


def default_lint_root() -> str:
    """The package directory the repo gate lints."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _dotted(node: ast.AST) -> str:
    """``torch.cuda.graph``-style dotted name of an expression, or ''."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _guard_polarity(test: ast.AST) -> Optional[bool]:
    """Which branch of ``if test:`` can only run on concrete values?

    ``True``  — the test being true implies concreteness (guard the body):
    a bare ``_is_concrete(...)``/``debug_enabled(...)`` call, or an ``and``
    with such a conjunct. ``False`` — the test being *false* implies
    concreteness (guard the orelse): ``not _is_concrete(...)``, or an
    ``or`` with such a disjunct. ``None`` — neither branch is guarded
    (e.g. ``_is_concrete(x) or flag``: the body still runs under capture
    whenever ``flag`` is true)."""
    if isinstance(test, ast.Call) and _names_in(test.func) & _CONCRETE_GUARDS:
        return True
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        inner = _guard_polarity(test.operand)
        return None if inner is None else not inner
    if isinstance(test, ast.BoolOp):
        polarities = [_guard_polarity(v) for v in test.values]
        if isinstance(test.op, ast.And) and True in polarities:
            return True  # whole test true => the guarding conjunct held
        if isinstance(test.op, ast.Or) and False in polarities:
            return False  # whole test false => the guarding disjunct's
            # operand held, so the orelse only runs concrete
    return None


def _host_annotated(arg: ast.arg) -> bool:
    """Is the parameter annotated with a host type only (``int``,
    ``Optional[float]``, ``Sequence[str]``)? Such a value is never a tensor,
    so a cast of it is no device read."""
    if arg.annotation is None:
        return False
    names = {
        n.id if isinstance(n, ast.Name) else n.attr
        for n in ast.walk(arg.annotation)
        if isinstance(n, (ast.Name, ast.Attribute))
    }
    strings = [
        n.value for n in ast.walk(arg.annotation)
        if isinstance(n, ast.Constant) and isinstance(n.value, str)
    ]
    return not (names & _TENSORISH_ANNOTATIONS) and not any(
        t in s for s in strings for t in _TENSORISH_ANNOTATIONS
    )


class _Scope:
    """One captured-path scope (a compiled function, an ``update``/``forward``
    method or a ``_*_update`` functional), or a host scope (a function
    ``torch.compiler.disable`` keeps out of the graph)."""

    def __init__(self, kind: str, name: str, static_args: Set[str]):
        self.kind = kind
        self.name = name
        self.static_args = static_args


class _Linter(ast.NodeVisitor):
    def __init__(self, rel_path: str, tree: ast.AST):
        self.rel_path = rel_path
        self.findings: List[Finding] = []
        self.numpy_aliases: Set[str] = set()
        self.numpy_from_names: Set[str] = set()
        # bare names bound to a capture API (``from torch import compile``)
        # or to a host callback (``from torch.compiler import disable``)
        self.capture_names: Dict[str, str] = {}
        self.host_callback_names: Set[str] = set()
        self.warn_names: Set[str] = {"rank_zero_warn", "_warn"}
        self._class_stack: List[str] = []
        self._traced_stack: List[_Scope] = []
        self._warnscope_stack: List[str] = []
        self._guard_depth = 0
        self._compiled = self._compiled_targets(tree)

    # -- bookkeeping ----------------------------------------------------
    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule,
            f"{self.rel_path}:{getattr(node, 'lineno', 0)}",
            message,
            detail={"line": getattr(node, "lineno", 0)},
        ))

    @property
    def _traced(self) -> Optional[_Scope]:
        if not self._traced_stack or self._traced_stack[-1].kind == "host":
            return None
        return self._traced_stack[-1]

    def _host_callback(self, node: ast.AST) -> bool:
        """Does the expression name ``torch.compiler.disable`` (any spelling
        in :data:`HOST_CALLBACKS`, dotted or imported bare)?"""
        if isinstance(node, ast.Name):
            return node.id in self.host_callback_names
        return _dotted(node) in HOST_CALLBACKS

    def _api(self, node: ast.AST) -> str:
        """The capture API an expression names, or ''."""
        name = _dotted(node)
        if name in _CAPTURE_APIS:
            return name
        if isinstance(node, ast.Name):
            return self.capture_names.get(node.id, "")
        return ""

    @staticmethod
    def _compiled_targets(tree: ast.AST) -> Set[str]:
        """Names of functions and methods handed to ``torch.compile(...)``
        as a call argument anywhere in the module."""
        out: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and _dotted(node.func) == _COMPILE and node.args:
                target = node.args[0]
                if isinstance(target, ast.Name):
                    out.add(target.id)
                elif (
                    isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                ):
                    out.add(target.attr)
        return out

    # -- imports: learn this module's numpy and torch spellings ---------
    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if alias.name == "numpy":
                self.numpy_aliases.add(alias.asname or "numpy")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        module = node.module or ""
        if module == "numpy" or module.startswith("numpy."):
            for alias in node.names:
                self.numpy_from_names.add(alias.asname or alias.name)
        for alias in node.names:
            api = f"{module}.{alias.name}"
            if api in _CAPTURE_APIS:
                self.capture_names[alias.asname or alias.name] = api
            elif api in HOST_CALLBACKS:
                self.host_callback_names.add(alias.asname or alias.name)
        self.generic_visit(node)

    # -- scopes ---------------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def _decorator_kind(self, dec: ast.AST) -> Optional[str]:
        """``"compiled"`` for ``@torch.compile``, ``@torch.compile(...)`` and
        ``@partial(torch.compile, ...)``; ``"host"`` for
        ``@torch.compiler.disable``; else None."""
        if self._host_callback(dec):
            return "host"
        if self._api(dec) == _COMPILE:
            return "compiled"
        if isinstance(dec, ast.Call):
            if self._api(dec.func) == _COMPILE:
                return "compiled"
            if (
                isinstance(dec.func, ast.Name)
                and dec.func.id in ("partial", "_partial")
                and dec.args
                and self._api(dec.args[0]) == _COMPILE
            ):
                return "compiled"
        return None

    def _function_scopes(self, node) -> Tuple[Optional[_Scope], bool]:
        kinds = {self._decorator_kind(dec) for dec in node.decorator_list}
        args = node.args
        static = {
            a.arg for a in args.posonlyargs + args.args + args.kwonlyargs if _host_annotated(a)
        }
        in_class = bool(self._class_stack)
        traced: Optional[_Scope] = None
        if "host" in kinds:
            traced = _Scope("host", node.name, set())
        elif "compiled" in kinds or node.name in self._compiled:
            traced = _Scope("compiled", node.name, static)
        elif in_class and node.name in ("update", "forward"):
            traced = _Scope("update-method", node.name, static)
        elif not in_class and _UPDATE_FUNCTIONAL_RE.match(node.name) is not None:
            traced = _Scope("update-functional", node.name, static)
        hot_warn = (
            (in_class and node.name in ("update", "forward"))
            or (not in_class and _UPDATE_FUNCTIONAL_RE.match(node.name) is not None)
        )
        return traced, hot_warn

    def _visit_function(self, node) -> None:
        traced, hot_warn = self._function_scopes(node)
        if traced is not None:
            self._traced_stack.append(traced)
        if hot_warn:
            self._warnscope_stack.append(node.name)
        guard_depth = self._guard_depth
        self._guard_depth = 0  # guards don't cross function boundaries
        self.generic_visit(node)
        self._guard_depth = guard_depth
        if hot_warn:
            self._warnscope_stack.pop()
        if traced is not None:
            self._traced_stack.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    # -- eager-only guard regions ---------------------------------------
    def visit_If(self, node: ast.If) -> None:
        polarity = _guard_polarity(node.test)
        self.visit(node.test)
        if polarity is True:
            self._guard_depth += 1
        for child in node.body:
            self.visit(child)
        if polarity is True:
            self._guard_depth -= 1
        if polarity is False:
            self._guard_depth += 1
        for child in node.orelse:
            self.visit(child)
        if polarity is False:
            self._guard_depth -= 1

    # -- the rules ------------------------------------------------------
    def _flag_capture(self, node: ast.AST, api: str) -> None:
        rel = self.rel_path.replace(os.sep, "/")
        if rel == _CAPTURE_HOME or rel.endswith("/" + _CAPTURE_HOME):
            return
        self._emit(
            "MTL102", node,
            f"`{api}` outside `engine.py`; capture through the step engine"
            " (`MetricCollection(compiled=True)`, `MetricCohort`) so capture"
            " policy has one home",
        )

    def visit_Attribute(self, node: ast.Attribute) -> None:
        api = _dotted(node)
        if api in _CAPTURE_APIS:
            self._flag_capture(node, api)
        if (
            self._traced is not None
            and self._guard_depth == 0
            and isinstance(node.value, ast.Name)
            and node.value.id in self.numpy_aliases
        ):
            self._emit(
                "MTL101", node,
                f"`{node.value.id}.{node.attr}` inside captured scope"
                f" `{self._traced.name}`: numpy executes on the host, so a"
                " CUDA graph either fails to capture it or replays the value"
                " of the capture step",
            )
        if api in _CAPTURE_APIS:
            return  # one finding for the whole dotted name
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        # a bare name bound to a capture API (``from torch import compile``)
        if isinstance(node.ctx, ast.Load) and node.id in self.capture_names:
            self._flag_capture(node, self.capture_names[node.id])

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        # MTL103: step-rate warning without warn_once
        if self._warnscope_stack:
            warn_call = (
                isinstance(func, ast.Name) and func.id in self.warn_names
            ) or (
                isinstance(func, ast.Attribute)
                and func.attr == "warn"
                and isinstance(func.value, ast.Name)
                and func.value.id == "warnings"
            )
            if warn_call:
                self._emit(
                    "MTL103", node,
                    f"unconditioned warning inside update path"
                    f" `{self._warnscope_stack[-1]}` fires every step; use"
                    " `warn_once` with a stable key",
                )
        # MTL104: add_state without a reduction
        if isinstance(func, ast.Attribute) and func.attr == "add_state":
            self._check_add_state(node)
        # MTL101: host reads in a captured scope
        if self._traced is not None and self._guard_depth == 0:
            if isinstance(func, ast.Attribute) and func.attr in _HOST_METHODS and not node.args:
                self._emit(
                    "MTL101", node,
                    f"`.{func.attr}()` inside captured scope"
                    f" `{self._traced.name}` forces a device->host sync"
                    " (and fails a CUDA graph capture)",
                )
            elif (
                isinstance(func, ast.Name)
                and func.id in _CAST_BUILTINS
                and len(node.args) == 1
                and not self._static_expr(node.args[0])
            ):
                self._emit(
                    "MTL101", node,
                    f"`{func.id}(...)` of a tensor inside"
                    f" `{self._traced.name}` reads it to the host; guard"
                    " with `_is_concrete` or keep the value on the device",
                )
            elif isinstance(func, ast.Name) and func.id in self.numpy_from_names:
                self._emit(
                    "MTL101", node,
                    f"`{func.id}(...)` (imported from numpy) inside captured"
                    f" scope `{self._traced.name}`: numpy executes on the"
                    " host, so a CUDA graph either fails to capture it or"
                    " replays the value of the capture step",
                )
        # the function argument of torch.compiler.disable runs eagerly on
        # the host by contract, so host ops inside it are the point
        if self._host_callback(func) and node.args:
            self.visit(func)
            for arg in node.args[1:]:
                self.visit(arg)
            for kw in node.keywords:
                self.visit(kw)
            return
        self.generic_visit(node)

    def _static_expr(self, node: ast.AST) -> bool:
        """True when the expression provably reads no tensor value:
        literals, host-annotated parameters, shape metadata
        (``x.shape``/``x.ndim``/``x.dtype``/``x.device``, ``x.dim()``,
        ``x.size()``, ``x.numel()``, ``len(x)``: host values even on a tensor
        being captured), and ``self.<attr>`` configuration reads (metric
        hyper-parameters; state reads are ``self.<state>`` too, so casts of
        self attributes are accepted, as the JAX package's lint accepts
        them)."""
        scope = self._traced
        static_names = scope.static_args if scope is not None else set()
        shape_builtins = _CAST_BUILTINS | {"len", "max", "min"}
        stack: List[ast.AST] = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS:
                continue  # x.shape etc.: don't descend into the base
            if isinstance(n, ast.Call):
                fn = n.func
                if isinstance(fn, ast.Attribute) and fn.attr in _STATIC_METHODS:
                    continue  # x.size(0) etc.
                if isinstance(fn, ast.Name) and fn.id == "len":
                    continue  # len(x) reads shape[0]
            if isinstance(n, ast.Name):
                if n.id not in static_names | {"self"} | shape_builtins:
                    return False
            elif isinstance(n, ast.Call):
                fn = n.func
                ok = (
                    isinstance(fn, ast.Name) and fn.id in shape_builtins
                ) or (isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name)
                      and fn.value.id == "self")
                if not ok:
                    return False
            stack.extend(ast.iter_child_nodes(n))
        return True

    def _check_add_state(self, node: ast.Call) -> None:
        default: Optional[ast.AST] = None
        reduction: Optional[ast.AST] = None
        have_reduction = False
        if len(node.args) >= 2:
            default = node.args[1]
        if len(node.args) >= 3:
            reduction, have_reduction = node.args[2], True
        for kw in node.keywords:
            if kw.arg == "default":
                default = kw.value
            elif kw.arg == "dist_reduce_fx":
                reduction, have_reduction = kw.value, True
        if isinstance(default, ast.List) and not default.elts:
            return  # list state: rank-order concat is the implied reduction
        is_none = isinstance(reduction, ast.Constant) and reduction.value is None
        if not have_reduction or is_none:
            self._emit(
                "MTL104", node,
                "array state registered without a `dist_reduce_fx`:"
                " cross-replica sync would leave a stacked (world, ...)"
                " array (list states may omit it; everything else must"
                " declare its merge)",
            )


def lint_source(source: str, rel_path: str) -> List[Finding]:
    """Lint one module's source text; ``rel_path`` labels findings and
    decides path-scoped rules (MTL102's ``engine.py`` home).

    Suppression comes with a staleness audit (MTL105, the unused-noqa
    analogue): every ``allow(<MTL rule>)`` comment must suppress at least
    one finding in this run or it is itself flagged — an allowlist entry
    whose violation was fixed is a pre-approved hole for the next real
    one. ``MTA*`` allows are exempt here (they belong to the program
    audit, which runs its own staleness check), as is ``allow(MTL105)``."""
    tree = ast.parse(source, filename=rel_path)
    linter = _Linter(rel_path, tree)
    linter.visit(tree)
    # the MTL106 leg: thread-shared-state analysis — a separate two-phase
    # walk (spawn-site discovery, then call-graph reachability), so it
    # lives in analysis/concurrency.py and routes its findings through the
    # same suppression machinery here
    from metrics_tpu_torch.analysis.concurrency import thread_findings

    linter.findings.extend(thread_findings(tree, rel_path))
    # the MTL107 leg: durability analysis — write-mode open() outside the
    # atomic primitives and rename-without-fsync orderings
    # (analysis/protocol.py), routed through the same suppression
    # machinery so the primitives' own internals carry audited allows
    from metrics_tpu_torch.analysis.protocol import durability_findings

    linter.findings.extend(durability_findings(tree, rel_path))
    base_allow = parse_allow_comments(source)
    allow = {line: set(rules) for line, rules in base_allow.items()}
    # provenance: effective (line, rule) -> the comment line that grants it
    origin: Dict[Tuple[int, str], int] = {
        (line, r): line for line, rules in base_allow.items() for r in rules
    }
    # an allow comment opening a comment block suppresses the first code
    # line after the block (multi-line rationales are the norm): propagate
    # each comment's rules downward through consecutive comment-only lines
    lines = source.splitlines()
    for lineno in sorted(base_allow):
        cursor = lineno
        while cursor <= len(lines) and lines[cursor - 1].lstrip().startswith("#"):
            cursor += 1
        if cursor != lineno:
            allow.setdefault(cursor, set())
            allow[cursor] |= base_allow[lineno]
            for r in base_allow[lineno]:
                origin.setdefault((cursor, r), lineno)
    used: Set[Tuple[int, str]] = set()
    findings: List[Finding] = []
    for f in linter.findings:
        line = f.detail.get("line", 0)
        for cand in (line, line - 1):
            if f.rule in allow.get(cand, set()):
                f.suppressed = True
                used.add((origin.get((cand, f.rule), cand), f.rule))
                break
        findings.append(f)
    for line, rules in sorted(base_allow.items()):
        for rule_id in sorted(rules):
            if not rule_id.startswith("MTL") or rule_id == "MTL105":
                continue
            if (line, rule_id) in used:
                continue
            stale = Finding(
                "MTL105", f"{rel_path}:{line}",
                f"stale suppression: allow({rule_id}) suppressed nothing —"
                " the violation it excused is gone; delete the comment"
                " before it silently excuses the next real one",
                detail={"line": line, "rule": rule_id},
            )
            if "MTL105" in allow.get(line, set()) | allow.get(line - 1, set()):
                stale.suppressed = True
            findings.append(stale)
    return findings


def lint_file(path: str, root: Optional[str] = None) -> List[Finding]:
    """Lint one file from disk; findings are labeled relative to ``root``."""
    with open(path, "r", encoding="utf-8") as fh:
        source = fh.read()
    rel = os.path.relpath(path, root) if root else path
    return lint_source(source, rel)


def lint_paths(
    paths: Optional[Sequence[str]] = None,
    root: Optional[str] = None,
    include_suppressed: bool = True,
) -> List[Finding]:
    """Lint a set of files (default: every ``.py`` under the installed
    ``metrics_tpu_torch`` package), sorted by path. Suppressed findings are
    included (flagged) unless ``include_suppressed=False``."""
    if paths is None:
        root = root or default_lint_root()
        paths = []
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            paths.extend(
                os.path.join(dirpath, f) for f in sorted(filenames) if f.endswith(".py")
            )
    out: List[Finding] = []
    for p in sorted(paths):
        out.extend(lint_file(p, root=root or default_lint_root()))
    if not include_suppressed:
        out = [f for f in out if not f.suppressed]
    return out
