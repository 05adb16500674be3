"""Obs-discipline pass: no ``repro_torch.obs`` recording reachable under a
trace (port of ``repro.analysis.obs_discipline``).

The rule (``src/repro_torch/obs/instrument.py``) is *record around traced
or captured calls, never inside them*: Python side effects inside code that
``torch.compile`` traces or a CUDA graph captures run once per trace or
capture, not once per call, so a counter bumped there silently
under-counts; inside ``torch.utils.checkpoint`` the forward is replayed in
the backward, so a recording there counts twice.  This pass proves the
rule statically.

Model (pure ``ast``, no imports executed), the reference's own:

* every ``def``/``lambda`` in the tree is a node; calls to names we can
  resolve (same module, ``self.``-methods, ``module.attr`` through the
  import table) are edges;
* a node is a **traced root** when it is decorated with a tracing
  callable (including through ``functools.partial``) or passed to one:
  ``torch.compile``, ``torch.cuda.make_graphed_callables``,
  ``torch.func.{vmap,grad,grad_and_value,functional_call}``,
  ``torch.jit.{script,trace}``, and ``torch.utils.checkpoint.checkpoint``
  (the counterpart of ``jax.checkpoint`` / ``jax.remat``); the body of a
  ``with torch.cuda.graph(...)`` block is a traced root of its own;
* a **recording site** is a call of the obs facade (``counter_inc``,
  ``gauge_set``, ``hist_observe``, ``span``, ``instrumented``) through any
  alias of ``repro_torch.obs`` / ``repro_torch.obs.instrument``.

Rule OBS201 fires for every recording site reachable from a traced root,
with the root-to-site path in the message.  Resolution is deliberately
conservative: an edge we cannot resolve is dropped, so the pass
under-approximates reachability and never invents call chains (a method
called on a parameter, ``api.decode_step(...)``, is such an edge).
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .findings import Finding

PASS_NAME = "obs-discipline"

#: the package whose modules the import table resolves into
PACKAGE = "repro_torch"

#: obs facade entry points whose execution records (or opens a span)
RECORDING_APIS = ("counter_inc", "gauge_set", "hist_observe", "span",
                  "instrumented")

#: dotted suffixes that identify the obs facade modules
OBS_MODULES = ("repro_torch.obs", "repro_torch.obs.instrument")

#: callables whose function-valued arguments are traced, captured or
#: replayed by torch
TRACING_CALLABLES = (
    "torch.compile", "torch.cuda.make_graphed_callables",
    "torch.func.vmap", "torch.vmap", "torch.func.grad",
    "torch.func.grad_and_value", "torch.func.functional_call",
    "torch.jit.script", "torch.jit.trace",
    "torch.utils.checkpoint.checkpoint",
)

#: context managers whose ``with`` body is captured (a traced root)
CAPTURING_CONTEXTS = ("torch.cuda.graph",)


@dataclasses.dataclass
class _FuncNode:
    """One function/lambda: its calls, recording sites, and trace roots."""
    key: Tuple[str, str]                 # (relpath, qualname)
    lineno: int
    traced_reason: Optional[str] = None
    # resolved callee keys with call-site line numbers
    calls: List[Tuple[Tuple[str, str], int]] = dataclasses.field(
        default_factory=list)
    # (api name, lineno) of direct obs recording calls
    recording: List[Tuple[str, int]] = dataclasses.field(default_factory=list)


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _ModuleScan(ast.NodeVisitor):
    """Single-module collection of functions, imports, and classes."""

    def __init__(self, relpath: str, tree: ast.Module):
        self.relpath = relpath
        self.imports: Dict[str, str] = {}      # local alias -> dotted target
        self.nodes: Dict[Tuple[str, str], _FuncNode] = {}
        self._scope: List[str] = []
        self._class: List[str] = []
        self._lambda_n = 0
        self.visit(tree)

    # -- imports -----------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.imports[a.asname or a.name.split(".")[0]] = a.name

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        if node.level:  # relative: anchor under the package heuristically
            pkg = _package_of(self.relpath, node.level)
            mod = f"{pkg}.{mod}" if mod else pkg
        for a in node.names:
            self.imports[a.asname or a.name] = f"{mod}.{a.name}"

    # -- scopes ------------------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class.append(node.name)
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()
        self._class.pop()

    def _qual(self, name: str) -> str:
        return ".".join(self._scope + [name]) if self._scope else name

    def _enter_function(self, name: str, node: ast.AST,
                        decorators: Sequence[ast.AST]) -> None:
        qual = self._qual(name)
        fn = _FuncNode(key=(self.relpath, qual), lineno=node.lineno)
        for dec in decorators:
            hit = _tracing_name_in(dec, self.imports)
            if hit:
                fn.traced_reason = f"decorated with {hit}"
        self.nodes[fn.key] = fn
        self._scope.append(name)
        body = node.body if isinstance(node.body, list) else [node.body]
        _BodyScan(self, fn).scan(body)
        self._scope.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._enter_function(node.name, node, node.decorator_list)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._enter_function(node.name, node, node.decorator_list)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._lambda_n += 1
        self._enter_function(f"<lambda@{node.lineno}>", node, ())


class _BodyScan(ast.NodeVisitor):
    """Scan one function body, stopping at nested function boundaries."""

    def __init__(self, mod: _ModuleScan, fn: _FuncNode):
        self.mod = mod
        self.fn = fn

    def scan(self, body: Iterable[ast.AST]) -> None:
        for stmt in body:
            self.visit(stmt)

    # nested definitions are their own nodes (visited via _ModuleScan)
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.mod.visit_FunctionDef(node)
        self._note_local_def(node.name, node.lineno)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self.mod.visit_AsyncFunctionDef(node)
        self._note_local_def(node.name, node.lineno)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self.mod.visit_Lambda(node)

    def _note_local_def(self, name: str, lineno: int) -> None:
        # calling a nested def from this body is an edge to it
        qual = ".".join(self.mod._scope + [name])
        self.fn.calls.append(((self.mod.relpath, qual), lineno))

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func)
        # 1. obs recording site?
        api = _recording_api(dotted, self.mod.imports)
        if api:
            self.fn.recording.append((api, node.lineno))
        # 2. tracing combinator: its function-valued args become traced roots
        if dotted and _is_tracing_callable(dotted, self.mod.imports):
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                self._mark_traced(arg, dotted)
        # 3. ordinary call edge
        elif dotted:
            callee = self._resolve(dotted)
            if callee:
                self.fn.calls.append((callee, node.lineno))
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        via = None
        for item in node.items:
            expr = item.context_expr
            dotted = _dotted(expr.func) if isinstance(expr, ast.Call) else None
            if dotted and _is_tracing_callable(dotted, self.mod.imports,
                                               CAPTURING_CONTEXTS):
                via = dotted
        if via is None:
            self.generic_visit(node)
            return
        for item in node.items:
            self.visit(item)
        # the captured body is a traced root of its own
        qual = ".".join(self.mod._scope + [f"<capture@{node.lineno}>"])
        fn = _FuncNode(key=(self.mod.relpath, qual), lineno=node.lineno,
                       traced_reason=f"captured by {via}")
        self.mod.nodes[fn.key] = fn
        _BodyScan(self.mod, fn).scan(node.body)

    def _mark_traced(self, arg: ast.AST, via: str) -> None:
        if isinstance(arg, ast.Lambda):
            qual = ".".join(self.mod._scope + [f"<lambda@{arg.lineno}>"])
            key = (self.mod.relpath, qual)
            # the lambda node is created when generic_visit descends into it
            self._pending_trace = getattr(self, "_pending_trace", [])
            self._pending_trace.append((key, via))
            self.mod._deferred_traced.append((key, via))
            return
        dotted = _dotted(arg)
        if not dotted:
            return
        callee = self._resolve(dotted)
        if callee:
            self.mod._deferred_traced.append((callee, via))

    def _resolve(self, dotted: str) -> Optional[Tuple[str, str]]:
        """Best-effort: dotted call name -> function node key."""
        mod = self.mod
        parts = dotted.split(".")
        # self.method -> method of the enclosing class
        if parts[0] == "self" and len(parts) == 2 and mod._class:
            return (mod.relpath, f"{mod._class[-1]}.{parts[1]}")
        # bare name: function in an enclosing scope chain, then module level
        if len(parts) == 1:
            scope = list(mod._scope)
            while True:
                qual = ".".join(scope + parts)
                if (mod.relpath, qual) in mod.nodes or scope == []:
                    return (mod.relpath, qual)
                scope.pop()
        # alias.attr through the import table -> other repro_torch module
        target = mod.imports.get(parts[0])
        if target and PACKAGE in target.split("."):
            relmod = _module_to_relpath(target)
            if relmod:
                return (relmod, ".".join(parts[1:]))
        return None


# ---------------------------------------------------------------------------
# name helpers
# ---------------------------------------------------------------------------

def _package_of(relpath: str, level: int) -> str:
    """Dotted package of a relative import from ``relpath``."""
    parts = relpath.replace(os.sep, "/").split("/")[:-1]
    if level > 1:
        parts = parts[: -(level - 1)] if level - 1 <= len(parts) else []
    return ".".join(parts)


def _module_to_relpath(dotted: str) -> Optional[str]:
    """'x.repro_torch.core.mars' (or 'repro_torch.core.mars') ->
    'repro_torch/core/mars.py'."""
    parts = dotted.split(".")
    if PACKAGE not in parts:
        return None
    parts = parts[parts.index(PACKAGE):]
    return "/".join(parts) + ".py"


def _recording_api(dotted: Optional[str],
                   imports: Dict[str, str]) -> Optional[str]:
    """The obs api name if this dotted callee is a recording entry point."""
    if not dotted:
        return None
    parts = dotted.split(".")
    if parts[-1] not in RECORDING_APIS:
        return None
    if len(parts) == 1:
        target = imports.get(parts[0], "")
        return parts[-1] if _is_obs_module(target.rsplit(".", 1)[0]) else None
    base = imports.get(parts[0], parts[0])
    prefix = ".".join([base] + parts[1:-1])
    return parts[-1] if _is_obs_module(prefix) else None


def _is_obs_module(dotted: str) -> bool:
    return any(dotted == m or dotted.endswith("." + m) or
               dotted.endswith(m.split(".")[-1]) and "obs" in dotted
               for m in OBS_MODULES)


def _is_tracing_callable(dotted: str, imports: Dict[str, str],
                         names: Sequence[str] = TRACING_CALLABLES) -> bool:
    parts = dotted.split(".")
    base = imports.get(parts[0], parts[0])
    full = ".".join([base] + parts[1:])
    for t in names:
        if dotted == t or full == t or full.endswith("." + t):
            return True
    return False


def _tracing_name_in(dec: ast.AST, imports: Dict[str, str]) -> Optional[str]:
    """A jit/pallas name anywhere in a decorator expression, if present."""
    for sub in ast.walk(dec):
        dotted = _dotted(sub)
        if dotted and _is_tracing_callable(dotted, imports):
            return dotted
    return None


# ---------------------------------------------------------------------------
# pass driver
# ---------------------------------------------------------------------------

def scan_tree(root: str,
              exclude: Sequence[str] = ("analysis",)
              ) -> Dict[Tuple[str, str], _FuncNode]:
    """Parse every .py under ``root`` into the project call-graph nodes."""
    nodes: Dict[Tuple[str, str], _FuncNode] = {}
    rootname = os.path.basename(os.path.normpath(root))
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d != "__pycache__" and d not in exclude]
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.join(
                rootname, os.path.relpath(path, root)).replace(os.sep, "/")
            nodes.update(scan_file(path, rel))
    return nodes


def scan_file(path: str,
              relpath: Optional[str] = None) -> Dict[Tuple[str, str],
                                                     _FuncNode]:
    with open(path) as f:
        src = f.read()
    return scan_source(src, relpath or os.path.basename(path))


def scan_source(src: str, rel: str) -> Dict[Tuple[str, str], _FuncNode]:
    """Scan python source text (fixtures/selftests need no real file)."""
    tree = ast.parse(src, filename=rel)
    scan = _ModuleScan.__new__(_ModuleScan)
    scan.relpath = rel
    scan.imports = {}
    scan.nodes = {}
    scan._scope = []
    scan._class = []
    scan._lambda_n = 0
    scan._deferred_traced = []
    scan.visit(tree)
    for key, via in scan._deferred_traced:
        node = scan.nodes.get(key)
        if node is not None and node.traced_reason is None:
            node.traced_reason = f"passed to {via}"
    return scan.nodes


def run_pass(nodes: Dict[Tuple[str, str], _FuncNode]) -> List[Finding]:
    """OBS201 for every recording site reachable from a traced root."""
    findings: List[Finding] = []
    roots = [k for k, n in nodes.items() if n.traced_reason]
    reported: Set[Tuple[Tuple[str, str], int]] = set()
    for root_key in sorted(roots):
        stack: List[Tuple[Tuple[str, str], Tuple[str, ...]]] = [
            (root_key, (f"{root_key[0]}::{root_key[1]}",))]
        seen: Set[Tuple[str, str]] = set()
        while stack:
            key, path = stack.pop()
            if key in seen:
                continue
            seen.add(key)
            node = nodes.get(key)
            if node is None:
                continue
            for api, lineno in node.recording:
                site = (key, lineno)
                if site in reported:
                    continue
                reported.add(site)
                chain = " -> ".join(path)
                findings.append(Finding(
                    rule="OBS201", severity="error",
                    location=f"{key[0]}:{lineno}",
                    message=(f"obs.{api} reachable inside a traced function "
                             f"({nodes[root_key].traced_reason}; via "
                             f"{chain}) — record around the jitted call, "
                             "never inside it"),
                    pass_name=PASS_NAME))
            for callee, _line in node.calls:
                if callee not in seen:
                    stack.append((callee,
                                  path + (f"{callee[0]}::{callee[1]}",)))
    return findings


def analyze_tree(root: str) -> List[Finding]:
    return run_pass(scan_tree(root))
