"""dynalint framework: module model, suppression parsing, rule runner.

Port of ``dynamo_tpu.analysis.core``. Everything here is plain ``ast`` — no
imports of the analyzed code, so the linter runs in milliseconds, needs no
devices, and can never be broken by an import-time side effect in the code
under analysis. Where the JAX package's module model tracks ``jax.jit``
targets, this one tracks *capture targets*: functions a CUDA graph capture
or ``torch.compile`` freezes into a graph.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

# ----------------------------------------------------------------------------
# configuration


@dataclass(frozen=True)
class AnalysisConfig:
    """Scoping knobs for the rule pipeline.

    ``hot_modules`` are repo-relative posix prefixes whose *function bodies*
    are hot-path scope for the DT1xx rules even without ``@hot_path``; the
    decorator extends scope anywhere else.  ``layout_modules`` are the only
    places DT5xx lets mesh axis names, meshes and process groups live.
    ``kernel_sources`` are the repo-relative directories whose ``extern
    "C"`` entry points the DT4xx rules hold the ``ctypes`` bindings to.
    """

    root: Path = Path(".")
    # the serving hot loop: kernels, the engine, the scheduler.  Cold
    # engine modules (weights loading, startup autotune, config) stay out so
    # a checkpoint load is not "a host sync in the decode loop".
    hot_modules: Tuple[str, ...] = (
        "dynamo_tpu_torch/ops/",
        "dynamo_tpu_torch/engine/engine.py",
        "dynamo_tpu_torch/engine/model.py",
        "dynamo_tpu_torch/engine/scheduler.py",
        "dynamo_tpu_torch/spec/",
    )
    layout_modules: Tuple[str, ...] = (
        "dynamo_tpu_torch/parallel/layout.py",
        "dynamo_tpu_torch/parallel/comm.py",
    )
    # the canonical mesh axis vocabulary DT501 polices (parallel/layout.py
    # ALL_AXES)
    axis_names: Tuple[str, ...] = ("dp", "tp", "sp", "ep", "pp", "fsdp")
    kernel_sources: Tuple[str, ...] = ("dynamo_tpu_torch/csrc",)


# ----------------------------------------------------------------------------
# findings


@dataclass
class Finding:
    code: str          # e.g. "DT102"
    path: str          # repo-relative posix path
    line: int
    col: int
    message: str
    symbol: str = "<module>"   # enclosing function qualname
    snippet: str = ""          # stripped source line (baseline fingerprint)

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.code} "
                f"[{self.symbol}] {self.message}")


# ----------------------------------------------------------------------------
# suppressions

_SUPPRESS_RE = re.compile(
    r"#\s*dynalint:\s*(disable|disable-next-line)\s*=\s*"
    r"(all|DT[0-9]{3}(?:\s*,\s*DT[0-9]{3})*)"
)


def parse_suppressions(source_lines: Sequence[str]) -> Dict[int, Set[str]]:
    """Map 1-based line number -> set of suppressed codes ("all" wildcard)."""
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(source_lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        target = i + 1 if m.group(1) == "disable-next-line" else i
        codes = {c.strip() for c in m.group(2).split(",")}
        out.setdefault(target, set()).update(codes)
    return out


# ----------------------------------------------------------------------------
# module context

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


@dataclass
class CaptureInfo:
    """How a function reaches a CUDA graph capture or ``torch.compile``."""

    n_bound: int = 0  # leading params pre-bound by functools.partial (consts)
    # node findings anchor to: the capture call site, or the def for
    # decorators
    site: Optional[ast.AST] = None


# calls whose function argument is captured / compiled into a graph
_CAPTURE_CALLS = ("torch.compile", "torch.cuda.make_graphed_callables")
# context managers whose body is recorded into a CUDA graph
_GRAPH_CONTEXTS = ("torch.cuda.graph",)
# annotations that mark a parameter as a Python value, not a tensor
_PY_SCALARS = ("int", "bool", "float", "str")


class ModuleContext:
    """One parsed module plus the derived maps every rule needs."""

    def __init__(self, path: str, source: str, config: AnalysisConfig):
        self.path = path  # repo-relative posix
        self.config = config
        self.source_lines = source.splitlines()
        self.tree = ast.parse(source)
        self.suppressions = parse_suppressions(self.source_lines)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.aliases = self._collect_aliases()
        self.capture_targets: Dict[ast.AST, CaptureInfo] = {}
        self._collect_capture_targets()
        self._module_is_hot = any(
            path.startswith(prefix) or path == prefix.rstrip("/")
            for prefix in config.hot_modules
        )
        self.is_layout_module = path in config.layout_modules

    # ------------------------------- names ------------------------------

    def _collect_aliases(self) -> Dict[str, str]:
        aliases: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    if a.name == "*":
                        continue
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        return aliases

    def dotted(self, node: ast.AST) -> Optional[str]:
        """Resolve a Name/Attribute chain to a canonical dotted path."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = self.aliases.get(node.id, node.id)
        parts.append(head)
        return ".".join(reversed(parts))

    def call_name(self, call: ast.Call) -> Optional[str]:
        return self.dotted(call.func)

    # ------------------------------ scoping -----------------------------

    def enclosing_functions(self, node: ast.AST) -> List[ast.AST]:
        """Innermost-first chain of enclosing function defs."""
        out = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, _FUNC_NODES):
                out.append(cur)
            cur = self.parents.get(cur)
        return out

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        chain = self.enclosing_functions(node)
        return chain[0] if chain else None

    def qualname(self, node: ast.AST) -> str:
        names = []
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, _FUNC_NODES + (ast.ClassDef,)):
                names.append(cur.name)
            cur = self.parents.get(cur)
        return ".".join(reversed(names)) or "<module>"

    def _decorated_hot(self, func: ast.AST) -> bool:
        for dec in getattr(func, "decorator_list", []):
            target = dec.func if isinstance(dec, ast.Call) else dec
            name = self.dotted(target) or ""
            if name == "hot_path" or name.endswith(".hot_path"):
                return True
        return False

    def hot_scope(self, node: ast.AST) -> bool:
        """True when ``node`` sits inside a function on the hot path."""
        chain = self.enclosing_functions(node)
        if isinstance(node, _FUNC_NODES):
            chain = [node] + chain
        if not chain:
            return False  # module level runs at import time — cold
        if self._module_is_hot:
            return True
        return any(self._decorated_hot(f) for f in chain)

    def in_async(self, node: ast.AST) -> bool:
        """True when ``node``'s innermost enclosing function is a coroutine."""
        fn = self.enclosing_function(node)
        return isinstance(fn, ast.AsyncFunctionDef)

    # -------------------------- capture targets -------------------------

    def _is_capture_name(self, node: ast.AST) -> bool:
        return self.dotted(node) in _CAPTURE_CALLS

    def _collect_capture_targets(self) -> None:
        # local function name -> def node (module and class level)
        defs: Dict[str, ast.AST] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, _FUNC_NODES):
                defs.setdefault(node.name, node)

        def target(arg: ast.AST, site: ast.AST) -> None:
            info = CaptureInfo(site=site)
            if (isinstance(arg, ast.Call)
                    and self.dotted(arg.func) == "functools.partial"
                    and arg.args and isinstance(arg.args[0], ast.Name)):
                # partial-bound leading args are Python constants
                info.n_bound = len(arg.args) - 1
                arg = arg.args[0]
            elif (isinstance(arg, ast.Call)
                  and isinstance(arg.func, ast.Name)
                  and arg.func.id in defs):
                # torch.compile(raw_X(...)): the factory-call idiom — the
                # compiled callable is the inner def the factory returns
                inner = self._factory_inner(defs[arg.func.id])
                if inner is not None:
                    self.capture_targets.setdefault(inner, info)
                return
            if isinstance(arg, ast.Name) and arg.id in defs:
                self.capture_targets.setdefault(defs[arg.id], info)

        for node in ast.walk(self.tree):
            # @torch.compile / @torch.compile(mode=...)
            if isinstance(node, _FUNC_NODES):
                for dec in node.decorator_list:
                    fn = dec.func if isinstance(dec, ast.Call) else dec
                    if self._is_capture_name(fn):
                        self.capture_targets[node] = CaptureInfo(site=node)
            # torch.compile(f) / make_graphed_callables((f, g), ...)
            elif isinstance(node, ast.Call) and \
                    self._is_capture_name(node.func):
                if not node.args:
                    continue
                arg = node.args[0]
                for a in (arg.elts if isinstance(arg, ast.Tuple)
                          else [arg]):
                    target(a, node)
            # with torch.cuda.graph(g): f(...)  — f is recorded
            elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    isinstance(item.context_expr, ast.Call)
                    and self.dotted(item.context_expr.func)
                    in _GRAPH_CONTEXTS for item in node.items):
                for stmt in node.body:
                    for sub in ast.walk(stmt):
                        if (isinstance(sub, ast.Call)
                                and isinstance(sub.func, ast.Name)
                                and sub.func.id in defs):
                            self.capture_targets.setdefault(
                                defs[sub.func.id], CaptureInfo(site=sub))

    def _factory_inner(self, factory: ast.AST) -> Optional[ast.AST]:
        """The inner def a factory returns (``def make(): def f(..) ...;
        return f``), or None when the return is anything more clever."""
        inner = {n.name: n for n in factory.body
                 if isinstance(n, _FUNC_NODES)}
        for stmt in factory.body:
            if (isinstance(stmt, ast.Return)
                    and isinstance(stmt.value, ast.Name)
                    and stmt.value.id in inner):
                return inner[stmt.value.id]
        return None

    def tensor_params(self, func: ast.AST) -> Set[str]:
        """Parameter names of a capture target that may hold tensors: all
        but the partial-bound ones, ``self``/``cls`` and those annotated
        as a Python scalar (``int``, ``bool``, ``float``, ``str``)."""
        info = self.capture_targets.get(func)
        if info is None:
            return set()
        args = func.args
        out = set()
        for i, a in enumerate(args.posonlyargs + args.args + args.kwonlyargs):
            if i < info.n_bound and a in args.posonlyargs + args.args:
                continue
            if a.arg in ("self", "cls"):
                continue
            ann = a.annotation
            if isinstance(ann, ast.Name) and ann.id in _PY_SCALARS:
                continue
            out.add(a.arg)
        return out

    # ---------------------------- reporting -----------------------------

    def finding(self, code: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        snippet = ""
        if 1 <= line <= len(self.source_lines):
            snippet = self.source_lines[line - 1].strip()
        return Finding(
            code=code, path=self.path, line=line,
            col=getattr(node, "col_offset", 0), message=message,
            symbol=self.qualname(node), snippet=snippet,
        )

    def suppressed(self, f: Finding) -> bool:
        codes = self.suppressions.get(f.line)
        return bool(codes) and ("all" in codes or f.code in codes)


# ----------------------------------------------------------------------------
# rules + runner


class Rule:
    """One lint rule: a code, a one-line rationale, and a module visitor."""

    code: str = "DT000"
    name: str = "abstract"
    rationale: str = ""

    def visit_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        raise NotImplementedError


def iter_python_files(paths: Iterable[Path]) -> Iterator[Path]:
    for p in paths:
        p = Path(p)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if "__pycache__" not in f.parts:
                    yield f
        elif p.suffix == ".py":
            yield p


def analyze_source(
    source: str,
    path: str,
    rules: Sequence[Rule],
    config: Optional[AnalysisConfig] = None,
    respect_suppressions: bool = True,
) -> List[Finding]:
    """Run ``rules`` over one module's source; the test-fixture entry point."""
    config = config or AnalysisConfig()
    try:
        ctx = ModuleContext(path, source, config)
    except SyntaxError as e:
        return [Finding("DT001", path, e.lineno or 1, e.offset or 0,
                        f"syntax error: {e.msg}")]
    findings: List[Finding] = []
    for rule in rules:
        for f in rule.visit_module(ctx):
            if respect_suppressions and ctx.suppressed(f):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return findings


def run_paths(
    paths: Iterable[Path],
    rules: Sequence[Rule],
    config: Optional[AnalysisConfig] = None,
) -> List[Finding]:
    config = config or AnalysisConfig()
    root = Path(config.root).resolve()
    findings: List[Finding] = []
    for file in iter_python_files(paths):
        try:
            rel = file.resolve().relative_to(root).as_posix()
        except ValueError:
            rel = file.as_posix()
        findings.extend(analyze_source(
            file.read_text(encoding="utf-8"), rel, rules, config))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return findings
