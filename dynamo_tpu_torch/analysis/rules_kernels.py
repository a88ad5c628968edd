"""DT4xx — kernel binding contracts: ``ctypes`` against ``extern "C"``.

The port's kernels are bound through ``ctypes`` (``ops/paged_attention.py``,
``native/__init__.py``): each entry point's ``argtypes`` list and each call
must agree with the ``extern "C"`` signature in ``csrc/``, or the wrapper
passes a pointer where the kernel reads an int (or one argument too few)
and the failure is a corrupt launch on the card, miles from the typo. These
rules read the C sources as text (``AnalysisConfig.kernel_sources``) and
hold every binding they can resolve statically against them:

- DT401: an ``argtypes`` entry whose kind (pointer, int or float) differs
  from the matching C parameter's;
- DT402: an ``argtypes`` list, or the arguments of a call, whose length
  differs from the C signature's parameter count.

``argtypes`` built by arithmetic on constants (``[c_void_p] * 8 + [c_int] *
10``) is folded, also through a module-level table unpacked in the
function (``name, n_ptr, n_int = _ENTRY[key]``, every row tried) and
through a loop over constant names; a binding that cannot be folded is
left alone.
"""

from __future__ import annotations

import ast
import functools
import itertools
import re
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .core import Finding, ModuleContext, Rule

# ----------------------------------------------------------------------------
# the C side

_C_SUFFIXES = (".cu", ".cuh", ".cpp", ".cc", ".c", ".h", ".hpp")
_BLOCK_RE = re.compile(r'extern\s+"C"\s*\{')
_SINGLE_RE = re.compile(
    r'extern\s+"C"\s+(?!\{)[^;{()]*?\b([A-Za-z_]\w*)\s*\(([^()]*)\)')
_DEF_RE = re.compile(r'([A-Za-z_][\w\s\*&:<>,]*?)\b([A-Za-z_]\w*)\s*'
                     r'\(([^()]*)\)\s*(?:const\s*)?(?:\{\}|;)')
# opaque handle typedefs that are pointers
_C_HANDLES = ("cudaStream_t", "cudaEvent_t", "CUstream", "CUevent")


def _strip_comments(src: str) -> str:
    src = re.sub(r"/\*.*?\*/", lambda m: " " * len(m.group()), src,
                 flags=re.S)
    return re.sub(r"//[^\n]*", "", src)


def _collapse(text: str) -> str:
    """``text`` with every brace body emptied (``{...}`` -> ``{}``), so
    only the declarations at its own level remain."""
    out, depth = [], 0
    for ch in text:
        if ch == "{":
            if depth == 0:
                out.append(ch)
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                out.append(ch)
        elif depth == 0:
            out.append(ch)
    return "".join(out)


def c_kind(param: str) -> str:
    """"pointer", "float" or "int": how a C parameter is passed."""
    if "*" in param or "[" in param or any(
            re.search(rf"\b{h}\b", param) for h in _C_HANDLES):
        return "pointer"
    if re.search(r"\b(float|double|half)\b", param):
        return "float"
    return "int"


def _params(text: str) -> List[str]:
    text = text.strip()
    if text in ("", "void"):
        return []
    return [c_kind(p) for p in text.split(",")]


def parse_extern_c(src: str) -> Dict[str, List[str]]:
    """``{name: [kind of each parameter]}`` of every ``extern "C"`` entry
    point in the C/C++/CUDA source ``src``: one-line ``extern "C" T f(...)``
    and the functions of an ``extern "C" { ... }`` block."""
    src = _strip_comments(src)
    out: Dict[str, List[str]] = {}
    for m in _SINGLE_RE.finditer(src):
        out[m.group(1)] = _params(m.group(2))
    for m in _BLOCK_RE.finditer(src):
        depth, i = 1, m.end()
        while i < len(src) and depth:
            depth += {"{": 1, "}": -1}.get(src[i], 0)
            i += 1
        for d in _DEF_RE.finditer(_collapse(src[m.end():i - 1])):
            if d.group(2) not in ("if", "for", "while", "switch", "return"):
                out[d.group(2)] = _params(d.group(3))
    return out


@functools.lru_cache(maxsize=64)
def _signatures_of(files: Tuple[Tuple[str, int, int], ...]
                   ) -> Dict[str, List[str]]:
    sigs: Dict[str, List[str]] = {}
    for path, _, _ in files:
        sigs.update(parse_extern_c(Path(path).read_text(encoding="utf-8",
                                                        errors="replace")))
    return sigs


def kernel_signatures(root: Path, dirs) -> Dict[str, List[str]]:
    """The ``extern "C"`` signatures of every C source under ``dirs``
    (relative to ``root``), cached by each file's path, mtime and size."""
    files = []
    for d in dirs:
        base = Path(root) / d
        if base.is_dir():
            for f in sorted(base.rglob("*")):
                if f.suffix in _C_SUFFIXES and f.is_file():
                    st = f.stat()
                    files.append((str(f), st.st_mtime_ns, st.st_size))
    return _signatures_of(tuple(files))


# ----------------------------------------------------------------------------
# the Python side: folding argtypes

_CTYPES_KINDS = {
    "c_void_p": "pointer", "c_char_p": "pointer", "c_wchar_p": "pointer",
    "py_object": "pointer",
    "c_float": "float", "c_double": "float", "c_longdouble": "float",
}
for _t in ("c_bool", "c_byte", "c_ubyte", "c_char", "c_short", "c_ushort",
           "c_int", "c_uint", "c_long", "c_ulong", "c_longlong",
           "c_ulonglong", "c_size_t", "c_ssize_t", "c_int8", "c_uint8",
           "c_int16", "c_uint16", "c_int32", "c_uint32", "c_int64",
           "c_uint64"):
    _CTYPES_KINDS[_t] = "int"


class _Unknown(Exception):
    """A value the folder cannot know statically."""


class _CFunc(str):
    """A name bound to a C entry point (``fn = lib.dtt_x``)."""


def _fold(ctx: ModuleContext, node: ast.AST, env: Dict[str, Any]) -> Any:
    if isinstance(node, ast.Constant) and isinstance(node.value,
                                                     (int, str)):
        return node.value
    if isinstance(node, (ast.List, ast.Tuple)):
        return [_fold(ctx, e, env) for e in node.elts]
    if isinstance(node, ast.BinOp):
        a, b = _fold(ctx, node.left, env), _fold(ctx, node.right, env)
        try:
            if isinstance(node.op, ast.Add):
                return a + b
            if isinstance(node.op, ast.Mult):
                return a * b
            if isinstance(node.op, ast.Sub):
                return a - b
        except TypeError:
            raise _Unknown() from None
        raise _Unknown()
    if isinstance(node, ast.Name) and node.id in env:
        return env[node.id]
    if isinstance(node, ast.Call):
        if (ctx.call_name(node) or "") == "ctypes.POINTER":
            return "pointer"
        raise _Unknown()
    if isinstance(node, (ast.Name, ast.Attribute)):
        dotted = ctx.dotted(node) or ""
        head, _, attr = dotted.rpartition(".")
        if head == "ctypes" and attr in _CTYPES_KINDS:
            return _CTYPES_KINDS[attr]
    raise _Unknown()


def _module_env(ctx: ModuleContext) -> Dict[str, Any]:
    """Module-level names bound to foldable constants (``_P =
    ctypes.c_void_p``, ``N = 4``), and tables (dict literals) as
    ``{"<table>": [row values]}``."""
    env: Dict[str, Any] = {}
    for stmt in ctx.tree.body:
        if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            continue
        name = stmt.targets[0].id
        if isinstance(stmt.value, ast.Dict):
            rows = []
            for v in stmt.value.values:
                try:
                    rows.append(_fold(ctx, v, env))
                except _Unknown:
                    pass
            env[name] = _Table(rows)
            continue
        try:
            env[name] = _fold(ctx, stmt.value, env)
        except _Unknown:
            pass
    return env


class _Table(list):
    """The foldable rows of a module-level dict literal."""


def _scope_envs(ctx: ModuleContext, nodes: List[ast.AST],
                base: Dict[str, Any],
                sigs: Dict[str, List[str]]) -> List[Dict[str, Any]]:
    """Every environment the bindings among ``nodes`` (one scope's, in
    source order) can take: simple constant bindings, unpacks of a table
    row (one environment per row) and loops over constant names (one per
    name), and names bound to C entry points."""
    groups: List[List[Dict[str, Any]]] = []
    env = dict(base)
    for node in nodes:
        if isinstance(node, ast.For) and isinstance(node.target, ast.Name):
            try:
                seq = _fold(ctx, node.iter, env)
            except _Unknown:
                continue
            if isinstance(seq, list) and seq:
                groups.append([{node.target.id: v} for v in seq])
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            t, v = node.targets[0], node.value
            if (isinstance(t, ast.Tuple)
                    and all(isinstance(e, ast.Name) for e in t.elts)
                    and isinstance(v, ast.Subscript)
                    and isinstance(v.value, ast.Name)
                    and isinstance(base.get(v.value.id), _Table)):
                names = [e.id for e in t.elts]
                rows = [dict(zip(names, r)) for r in base[v.value.id]
                        if isinstance(r, list) and len(r) == len(names)]
                if rows:
                    groups.append(rows)
            elif isinstance(t, ast.Name):
                c = _c_binding(ctx, v, sigs)
                if c is not None:
                    env[t.id] = c
                    continue
                if isinstance(v, ast.Call) and isinstance(v.func, ast.Name) \
                        and v.func.id == "getattr" and len(v.args) == 2:
                    env[t.id] = ("getattr", v.args[1])
                    continue
                try:
                    env[t.id] = _fold(ctx, v, env)
                except _Unknown:
                    env.pop(t.id, None)
    envs = []
    for combo in itertools.islice(itertools.product(*groups), 256):
        e = dict(env)
        for part in combo:
            e.update(part)
        # getattr(lib, name): the entry point named by the environment
        for k, v in list(e.items()):
            if isinstance(v, tuple) and v and v[0] == "getattr":
                try:
                    name = _fold(ctx, v[1], e)
                except _Unknown:
                    e.pop(k)
                    continue
                if isinstance(name, str) and name in sigs:
                    e[k] = _CFunc(name)
                else:
                    e.pop(k)
        envs.append(e)
    return envs


def _c_binding(ctx: ModuleContext, node: ast.AST,
               sigs: Dict[str, List[str]]) -> Optional[_CFunc]:
    """``lib.dtt_x`` -> the C entry point it names, if it is one."""
    if isinstance(node, ast.Attribute) and node.attr in sigs:
        return _CFunc(node.attr)
    return None


def _target_cfunc(node: ast.AST, env: Dict[str, Any],
                  sigs: Dict[str, List[str]]) -> Optional[str]:
    """The C entry point an ``X.argtypes`` / call target names under
    ``env``: ``lib.dtt_x`` or a name bound to one."""
    if isinstance(node, ast.Attribute) and node.attr in sigs:
        return node.attr
    if isinstance(node, ast.Name) and isinstance(env.get(node.id), _CFunc):
        return str(env[node.id])
    return None


def _bindings(ctx: ModuleContext, sigs: Dict[str, List[str]]) -> list:
    """``(node, c name, folded argtypes or None, call arg count or None)``
    for every ``X.argtypes = ...`` and every call of an entry point, under
    each environment of its scope (duplicates dropped); computed once per
    module, and only where its text names an entry point."""
    cached = getattr(ctx, "_kernel_bindings", None)
    if cached is None:
        text = "\n".join(ctx.source_lines)
        cached = (list(_resolve(ctx, sigs)) if any(n in text for n in sigs)
                  else [])
        ctx._kernel_bindings = cached
    return cached


def _resolve(ctx: ModuleContext, sigs: Dict[str, List[str]]):
    # each node under its innermost function (None: the module), in
    # source order
    scopes: Dict[Any, List[ast.AST]] = {}
    for n in ast.walk(ctx.tree):
        if hasattr(n, "lineno"):
            scopes.setdefault(ctx.enclosing_function(n), []).append(n)
    base = None
    seen = set()
    for nodes in scopes.values():
        if not any(_candidate(n) for n in nodes):
            continue
        nodes.sort(key=lambda n: (n.lineno, n.col_offset))
        if base is None:
            base = _module_env(ctx)
        envs = _scope_envs(ctx, nodes, base, sigs)
        for node in nodes:
            if not _candidate(node):
                continue
            for env in envs:
                item = None
                if (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Attribute)
                        and node.targets[0].attr == "argtypes"):
                    name = _target_cfunc(node.targets[0].value, env, sigs)
                    if name is None:
                        continue
                    try:
                        kinds = _fold(ctx, node.value, env)
                    except _Unknown:
                        continue
                    if isinstance(kinds, list) and all(
                            isinstance(k, str) for k in kinds):
                        item = (node, name, tuple(kinds), None)
                elif isinstance(node, ast.Call):
                    name = _target_cfunc(node.func, env, sigs)
                    if name is None or node.keywords or any(
                            isinstance(a, ast.Starred) for a in node.args):
                        continue
                    item = (node, name, None, len(node.args))
                if item is not None and (id(node), item[1:]) not in seen:
                    seen.add((id(node), item[1:]))
                    yield item


def _candidate(node: ast.AST) -> bool:
    """An ``X.argtypes = ...`` assignment, or a call."""
    return isinstance(node, ast.Call) or (
        isinstance(node, ast.Assign) and len(node.targets) == 1
        and isinstance(node.targets[0], ast.Attribute)
        and node.targets[0].attr == "argtypes")


def _signatures(ctx: ModuleContext) -> Dict[str, List[str]]:
    return kernel_signatures(ctx.config.root, ctx.config.kernel_sources)


class ArgtypeKinds(Rule):
    code = "DT401"
    name = "argtypes-kind-mismatch"
    rationale = ("a ctypes argtypes entry of another kind than the extern "
                 "\"C\" parameter it feeds passes a pointer as an int (or "
                 "the reverse): a corrupt launch, not an error")

    def visit_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        sigs = _signatures(ctx)
        if not sigs:
            return
        for node, name, kinds, _ in _bindings(ctx, sigs):
            want = sigs[name]
            if kinds is None or len(kinds) != len(want):
                continue
            for i, (got, c) in enumerate(zip(kinds, want)):
                if got != c:
                    yield ctx.finding(
                        self.code, node,
                        f"argtypes[{i}] of `{name}` is {got}; its extern "
                        f"\"C\" parameter {i} is {c}")


class ArgtypeArity(Rule):
    code = "DT402"
    name = "argtypes-arity"
    rationale = ("an argtypes list or a call whose length differs from the "
                 "extern \"C\" signature shifts every later argument")

    def visit_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        sigs = _signatures(ctx)
        if not sigs:
            return
        for node, name, kinds, n_args in _bindings(ctx, sigs):
            want = len(sigs[name])
            if kinds is not None and len(kinds) != want:
                yield ctx.finding(
                    self.code, node,
                    f"argtypes of `{name}` has {len(kinds)} entries; its "
                    f"extern \"C\" signature takes {want} parameters")
            elif n_args is not None and n_args != want:
                yield ctx.finding(
                    self.code, node,
                    f"call of `{name}` passes {n_args} arguments; its "
                    f"extern \"C\" signature takes {want} parameters")


RULES = [ArgtypeKinds(), ArgtypeArity()]
