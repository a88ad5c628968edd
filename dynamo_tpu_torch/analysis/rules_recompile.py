"""DT2xx — capture hazards: what a CUDA graph or ``torch.compile`` freezes.

A capture target (a function called inside ``with torch.cuda.graph(...)``,
or passed to ``torch.compile`` / ``torch.cuda.make_graphed_callables``) is
run once and replayed: a mutable global it reads is frozen at its capture
value, a Python branch on a tensor argument either syncs the host during
capture or freezes one branch into the graph, and a graph or compiled
wrapper built inside a loop is captured or compiled again every
iteration. These are the twins of the JAX package's recompile rules, by
code.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, Set

from .core import Finding, ModuleContext, Rule

_MUTABLE_CALLS = {"dict", "list", "set", "bytearray",
                  "collections.defaultdict", "collections.deque",
                  "collections.OrderedDict", "collections.Counter"}
_SAFE_ATTRS = {"shape", "ndim", "dtype", "size", "numel", "dim", "device",
               "is_cuda"}
_SAFE_CALLS = {"len", "isinstance", "hasattr", "getattr", "type"}
# constructors that build a CUDA graph or a compiled wrapper
_GRAPH_BUILDERS = ("torch.cuda.CUDAGraph", "torch.cuda.graph",
                   "torch.compile")


def _module_mutables(ctx: ModuleContext) -> Set[str]:
    """Module-level names bound to mutable containers."""
    out: Set[str] = set()
    for stmt in ctx.tree.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        else:
            continue
        mutable = isinstance(value, (ast.List, ast.Dict, ast.Set,
                                     ast.ListComp, ast.DictComp, ast.SetComp))
        if isinstance(value, ast.Call):
            mutable = (ctx.call_name(value) or "") in _MUTABLE_CALLS
        if not mutable:
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                out.add(t.id)
    return out


def _local_bindings(func: ast.AST) -> Set[str]:
    """Names bound inside ``func`` (params, assignments, nested defs)."""
    args = func.args
    names = {a.arg for a in (args.posonlyargs + args.args + args.kwonlyargs)}
    if args.vararg:
        names.add(args.vararg.arg)
    if args.kwarg:
        names.add(args.kwarg.arg)
    for node in ast.walk(func):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)) and node is not func:
            names.add(node.name)
    return names


class CaptureMutableGlobal(Rule):
    code = "DT201"
    name = "capture-mutable-global"
    rationale = ("a captured function reading mutable module state freezes "
                 "its capture-time value into the graph — later mutations "
                 "are silently ignored by every replay")

    def visit_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        mutables = _module_mutables(ctx)
        for func in ctx.capture_targets:
            local = _local_bindings(func)
            seen: Set[str] = set()
            for node in ast.walk(func):
                if isinstance(node, ast.Global):
                    yield ctx.finding(
                        self.code, node,
                        "`global` inside a captured function: writes happen "
                        "at capture time, not per replay")
                elif (isinstance(node, ast.Name)
                      and isinstance(node.ctx, ast.Load)
                      and node.id in mutables
                      and node.id not in local
                      and node.id not in seen):
                    seen.add(node.id)
                    yield ctx.finding(
                        self.code, node,
                        f"captured function reads mutable module global "
                        f"`{node.id}`; its value is frozen into the graph at "
                        "capture — pass it as a tensor argument or make it "
                        "immutable")


class CaptureTensorBranch(Rule):
    code = "DT202"
    name = "capture-tensor-branch"
    rationale = ("Python `if`/`while` on a tensor argument of a captured "
                 "function syncs the host during capture and freezes one "
                 "branch into the graph")

    def _offending_names(self, ctx: ModuleContext, test: ast.AST,
                         tensors: Set[str]) -> Set[str]:
        bad: Set[str] = set()
        for node in ast.walk(test):
            if not (isinstance(node, ast.Name)
                    and isinstance(node.ctx, ast.Load)
                    and node.id in tensors):
                continue
            parent = ctx.parents.get(node)
            # x.shape / x.ndim / x.dtype are host metadata, no sync
            if isinstance(parent, ast.Attribute) and \
                    parent.attr in _SAFE_ATTRS:
                continue
            # len(x), isinstance(x, T), type(x) are host-side
            if isinstance(parent, ast.Call) and \
                    (ctx.call_name(parent) or "") in _SAFE_CALLS:
                continue
            # `x is None` / `x is not None` never touches the tensor value
            comp = parent
            while comp is not None and not isinstance(comp, ast.Compare):
                if isinstance(comp, (ast.Lambda, ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    comp = None
                    break
                comp = ctx.parents.get(comp)
            if isinstance(comp, ast.Compare) and \
                    all(isinstance(op, (ast.Is, ast.IsNot))
                        for op in comp.ops):
                continue
            bad.add(node.id)
        return bad

    def visit_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        for func in ctx.capture_targets:
            tensors = ctx.tensor_params(func)
            if not tensors:
                continue
            for node in ast.walk(func):
                if not isinstance(node, (ast.If, ast.While, ast.IfExp)):
                    continue
                bad = self._offending_names(ctx, node.test, tensors)
                if bad:
                    names = ", ".join(f"`{n}`" for n in sorted(bad))
                    yield ctx.finding(
                        self.code, node,
                        f"Python branch on tensor argument(s) {names} inside "
                        "a captured function; use torch.where or decide it "
                        "on the host before capture")


class GraphInLoop(Rule):
    code = "DT203"
    name = "graph-in-loop"
    rationale = ("a `torch.cuda.CUDAGraph()`, `torch.cuda.graph(...)` or "
                 "`torch.compile(...)` built inside a loop captures or "
                 "compiles again every iteration")

    def visit_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and ctx.call_name(node) in _GRAPH_BUILDERS):
                continue
            cur = ctx.parents.get(node)
            while cur is not None and not isinstance(
                    cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if isinstance(cur, (ast.For, ast.While, ast.AsyncFor)):
                    what = ctx.call_name(node)
                    yield ctx.finding(
                        self.code, node,
                        f"`{what}` built inside a loop: each iteration "
                        "captures or compiles anew — hoist it out of the "
                        "loop and replay")
                    break
                cur = ctx.parents.get(cur)


RULES = [CaptureMutableGlobal(), CaptureTensorBranch(), GraphInLoop()]
