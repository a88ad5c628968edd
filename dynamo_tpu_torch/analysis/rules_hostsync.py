"""DT1xx — host-sync in hot paths, as it shows in PyTorch and CUDA.

The decode loop's throughput is set by how rarely the host waits for the
card: every ``.item()`` / ``.cpu()`` / ``torch.cuda.synchronize()`` inside
a hot function drains the stream the engine keeps full with run-ahead
windows. And a persistent device buffer rebound to an out-of-place result
each step allocates and copies the whole buffer where the in-place form
writes a few rows. Scope: functions marked ``@hot_path`` anywhere, or any
function body in the hot-module allowlist (``AnalysisConfig.hot_modules``
— ops/, the engine, the model, the scheduler, spec decoding).
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from .core import Finding, ModuleContext, Rule


def _mentions_torch(ctx: ModuleContext, node: ast.AST) -> bool:
    """Does any name in this subtree resolve under the torch package?"""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Name, ast.Attribute)):
            dotted = ctx.dotted(sub)
            if dotted and dotted.split(".")[0] == "torch":
                return True
    return False


def _is_cpu_device(ctx: ModuleContext, node: ast.AST) -> bool:
    """``"cpu"``, or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call)
            and ctx.call_name(node) == "torch.device" and bool(node.args)
            and _is_cpu_device(ctx, node.args[0]))


def _transfer(ctx: ModuleContext, call: ast.Call) -> Optional[str]:
    """The device-to-host copy ``call`` makes (``.cpu()``, ``.to("cpu")``,
    ``.numpy()``), or None."""
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    if attr == "cpu" and not call.args:
        return ".cpu()"
    if attr == "to":
        dev = [a for a in call.args[:1]] + [k.value for k in call.keywords
                                            if k.arg == "device"]
        if any(_is_cpu_device(ctx, d) for d in dev):
            return '.to("cpu")'
    if attr == "numpy" and not call.args:
        return ".numpy()"
    return None


class HostScalarSync(Rule):
    code = "DT101"
    name = "host-scalar-sync"
    rationale = ("`.item()`/`.tolist()`/`int(tensor)` in a hot path blocks "
                 "the host on the CUDA stream once per call")

    def visit_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not ctx.hot_scope(node):
                continue
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("item", "tolist"):
                yield ctx.finding(
                    self.code, node,
                    f"`.{node.func.attr}()` forces a device→host sync in a "
                    "hot path; keep the value on device or batch the fetch")
            elif (isinstance(node.func, ast.Name)
                  and node.func.id in ("int", "float", "bool")
                  and len(node.args) == 1
                  and _mentions_torch(ctx, node.args[0])):
                yield ctx.finding(
                    self.code, node,
                    f"`{node.func.id}()` on a torch value materialises it "
                    "on host; hot paths must not pull scalars per step")


class HostTransferSync(Rule):
    code = "DT102"
    name = "host-transfer-sync"
    rationale = ("`torch.cuda.synchronize`/`Event.synchronize()`/`.cpu()`/"
                 "`.numpy()`/`np.asarray(tensor)` in a hot path stalls "
                 "dispatch; syncs belong at designed window boundaries only")

    def visit_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not ctx.hot_scope(node):
                continue
            name = ctx.call_name(node) or ""
            what = _transfer(ctx, node)
            if name == "torch.cuda.synchronize":
                yield ctx.finding(
                    self.code, node,
                    "`torch.cuda.synchronize` in a hot path; move the sync "
                    "to the batching fetcher window or mark it intentional")
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr == "synchronize"):
                yield ctx.finding(
                    self.code, node,
                    "`.synchronize()` on an event or stream in a hot path "
                    "stalls the dispatch pipeline")
            elif what is not None:
                inner = node.func.value
                if what == ".numpy()" and isinstance(inner, ast.Call) and \
                        _transfer(ctx, inner) is not None:
                    continue  # x.cpu().numpy(): one copy, reported once
                yield ctx.finding(
                    self.code, node,
                    f"`{what}` in a hot path is a device→host copy that "
                    "waits for the stream")
            elif (name in ("numpy.asarray", "numpy.array")
                  and node.args and _mentions_torch(ctx, node.args[0])):
                yield ctx.finding(
                    self.code, node,
                    "`np.asarray` on a torch value is an implicit D2H copy "
                    "in a hot path")


# out-of-place tensor ops on a persistent buffer -> their in-place form
_IN_PLACE = {
    "index_copy": "index_copy_", "index_put": "index_put_",
    "scatter": "scatter_", "scatter_add": "scatter_add_",
    "index_add": "index_add_", "index_fill": "index_fill_",
    "masked_fill": "masked_fill_", "masked_scatter": "masked_scatter_",
    "clone": "copy_",
}


def _buffer_root(node: ast.AST) -> Optional[str]:
    """The buffer name an assignment target rebinds: ``cache``,
    ``self.cache`` or an entry ``ctl["ctr"]`` / ``cache["k"][i]`` of one."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


class OutOfPlaceBufferRebind(Rule):
    code = "DT103"
    name = "out-of-place-buffer-rebind"
    rationale = ("a hot function that rebinds a persistent device buffer "
                 "(cache/ctl/last_tok/ring) to an out-of-place result "
                 "allocates and copies the whole buffer every step; use the "
                 "in-place form or waive with a stated reason")

    # the engine's persistent mutable device state, by name (as in the
    # JAX rule's donated parameters)
    BUFFER_NAMES = ("cache", "ctl", "last_tok", "ring")

    def visit_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign)):
                continue
            value = node.value
            if not isinstance(value, ast.Call) or not ctx.hot_scope(node):
                continue
            if isinstance(value.func, ast.Attribute):
                op = value.func.attr
            else:
                op = (ctx.call_name(value) or "").rpartition(".")[2]
                if not (ctx.call_name(value) or "").startswith("torch."):
                    continue
            if op not in _IN_PLACE:
                continue
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                buf = _buffer_root(t)
                if buf not in self.BUFFER_NAMES:
                    continue
                fn = ctx.enclosing_function(node)
                yield ctx.finding(
                    self.code, node,
                    f"hot `{ctx.qualname(fn) if fn else '<module>'}` "
                    f"rebinds device buffer `{buf}` to an out-of-place "
                    f"`{op}` (a new buffer and a full copy every step); use "
                    f"`{_IN_PLACE[op]}` or waive with a reason "
                    "(# dynalint: disable=DT103)")


RULES = [HostScalarSync(), HostTransferSync(), OutOfPlaceBufferRebind()]
