"""DT5xx — sharding consistency.

The port reads a spec per leaf twice (to slice a rank's part, and in the
model's forward, which is written for the slices), and its process groups
are made once per world and shape, by every rank alike: an axis name spelled
as a string, a ``Mesh`` built by hand or a process group made outside
``parallel/layout.py`` / ``parallel/comm.py`` is one more place the ranks'
view of the layout can drift from the table, or a collective can deadlock
on a group one rank never made. The canonical vocabulary is ``AXIS_*`` of
``dynamo_tpu_torch/parallel/layout.py``; everything else imports it.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from .core import Finding, ModuleContext, Rule

_SPEC_CALLS = ("spec", "Spec", "Mesh", "SpecLayout")
_AXIS_KWARGS = ("axis", "axis_name", "axis_names")
_GROUP_CALLS = ("torch.distributed.new_group",
                "torch.distributed.init_process_group")


def _axis_literals(ctx: ModuleContext, node: ast.AST) -> Set[str]:
    """Axis names spelled as string literals in ``node`` — not a dict or
    subscript key such as ``ctl["tp"]`` (top-p), which names no axis."""
    keys = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Subscript):
            keys.update(id(k) for k in ast.walk(sub.slice))
        elif isinstance(sub, ast.Dict):
            keys.update(id(k) for k in sub.keys if k is not None)
    return {sub.value for sub in ast.walk(node)
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str)
            and sub.value in ctx.config.axis_names and id(sub) not in keys}


def _named(name: str, calls) -> bool:
    return any(name == c or name.endswith("." + c) for c in calls)


class HardcodedAxisName(Rule):
    code = "DT501"
    name = "hardcoded-mesh-axis"
    rationale = ("mesh axis names spelled as string literals drift between "
                 "modules, and a rank then slices or reduces over an axis "
                 "the table does not have; import the AXIS_* constants from "
                 "parallel/layout.py")

    def visit_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        if ctx.is_layout_module:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            axes: Set[str] = set()
            if _named(ctx.call_name(node) or "", _SPEC_CALLS):
                axes |= _axis_literals(ctx, node)
            for kw in node.keywords:
                if kw.arg in _AXIS_KWARGS:
                    axes |= _axis_literals(ctx, kw.value)
            if axes:
                names = ", ".join(f'"{a}"' for a in sorted(axes))
                yield ctx.finding(
                    self.code, node,
                    f"hard-coded mesh axis name(s) {names}; use the "
                    "canonical constants from dynamo_tpu_torch.parallel."
                    "layout")


class AdHocMesh(Rule):
    code = "DT502"
    name = "ad-hoc-mesh"
    rationale = ("every Mesh or process group made outside the layout "
                 "modules is one more place rank order, axis naming and "
                 "group creation can disagree with the engine's")

    def visit_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        if ctx.is_layout_module:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = ctx.call_name(node) or ""
            if name == "Mesh" or name.endswith(".Mesh"):
                yield ctx.finding(
                    self.code, node,
                    "Mesh constructed outside dynamo_tpu_torch/parallel/"
                    "layout.py; build it with layout.make_mesh")
            elif name in _GROUP_CALLS:
                yield ctx.finding(
                    self.code, node,
                    f"`{name.rpartition('.')[2]}` outside the layout "
                    "modules; make process groups through dynamo_tpu_torch"
                    ".parallel.comm, by every rank alike")


class AdHocSpec(Rule):
    code = "DT503"
    name = "ad-hoc-spec"
    rationale = ("an axis-carrying spec built outside the layout module is "
                 "a private opinion about tensor placement; when it "
                 "disagrees with SpecLayout a rank slices or reduces the "
                 "wrong part — route every spec through dynamo_tpu_torch."
                 "parallel.layout")

    def visit_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        if ctx.is_layout_module:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if not _named(ctx.call_name(node) or "", ("spec", "Spec")):
                continue
            # spec() / spec(None, ...) is the replicated spec — harmless;
            # any other argument names axes
            args_carry = any(
                not (isinstance(a, ast.Constant) and a.value is None)
                for a in node.args
            ) or bool(node.keywords)
            if args_carry:
                yield ctx.finding(
                    self.code, node,
                    "axis-carrying spec constructed outside dynamo_tpu_torch"
                    "/parallel/layout.py; use the SpecLayout helpers")


RULES = [HardcodedAxisName(), AdHocMesh(), AdHocSpec()]
