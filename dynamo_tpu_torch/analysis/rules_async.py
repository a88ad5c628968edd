"""DT3xx — async discipline in the serving loop (a copy of
``dynamo_tpu.analysis.rules_async``: the rules know no framework).

One blocking call inside a coroutine stalls every request on the event
loop; a dropped ``create_task`` handle is garbage-collectable mid-flight
and its exception evaporates ("Task exception was never retrieved" at
best); a bare ``except``/``except BaseException`` that doesn't re-raise
eats ``CancelledError`` and turns graceful drain into a hang.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from .core import Finding, ModuleContext, Rule

_BLOCKING = {
    "time.sleep": "await asyncio.sleep(...)",
    "os.system": "asyncio.create_subprocess_shell",
    "subprocess.run": "asyncio.create_subprocess_exec",
    "subprocess.call": "asyncio.create_subprocess_exec",
    "subprocess.check_call": "asyncio.create_subprocess_exec",
    "subprocess.check_output": "asyncio.create_subprocess_exec",
    "requests.get": "aiohttp",
    "requests.post": "aiohttp",
    "requests.put": "aiohttp",
    "requests.delete": "aiohttp",
    "requests.request": "aiohttp",
    "urllib.request.urlopen": "aiohttp",
    "socket.create_connection": "asyncio.open_connection",
    "socket.getaddrinfo": "loop.getaddrinfo",
    "select.select": "asyncio primitives",
}

_SPAWN_CALLS = ("asyncio.create_task", "asyncio.ensure_future")


class BlockingInAsync(Rule):
    code = "DT301"
    name = "blocking-call-in-async"
    rationale = ("a sync sleep/IO call inside `async def` freezes the whole "
                 "event loop, not just this request")

    def visit_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not ctx.in_async(node):
                continue
            name = ctx.call_name(node) or ""
            hint = _BLOCKING.get(name)
            if hint is not None:
                yield ctx.finding(
                    self.code, node,
                    f"blocking `{name}` inside a coroutine stalls the event "
                    f"loop; use {hint} (or asyncio.to_thread)")


def _is_spawn(ctx: ModuleContext, node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = ctx.call_name(node) or ""
    return name in _SPAWN_CALLS or name.endswith(".create_task")


class FireAndForgetTask(Rule):
    code = "DT302"
    name = "fire-and-forget-task"
    rationale = ("a task whose handle is dropped can be GC'd mid-flight and "
                 "its exception is silently lost; retain the handle or "
                 "attach a logging done-callback")

    def _assigned_name_unused(self, ctx: ModuleContext,
                              call: ast.Call) -> Optional[str]:
        parent = ctx.parents.get(call)
        if not (isinstance(parent, ast.Assign)
                and len(parent.targets) == 1
                and isinstance(parent.targets[0], ast.Name)):
            return None
        name = parent.targets[0].id
        scope = ctx.enclosing_function(call) or ctx.tree
        for node in ast.walk(scope):
            if (isinstance(node, ast.Name) and node.id == name
                    and isinstance(node.ctx, ast.Load)):
                return None
        return name

    def visit_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not _is_spawn(ctx, node):
                continue
            parent = ctx.parents.get(node)
            if isinstance(parent, ast.Expr):
                yield ctx.finding(
                    self.code, node,
                    "task handle discarded at statement level; keep a "
                    "reference (or use runtime.tasks.spawn_logged)")
            elif isinstance(parent, ast.Lambda) and parent.body is node:
                yield ctx.finding(
                    self.code, node,
                    "task spawned in a callback lambda: the returned handle "
                    "is dropped by the caller (signal handlers ignore it); "
                    "use runtime.tasks.spawn_logged")
            elif isinstance(parent, ast.Await):
                continue  # awaited inline — fine
            else:
                name = self._assigned_name_unused(ctx, node)
                if name is not None:
                    yield ctx.finding(
                        self.code, node,
                        f"task handle `{name}` is never awaited, cancelled "
                        "or stored; the task can vanish mid-flight with its "
                        "exception unread")


def _catches_cancel_shield(ctx: ModuleContext,
                           handler: ast.ExceptHandler) -> bool:
    """Handler type is bare / BaseException / includes CancelledError."""
    t = handler.type
    if t is None:
        return True
    names = []
    if isinstance(t, ast.Tuple):
        names = [ctx.dotted(e) or "" for e in t.elts]
    else:
        names = [ctx.dotted(t) or ""]
    return any(n in ("BaseException", "builtins.BaseException",
                     "asyncio.CancelledError", "CancelledError",
                     "concurrent.futures.CancelledError")
               for n in names)


def _reraises(handler: ast.ExceptHandler) -> bool:
    stack = list(handler.body)
    while stack:
        node = stack.pop()
        # a raise inside a nested def doesn't re-raise for this handler
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Raise):
            if node.exc is None:
                return True
            if (isinstance(node.exc, ast.Name) and handler.name
                    and node.exc.id == handler.name):
                return True
        stack.extend(ast.iter_child_nodes(node))
    return False


class CancelledSwallow(Rule):
    code = "DT303"
    name = "cancelled-error-swallow"
    rationale = ("bare `except`/`except BaseException` without re-raise "
                 "swallows CancelledError — cancellation (drain, deadline, "
                 "client abort) silently stops working")

    def visit_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Try):
                continue
            cancel_already_reraised = False
            for handler in node.handlers:
                if not ctx.in_async(handler):
                    continue
                if not _catches_cancel_shield(ctx, handler):
                    continue
                t = handler.type
                is_cancel_only = t is not None and not isinstance(
                    t, ast.Tuple) and (ctx.dotted(t) or "").endswith(
                        "CancelledError")
                if _reraises(handler):
                    if is_cancel_only:
                        cancel_already_reraised = True
                    continue
                if is_cancel_only:
                    # `except CancelledError: pass` right after t.cancel()
                    # is the standard cancel-join idiom — leave it alone
                    continue
                if cancel_already_reraised:
                    continue
                what = ("bare `except:`" if t is None else
                        f"`except {ast.unparse(t)}`")
                yield ctx.finding(
                    self.code, handler,
                    f"{what} in a coroutine swallows CancelledError; "
                    "re-raise, or catch asyncio.CancelledError first and "
                    "`raise` it")


RULES = [BlockingInAsync(), FireAndForgetTask(), CancelledSwallow()]
