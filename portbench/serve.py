"""Driving the program: requests through ``EngineCore.generate`` in an open
or a closed loop, every output token stamped on the host's monotonic clock
as the consumer receives it."""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import List, Optional

from .traffic import Plan, Req


@dataclass
class Result:
    req: Req
    t_due: float                      # monotonic; when the request was due
    t_submit: float = 0.0
    times: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    finish: Optional[str] = None
    error: Optional[str] = None

    @property
    def complete(self) -> bool:
        return (self.error is None and self.finish == "length"
                and len(self.tokens) == self.req.osl)


def request_dict(req: Req) -> dict:
    return {"token_ids": req.token_ids, "max_tokens": req.osl,
            "temperature": 0.0, "ignore_eos": True}


async def one(engine, context_cls, res: Result) -> None:
    """One request, start to end; an exception is the request's failure."""
    res.t_submit = time.monotonic()
    try:
        async for out in engine.generate(request_dict(res.req),
                                          context_cls()):
            now = time.monotonic()
            # the finish of a request ended early (the engine stopped)
            # repeats its last token under its last index: keep new ones
            if out["index"] == len(res.tokens):
                for tok in out["token_ids"]:
                    res.times.append(now)
                    res.tokens.append(int(tok))
            if out["finished"]:
                res.finish = out.get("finish_reason")
    except Exception as e:  # the request failed; the run goes on
        res.error = f"{type(e).__name__}: {e}"


async def run_open(engine, context_cls, plan: Plan, t0: float, t1: float,
                   drain_s: float) -> List[Result]:
    """Send each request at its due time. After the window, wait (up to
    ``drain_s``) until every request has its first token, then stop the
    engine, which ends the rest."""
    results, tasks = [], []
    for req in plan.requests:
        due = t0 + req.due_s
        delay = due - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        res = Result(req, due)
        results.append(res)
        tasks.append(asyncio.create_task(one(engine, context_cls, res)))
    await asyncio.sleep(max(0.0, t1 - time.monotonic()))
    deadline = t1 + drain_s
    while (time.monotonic() < deadline
           and any(not r.times and r.error is None for r in results)):
        await asyncio.sleep(0.05)
    await engine.stop()
    await asyncio.gather(*tasks)
    return results


async def run_closed(engine, context_cls, plan: Plan, t_start: float,
                     t1: float) -> List[Result]:
    """Each client sends its next request when the last ends, from
    ``t_start`` (the ramp, before the window) until ``t1``; then the engine
    is stopped, which ends the requests in flight."""
    results: List[Result] = []

    async def client(queue: List[Req]) -> None:
        for req in queue:
            now = time.monotonic()
            if now >= t1:
                return
            res = Result(req, now)
            results.append(res)
            await one(engine, context_cls, res)
            if not res.complete:
                return

    delay = t_start - time.monotonic()
    if delay > 0:
        await asyncio.sleep(delay)
    tasks = [asyncio.create_task(client(q)) for q in plan.clients]
    await asyncio.sleep(max(0.0, t1 - time.monotonic()))
    await engine.stop()
    await asyncio.gather(*tasks)
    return results
