"""The port's ``TaskTracker`` family against the JAX package's: every case
of ``tests/test_tasks.py`` run on both modules, and one seeded schedule of
successes, failures, retries, a ``SHUTDOWN`` and a cascading ``cancel()``
over a three-level tree, which must leave equal ``TrackerStats`` at every
level and equal sets of cancelled task names."""

import asyncio
import dataclasses

import numpy as np
import pytest

from dynamo_tpu.runtime import tasks as jax_tasks
from dynamo_tpu_torch.runtime import tasks as torch_tasks

pytestmark = pytest.mark.anyio

MODULES = pytest.mark.parametrize(
    "T", [jax_tasks, torch_tasks], ids=["jax", "torch"])


@pytest.fixture
def anyio_backend():
    return "asyncio"


@MODULES
async def test_spawn_and_join(T):
    tr = T.TaskTracker()
    results = []

    async def work(i):
        results.append(i)

    for i in range(5):
        tr.spawn(lambda i=i: work(i))
    await tr.join()
    assert sorted(results) == list(range(5))
    assert tr.stats.succeeded == 5 and tr.stats.failed == 0


@MODULES
async def test_semaphore_scheduler_limits_concurrency(T):
    tr = T.TaskTracker(scheduler=T.SemaphoreScheduler(2))
    running = 0
    peak = 0

    async def work():
        nonlocal running, peak
        running += 1
        peak = max(peak, running)
        await asyncio.sleep(0.02)
        running -= 1

    for _ in range(8):
        tr.spawn(work)
    await tr.join()
    assert peak <= 2
    assert tr.stats.succeeded == 8


@MODULES
async def test_log_policy_counts_failures(T):
    tr = T.TaskTracker(on_error=T.OnError.LOG)
    errors = []
    tr.error_handler = lambda name, e: errors.append((name, str(e)))

    async def bad():
        raise ValueError("nope")

    t = tr.spawn(bad)
    await tr.join()
    assert t.result() is None  # swallowed, not raised
    assert tr.stats.failed == 1
    assert errors and "nope" in errors[0][1]


@MODULES
async def test_retry_policy_retries_then_succeeds(T):
    tr = T.TaskTracker(
        on_error=T.OnError.RETRY,
        retry=T.RetryPolicy(max_retries=5, backoff_s=0.001),
    )
    attempts = {"n": 0}

    async def flaky():
        attempts["n"] += 1
        if attempts["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    t = tr.spawn(flaky)
    await tr.join()
    assert t.result() == "ok"
    assert tr.stats.retried == 2 and tr.stats.succeeded == 1


@MODULES
async def test_retry_exhaustion_fails(T):
    tr = T.TaskTracker(
        on_error=T.OnError.RETRY,
        retry=T.RetryPolicy(max_retries=2, backoff_s=0.001),
    )

    async def always_bad():
        raise RuntimeError("permanent")

    tr.spawn(always_bad)
    await tr.join()
    assert tr.stats.retried == 2 and tr.stats.failed == 1


@MODULES
async def test_shutdown_policy_cancels_tracker(T):
    tr = T.TaskTracker(on_error=T.OnError.SHUTDOWN)
    cancelled = asyncio.Event()

    async def long_running():
        try:
            await asyncio.sleep(30)
        except asyncio.CancelledError:
            cancelled.set()
            raise

    async def bad():
        await asyncio.sleep(0.01)
        raise RuntimeError("fatal")

    tr.spawn(long_running)
    tr.spawn(bad)
    await tr.join()
    assert cancelled.is_set()
    with pytest.raises(RuntimeError):
        tr.spawn(bad)  # cancelled tracker refuses new work


@MODULES
async def test_child_cascade_cancel(T):
    root = T.TaskTracker()
    child = root.child("sub")
    child_cancelled = asyncio.Event()

    async def long_running():
        try:
            await asyncio.sleep(30)
        except asyncio.CancelledError:
            child_cancelled.set()
            raise

    child.spawn(long_running)
    await asyncio.sleep(0.01)
    assert root.active == 1
    root.cancel()
    await root.join()
    assert child_cancelled.is_set()
    assert root.active == 0


# ---------------------------------------------------------------------------
# one seeded schedule on both packages

# what a task does: succeed at once, fail `k` times then succeed, fail for
# good, or run until it is cancelled
KINDS = ("ok", "flaky", "bad", "long")


def schedule(seed: int):
    """``{tracker path: [(task name, kind, failures)]}`` over a three-level
    tree, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    plan = {}
    for path in ("root", "root/a", "root/a/x", "root/b", "root/b/y"):
        plan[path] = []
        for i in range(int(rng.integers(4, 9))):
            kind = KINDS[int(rng.integers(0, len(KINDS)))]
            if path == "root/a/x" and kind in ("bad", "flaky"):
                kind = "ok"        # the one shutdown is placed below
            if path == "root/b/y" and kind == "long":
                kind = "ok"        # a long task would hold a slot of two
            plan[path].append((f"{path}:{i}", kind,
                               int(rng.integers(1, 4))))
    # the shutdown tracker's trigger, with long tasks beside it
    plan["root/a/x"] += [("root/a/x:trigger", "bad", 1),
                         ("root/a/x:long", "long", 1)]
    return plan


async def run_schedule(T, plan):
    """Build the tree, spawn ``plan``, let every short task settle, cancel
    the root, join. Returns (stats per tracker path, cancelled names)."""
    root = T.TaskTracker("root", on_error=T.OnError.LOG)
    a = root.child("a", on_error=T.OnError.RETRY,
                   retry=T.RetryPolicy(max_retries=2, backoff_s=0.001))
    trackers = {
        "root": root,
        "root/a": a,
        "root/a/x": a.child("x", on_error=T.OnError.SHUTDOWN),
        "root/b": root.child("b"),
    }
    trackers["root/b/y"] = trackers["root/b"].child(
        "y", scheduler=T.SemaphoreScheduler(2))
    attempts = {}

    def factory(name, kind, k):
        async def work():
            attempts[name] = attempts.get(name, 0) + 1
            if kind == "long":
                await asyncio.sleep(30)
            elif kind == "bad":
                # the shutdown trigger fires after its siblings settled
                await asyncio.sleep(0.05 if name.endswith("trigger") else 0)
                raise RuntimeError(f"{name} fails")
            elif kind == "flaky" and attempts[name] <= k:
                raise RuntimeError(f"{name} attempt {attempts[name]}")
            return name
        return work

    spawned = []
    for path, jobs in plan.items():
        for name, kind, k in jobs:
            spawned.append(trackers[path].spawn(factory(name, kind, k),
                                                name=name))
    await asyncio.sleep(0.3)
    root.cancel()
    await root.join()
    # join waits for the root's children; the grandchildren settle too
    await asyncio.gather(*spawned, return_exceptions=True)
    assert all(t.done() for t in spawned)
    stats = {p: dataclasses.asdict(tr.stats) for p, tr in trackers.items()}
    return stats, {t.get_name() for t in spawned if t.cancelled()}


@pytest.mark.parametrize("seed", [0, 1, 2])
async def test_seeded_schedule_same_stats_in_both_packages(seed):
    plan = schedule(seed)
    want = await run_schedule(jax_tasks, plan)
    got = await run_schedule(torch_tasks, plan)
    assert got == want
    stats, cancelled = got
    # the shutdown took its own long task; the root's cancel took the rest
    assert "root/a/x:long" in cancelled
    assert stats["root/a/x"]["failed"] >= 1
    longs = {n for jobs in plan.values() for n, kind, _ in jobs
             if kind == "long"}
    # the trigger cancels its own tracker's tasks, itself among them: it
    # counts as failed, and its task ends cancelled
    assert cancelled == longs | {"root/a/x:trigger"}
    assert sum(s["cancelled"] for s in stats.values()) == len(longs)
    # RETRY counted every failed attempt up to max_retries (2)
    kinds_a = [(kind, k) for _, kind, k in plan["root/a"]]
    assert stats["root/a"]["retried"] == sum(
        min(k, 2) if kind == "flaky" else 2 if kind == "bad" else 0
        for kind, k in kinds_a)
