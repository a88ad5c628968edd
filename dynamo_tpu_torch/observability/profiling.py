"""On-demand ``torch.profiler`` capture behind ``/debug/profile?ms=N``.

The twin of ``dynamo_tpu.observability.profiling``. One capture at a time
per process (the profiler is a global); each trace lands as a Chrome trace
(``trace.json``, loadable in Perfetto or ``chrome://tracing``) in a fresh
directory under the configured base dir (``DYNTPU_OBS_PROFILE_DIR``, default
the system temp dir). With a card in the process the capture records its
CUDA activity (every kernel, from whichever thread or graph replay launched
it) beside the CPU's; without one, the CPU's only. ``torch`` is imported at
the first capture, never with this module.

The engine loop's spans that end during the capture (``engine.step`` and
its phases, ``tracing/``) are written into the same ``trace.json`` as
async slices of a process of their own, on the trace's own time base: the
collector's monotonic→Unix offset is taken anew at each start, and the
profiler stamps its events on the Unix clock, so the loop's phases lie
above the kernels they launched.

Starting and stopping the profiler toggles CUPTI, and on an H100 (torch
2.11, CUDA 12.8) a stop on the event loop's thread deadlocked against a
CUDA graph launch on the engine's step thread, both blocked on the host
(``scripts/profile_soak.py`` repeats captures to catch it).
:data:`LAUNCH_GATE` keeps the two apart: code that launches on the card
from a thread of its own (the engine's step thread, the vision encoder)
holds :meth:`LaunchGate.launching`, and the capture starts and stops the
profiler under :meth:`LaunchGate.toggling`, off the event loop.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import json
import os
import tempfile
import threading
import time

from .. import tracing
from ..utils.logging import get_logger

log = get_logger("observability.profile")

DEFAULT_MS = 1000
MAX_MS = 30_000
TRACE_FILE = "trace.json"
SPANS_PID = "engine loop spans"

_capture_lock = threading.Lock()  # one capture per process, ever


class LaunchGate:
    """Any number of launching threads at once, or one profiler toggle
    alone. A toggle waits for the launches in flight to end and holds new
    ones back until it is done."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._launching = 0
        self._toggling = False

    @contextlib.contextmanager
    def launching(self):
        with self._cond:
            while self._toggling:
                self._cond.wait()
            self._launching += 1
        try:
            yield
        finally:
            with self._cond:
                self._launching -= 1
                if not self._launching:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def toggling(self):
        with self._cond:
            while self._toggling:
                self._cond.wait()
            self._toggling = True
            while self._launching:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._toggling = False
                self._cond.notify_all()


LAUNCH_GATE = LaunchGate()


def default_base_dir() -> str:
    return os.environ.get(
        "DYNTPU_OBS_PROFILE_DIR",
        os.path.join(tempfile.gettempdir(), "dyntpu-profiles"),
    )


def add_spans(trace_file: str, spans) -> None:
    """Lay ``spans`` into a Chrome trace the profiler wrote, on its time
    base (``baseTimeNanoseconds``, 0 when the trace has none), as async
    slices: ``b``/``e`` pairs, which may overlap, as consecutive steps do
    at run-ahead depth 2."""
    with open(trace_file) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = trace.setdefault("traceEvents", [])
    for sp in spans:
        ts = (sp.start_unix * 1e9 - base) / 1e3       # microseconds
        common = {"cat": "engine", "name": sp.name, "id": sp.span_id,
                  "pid": SPANS_PID, "tid": SPANS_PID}
        events.append({"ph": "b", "ts": ts, "args": dict(sp.attrs),
                       **common})
        events.append({"ph": "e", "ts": ts + (sp.duration_s or 0.0) * 1e6,
                       **common})
    with open(trace_file, "w") as f:
        json.dump(trace, f)


class ProfileBusyError(RuntimeError):
    """A capture is already running in this process."""


async def capture(ms: int, base_dir: str = "") -> dict:
    """Capture a ``ms``-millisecond profiler trace (clamped to 1..MAX_MS);
    returns its metadata (``trace_file`` is the Chrome trace). Raises
    :class:`ProfileBusyError` when a capture is already in flight."""
    ms = max(1, min(int(ms), MAX_MS))
    base = base_dir or default_base_dir()
    if not _capture_lock.acquire(blocking=False):
        raise ProfileBusyError("a profile capture is already running")
    loop = asyncio.get_running_loop()
    # start and stop on one thread of their own: a toggle may wait for the
    # step thread's task in flight, which must not hold up the event loop
    toggler = concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="profile-toggle")

    def toggle(fn):
        with LAUNCH_GATE.toggling():
            fn()

    try:
        os.makedirs(base, exist_ok=True)
        trace_dir = tempfile.mkdtemp(
            prefix=time.strftime("trace-%Y%m%d-%H%M%S-"), dir=base
        )
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        tracer = tracing.get_tracer()
        tracer.calibrate_clock()
        t0 = time.monotonic()
        # an open tap is a sink: the engine loop mints its spans meanwhile
        with tracer.tap() as spans:
            await loop.run_in_executor(toggler, toggle, prof.start)
            try:
                # the wait yields the event loop: the engine keeps serving
                # (that is the point: profile it under load)
                await asyncio.sleep(ms / 1000.0)
            finally:
                await loop.run_in_executor(toggler, toggle, prof.stop)
        wall_ms = (time.monotonic() - t0) * 1000.0
        trace_file = os.path.join(trace_dir, TRACE_FILE)
        # writing a loaded trace takes a while: off the event loop
        await asyncio.to_thread(prof.export_chrome_trace, trace_file)
        if spans:
            await asyncio.to_thread(add_spans, trace_file, spans)
    finally:
        toggler.shutdown(wait=False)
        _capture_lock.release()
    log.info("profiler trace captured to %s (%.0f ms)", trace_file, wall_ms)
    return {
        "trace_dir": trace_dir,
        "trace_file": trace_file,
        "requested_ms": ms,
        "captured_ms": round(wall_ms, 1),
        "activities": [a.name for a in activities],
    }
