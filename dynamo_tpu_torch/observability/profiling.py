"""On-demand ``torch.profiler`` capture behind ``/debug/profile?ms=N``.

The twin of ``dynamo_tpu.observability.profiling``. One capture at a time
per process (the profiler is a global); each trace lands as a Chrome trace
(``trace.json``, loadable in Perfetto or ``chrome://tracing``) in a fresh
directory under the configured base dir (``DYNTPU_OBS_PROFILE_DIR``, default
the system temp dir). With a card in the process the capture records its
CUDA activity (every kernel, from whichever thread or graph replay launched
it) beside the CPU's; without one, the CPU's only. ``torch`` is imported at
the first capture, never with this module.
"""

from __future__ import annotations

import asyncio
import os
import tempfile
import threading
import time

from ..utils.logging import get_logger

log = get_logger("observability.profile")

DEFAULT_MS = 1000
MAX_MS = 30_000
TRACE_FILE = "trace.json"

_capture_lock = threading.Lock()  # one capture per process, ever


def default_base_dir() -> str:
    return os.environ.get(
        "DYNTPU_OBS_PROFILE_DIR",
        os.path.join(tempfile.gettempdir(), "dyntpu-profiles"),
    )


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
        t0 = time.monotonic()
        prof.start()
        try:
            # the wait yields the event loop: the engine keeps serving
            # (that is the point: profile it under load)
            await asyncio.sleep(ms / 1000.0)
        finally:
            prof.stop()
        wall_ms = (time.monotonic() - t0) * 1000.0
        trace_file = os.path.join(trace_dir, TRACE_FILE)
        # writing a loaded trace takes a while: off the event loop
        await asyncio.to_thread(prof.export_chrome_trace, trace_file)
    finally:
        _capture_lock.release()
    log.info("profiler trace captured to %s (%.0f ms)", trace_file, wall_ms)
    return {
        "trace_dir": trace_dir,
        "trace_file": trace_file,
        "requested_ms": ms,
        "captured_ms": round(wall_ms, 1),
        "activities": [a.name for a in activities],
    }
