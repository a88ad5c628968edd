"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the last
seconds of the measured window, reduced in memory (no trace file is
written) to what the per-layer readers and the result's ``breakdown`` use.

Device events (kernels, copies, sets) and the host's CUDA runtime calls
come from CUPTI through the profiler's raw kineto events. A kernel and the
runtime call that launched it share a correlation id, so the kernels of one
CUDA graph replay (``cudaGraphLaunch``) are one decode window of the
program, and an idle gap is named by the runtime call that launched the
work ending it.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# substrings of the program's attention kernels' names (csrc/)
KERNELS = {
    "ragged": "ragged_paged_attention",
    "decode": "paged_attention_decode",
}


@dataclass
class TraceSummary:
    t_start: float                    # host monotonic, profiler on
    t_stop: float                     # host monotonic, profiler off
    busy_s: float                     # union of device activity
    window_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    graph_windows_s: List[float]      # device time of each graph replay
    kernel_time: Dict[str, Tuple[float, int]] = field(default_factory=dict)


class DeviceTrace:
    def __init__(self):
        self._prof = None
        self.t_start = self.t_stop = 0.0

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        # device activity and the runtime calls that launched it; host ops
        # are not recorded, so the trace costs the host little
        return profile(activities=[ProfilerActivity.CUDA])

    def warm(self, fn) -> None:
        """Profile ``fn`` once, at set-up: the first profile pays CUPTI's
        start."""
        with self._profile():
            fn()

    def start(self) -> None:
        self._prof = self._profile()
        self._prof.start()
        self.t_start = time.monotonic()

    def stop(self) -> None:
        self.t_stop = time.monotonic()
        self._prof.stop()

    def summary(self) -> Optional[TraceSummary]:
        """None when the profiler recorded no device activity."""
        from torch.autograd import DeviceType

        events = self._prof.profiler.kineto_results.events()
        dev, host = [], []
        for ev in events:
            if ev.device_type() == DeviceType.CUDA:
                dev.append((ev.start_ns(), ev.end_ns(), ev.name(),
                            ev.correlation_id()))
            else:
                host.append((ev.name(), ev.correlation_id()))
        self._prof = None
        if not dev:
            return None
        dev.sort()
        by_name: Dict[str, float] = defaultdict(float)
        for s, e, name, _ in dev:
            by_name[name] += (e - s) / 1e9
        # union of device activity, and the gaps between
        busy, gaps = 0, []
        cur_s, cur_e = dev[0][0], dev[0][1]
        for s, e, _, corr in dev[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append((s - cur_e, corr))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        # runtime calls (cudaLaunchKernel, cudaGraphLaunch, ...) by their
        # correlation id, which their device work carries too
        launch = {c: name for name, c in host
                  if c and name.startswith("cu")}
        graph_corr = {c for c, name in launch.items()
                      if "GraphLaunch" in name}
        windows: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
        for s, e, _, corr in dev:
            if corr in graph_corr:
                windows[corr].append((s, e))
        # a replay cut by the end of the trace is left out: only replays
        # with as many kernels as the most common count are timed
        counts = [len(v) for v in windows.values()]
        full = max(set(counts), key=counts.count) if counts else 0
        graph_s = [sum(e - s for s, e in v) / 1e9
                   for v in windows.values() if len(v) == full]
        kernel_time = {}
        for face, sub in KERNELS.items():
            ks = [(e - s) for s, e, name, _ in dev if sub in name]
            if ks:
                kernel_time[face] = (sum(ks) / 1e9, len(ks))
        gaps.sort(reverse=True)
        idle = [(launch.get(corr, "work launched before the trace"),
                 g / 1e9)
                for g, corr in gaps[:10]]
        # kernel names are whole C++ signatures: their first 160 letters
        ops = [(name[:160], t) for name, t in
               sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
        return TraceSummary(
            t_start=self.t_start, t_stop=self.t_stop, busy_s=busy / 1e9,
            window_s=self.t_stop - self.t_start, device_ops=ops,
            idle_gaps=idle, graph_windows_s=graph_s, kernel_time=kernel_time)
