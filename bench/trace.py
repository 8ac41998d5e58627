"""The device trace of a ``--trace 1`` window: ``torch.profiler`` over the
card's activity alone (kernels, copies, sets), read once the window has
closed.

The profiler's timestamps are put on the host's ``perf_counter`` clock by
a marker: after the profiler starts, the host reads its clock and at once
launches a short ``torch.cuda._sleep`` kernel, twice (the second launch
finds everything warm); the second kernel's start minus that reading is
the offset, good to the launch latency (some microseconds). The busy
time is the union of the device's intervals inside the window, so
overlapping kernels are not counted twice.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

NAME_CHARS = 160        # kernel names in the breakdown are cut to this


@dataclasses.dataclass
class DeviceTrace:
    """The window's device activity: events (name, start, end) in seconds
    from the window's opening, clipped to it; the busy seconds (union of
    the intervals), the window's seconds, and the idle seconds by what the
    host was doing (``idle``: label -> seconds)."""
    events: List[Tuple[str, float, float]]
    busy_s: float
    window_s: float
    idle: Dict[str, float]

    def seconds_of(self, match: Callable[[str], bool]) -> float:
        """Device seconds of the events whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.events if match(n))

    def ops(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for n, s, e in self.events:
            out[n] += e - s
        return dict(out)

    def breakdown(self) -> dict:
        """The 10 device operations that took most time and the idle
        seconds by host activity, as ``[name, seconds]`` lists."""
        ops = sorted(self.ops().items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(self.idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def idle_by_label(busy: List[Tuple[float, float]], w0: float, w1: float,
                  spans: List[Tuple[str, float, float]]) -> Dict[str, float]:
    """Idle seconds in [w0, w1] (outside every busy interval), split over
    the host ``spans`` (label, start, end) that cover them; the rest is
    ``"between host spans"``."""
    idle, t = [], w0
    for s, e in busy:
        if s > t:
            idle.append((t, min(s, w1)))
        t = max(t, e)
        if t >= w1:
            break
    if t < w1:
        idle.append((t, w1))
    out: Dict[str, float] = defaultdict(float)
    spans = sorted(spans, key=lambda x: x[1])
    j = 0
    for s, e in idle:
        covered = 0.0
        while j < len(spans) and spans[j][2] <= s:
            j += 1
        k = j
        while k < len(spans) and spans[k][1] < e:
            lab, a, b = spans[k]
            ov = min(b, e) - max(a, s)
            if ov > 0:
                out[lab] += ov
                covered += ov
            k += 1
        out["between host spans"] += (e - s) - covered
    return dict(out)


class Tracer:
    def __init__(self):
        self.prof = None
        self._marks = []

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        marks = []
        for _ in range(2):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self._marks = marks

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.prof.stop()

    def result(self, t_open: float, t_close: float,
               spans: List[Tuple[str, float, float]]) -> DeviceTrace:
        """The window [t_open, t_close] (host clock) of the trace; ``spans``
        the host's (label, start, end) in seconds from ``t_open``."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        raw = [(e.name(), e.start_ns(), e.end_ns())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
        sleeps = sorted(s for n, s, _ in raw if "spin_kernel" in n)
        if len(sleeps) < 2:
            raise RuntimeError("the trace holds no marker kernel: no device "
                               "activity was recorded")
        # device ns -> seconds from t_open, exact in integers first
        ref, base = sleeps[1], self._marks[1] - t_open
        w1 = t_close - t_open
        events = []
        for n, s, e in raw:
            s = (s - ref) / 1e9 + base
            e = (e - ref) / 1e9 + base
            if e <= 0.0 or s >= w1 or "spin_kernel" in n:
                continue
            events.append((n, max(s, 0.0), min(e, w1)))
        busy = union([(s, e) for _, s, e in events])
        return DeviceTrace(events, sum(e - s for s, e in busy), w1,
                           idle_by_label(busy, 0.0, w1, spans))
