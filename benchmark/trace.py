"""The device trace of a ``--trace 1`` run, reduced to what the per-layer
readers and the result's ``breakdown`` need.

``torch.profiler`` (CPU and CUDA activity) runs over a stretch of the
window, ``trace_seconds`` long and centred in it: a whole window of
decode steps holds millions of events, too many to read back within a
run's time. The stretch ends on ``torch.cuda.synchronize()``, so every
operation it launched is in the trace. Busy time is the union of the
device's kernel, copy and set intervals (``busy_union_s``); the idle gaps
between them are named by the innermost host operation under each gap's
middle.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

NAME_CHARS = 120


def busy_union_s(intervals) -> float:
    """Seconds covered by the union of ``(start_s, end_s)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_gaps(intervals) -> List[Tuple[float, float]]:
    """The gaps ``(start_s, end_s)`` between the merged intervals."""
    gaps, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def _times(ev) -> Tuple[float, float]:
    """``(start_s, end_s)`` of a kineto event."""
    if hasattr(ev, "start_ns"):
        s = ev.start_ns() * 1e-9
        return s, s + ev.duration_ns() * 1e-9
    s = ev.start_us() * 1e-6
    return s, s + ev.duration_us() * 1e-6


def summarize(device_events, host_events, window_s: float) -> dict:
    """``device_events``/``host_events``: ``(name, start_s, end_s)``.
    Returns busy and window seconds, device time and launches by name,
    and the ten longest idle gaps named by the host's innermost
    operation."""
    by_name: Dict[str, List[float]] = {}
    spans = []
    for name, s, e in device_events:
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += e - s
        acc[1] += 1
        spans.append((s, e))
    gaps = sorted(idle_gaps(spans), key=lambda g: g[0] - g[1])[:10]
    host = sorted(host_events, key=lambda x: x[1])
    starts = [h[1] for h in host]
    named = []
    for gs, ge in gaps:
        mid = (gs + ge) / 2
        inner = None
        for name, s, e in host[:bisect.bisect_right(starts, mid)]:
            if e >= mid and (inner is None or e - s < inner[2] - inner[1]):
                inner = (name, s, e)
        named.append([("host in " + inner[0] if inner else
                       "host between operations")[:NAME_CHARS], ge - gs])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"busy_s": busy_union_s(spans), "window_s": window_s,
            "kernels": {n: (t, c) for n, (t, c) in by_name.items()},
            "device_ops": [[n[:NAME_CHARS], t] for n, (t, _) in top],
            "idle_gaps": named}


def kernel_time(trace: dict, *needles: str) -> Tuple[float, int]:
    """Device seconds and launches of the operations whose names hold any
    of ``needles``."""
    t, n = 0.0, 0
    for name, (s, c) in trace["kernels"].items():
        if any(x in name for x in needles):
            t += s
            n += c
    return t, n


class Stretch:
    """Profiles ``[start_s, start_s + seconds]`` of the host clock when
    ``enabled``: the driver calls :meth:`tick` after each of its steps and
    :meth:`close` when its window ends. The stretch opens and closes on a
    synchronize, so the ``ticks`` counted while it is open are the steps
    that ran inside it. ``paused_s`` is the host time the profiler's start
    and its reading took, in which the driver's loop stood still."""

    def __init__(self, enabled: bool, start_s: float, seconds: float,
                 clock=time.monotonic):
        self.enabled = enabled
        self.start_s, self.seconds, self.clock = start_s, seconds, clock
        self.prof = None
        self.opened_s = None
        self.ticks = 0          # ticks after the profiler opened
        self.paused_s = 0.0     # host time spent starting and reading it
        self.summary: Optional[dict] = None

    @property
    def active(self) -> bool:
        """Profiling now: the driver's window runs on until it closes."""
        return self.prof is not None

    def tick(self) -> None:
        if not self.enabled or self.summary is not None:
            return
        now = self.clock()
        if self.prof is None and now >= self.start_s:
            self._open()
            return
        if self.prof is not None:
            self.ticks += 1
            if now >= self.opened_s + self.seconds:
                self._close()

    def close(self) -> None:
        if self.prof is not None and self.summary is None:
            self._close()

    def _open(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        t = self.clock()
        self.prof.start()
        self.opened_s = self.clock()
        self.paused_s += self.opened_s - t

    def _close(self) -> None:
        import torch
        from torch.autograd import DeviceType

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t = self.clock()
        window_s = t - self.opened_s
        self.prof.stop()
        dev, host = [], []
        for ev in self.prof.profiler.kineto_results.events():
            s, e = _times(ev)
            if ev.device_type() == DeviceType.CUDA:
                dev.append((ev.name(), s, e))
            else:
                host.append((ev.name(), s, e))
        self.summary = summarize(dev, host, window_s)
        self.prof = None
        self.paused_s += self.clock() - t
