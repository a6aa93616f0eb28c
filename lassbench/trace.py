"""What a traced window holds, reduced from ``torch.profiler``'s events.

``Trace.collect(prof)`` keeps every device activity (kernels, copies and
fills: name, start, duration) and, for each of the benchmark's own host
ranges (``record_function`` labels starting ``lassbench::``), its
intervals and the kernels that operations inside it launched. Device and
host times share the profiler's clock (microseconds from the trace's
start). ``window`` is the traced window's host interval, set by the
runner from its own range ``lassbench::window``.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Tuple

from lassbench.yardstick import family

PREFIX = "lassbench::"
WINDOW = PREFIX + "window"


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Trace:
    def __init__(self):
        self.kernels: List[Tuple[str, float, float]] = []
        self.ranges: Dict[str, List[Tuple[float, float]]] = \
            collections.defaultdict(list)
        self.range_kernels: Dict[str, List[Tuple[str, float]]] = \
            collections.defaultdict(list)
        self.window: Optional[Tuple[float, float]] = None

    @classmethod
    def collect(cls, prof) -> "Trace":
        """From a stopped ``torch.profiler.profile``'s raw events: device
        activities (and the host operation each was launched from, by the
        profiler's correlation ids), the benchmark's host ranges."""
        from torch.autograd import DeviceType

        tr = cls()
        events = prof.profiler.kineto_results.events()
        base = min((e.start_ns() for e in events), default=0)
        op_start: Dict[int, float] = {}
        device = []
        for e in events:
            start = (e.start_ns() - base) / 1e3
            if e.device_type() == DeviceType.CUDA:
                # the profiler mirrors each host range on the device's
                # timeline, spanning the gaps between its kernels: no work
                if not e.name().startswith(PREFIX):
                    device.append((e.name(), start, e.duration_ns() / 1e3,
                                   e.linked_correlation_id()))
            elif e.linked_correlation_id() == 0 and not e.is_async():
                name = e.name()
                if name.startswith(PREFIX):
                    tr.ranges[name].append((start,
                                            start + e.duration_ns() / 1e3))
                op_start[e.correlation_id()] = start
        if tr.ranges.get(WINDOW):
            tr.window = tr.ranges[WINDOW][0]
        flat = sorted((a, b, label) for label, spans in tr.ranges.items()
                      if label != WINDOW for a, b in spans)
        starts = [a for a, _, _ in flat]
        for name, start, dur, op in device:
            tr.kernels.append((name, start, dur))
            at = op_start.get(op)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            # the innermost range holding the launching operation: the
            # latest-starting of the few ranges before it that contain it
            for i in range(i, max(i - 4, -1), -1):
                a, b, label = flat[i]
                if a <= at <= b:
                    tr.range_kernels[label].append((name, dur))
                    break
        return tr

    # --- device time ---------------------------------------------------
    def in_window(self) -> List[Tuple[str, float, float]]:
        a, b = self.window
        return [k for k in self.kernels if k[1] < b and k[1] + k[2] > a]

    def busy_s(self) -> float:
        a, b = self.window
        merged = _merge([(max(s, a), min(s + d, b))
                         for _, s, d in self.in_window()])
        return sum(y - x for x, y in merged) / 1e6

    def window_s(self) -> float:
        a, b = self.window
        return (b - a) / 1e6

    def family_s(self, fam: str, label: Optional[str] = None) -> float:
        """Seconds of device work of kernel family ``fam``: in the window,
        or launched inside host range ``label``."""
        if label is None:
            return sum(d for n, _, d in self.in_window()
                       if family(n) == fam) / 1e6
        return sum(d for n, d in self.range_kernels.get(label, ())
                   if family(n) == fam) / 1e6

    def named(self, needle: str) -> List[float]:
        """Durations (s) of the window's kernels whose name holds
        ``needle``."""
        return [d / 1e6 for n, _, d in self.in_window() if needle in n]

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle gaps
        summed by the benchmark range the host was in when each began."""
        by_name: Dict[str, float] = collections.defaultdict(float)
        for n, _, d in self.in_window():
            by_name[n[:160]] += d / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        a, b = self.window
        merged = _merge([(max(s, a), min(s + d, b))
                         for _, s, d in self.in_window()])
        gaps, prev = [], a
        for x, y in merged:
            if x > prev:
                gaps.append((prev, x))
            prev = max(prev, y)
        if b > prev:
            gaps.append((prev, b))
        flat = sorted((s, e, label) for label, spans in self.ranges.items()
                      if label != WINDOW for s, e in spans)
        by_host: Dict[str, float] = collections.defaultdict(float)
        count: Dict[str, int] = collections.defaultdict(int)
        for g0, g1 in gaps:
            where = "outside the benchmark's ranges"
            for s, e, label in flat:  # innermost: the latest start
                if s <= g0 < e:
                    where = label[len(PREFIX):]
            by_host[where] += (g1 - g0) / 1e6
            count[where] += 1
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[f"{w} ({count[w]} gaps)", s]
                              for w, s in idle]}
