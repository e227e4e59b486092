"""The traced window: ``torch.profiler`` on the thread that drives the
card, and the reduction of its trace to device time.

A kernel is attributed to a range when the host call that launched it
(its ``cuda_runtime`` or ``cuda_driver`` event, by correlation id) lies
inside that range on the same thread.  The device is busy where any
kernel, copy or memset runs; the window is the ``portbench.traced`` range
that spans the whole traced stretch.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

WINDOW = "portbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Profiler:
    """Started and stopped from the thread that launches the work, each
    time after the device has finished what was queued before."""

    def __init__(self):
        self.prof = None
        self._range = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._range = record_function(WINDOW)
        self._range.__enter__()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def trace(self) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        return Trace(events.get("traceEvents", events)
                     if isinstance(events, dict) else events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Trace:
    """Device operations, their launches and the host's ranges (times in
    microseconds, as the trace has them)."""

    def __init__(self, events: List[dict]):
        self.ops: List[Tuple[str, float, float, Optional[int]]] = []
        launches: Dict[int, Tuple[float, object]] = {}
        #: (thread, range name) -> its spans (start, end), sorted
        self.ranges: Dict[Tuple[object, str], List[Tuple[float, float]]] = \
            collections.defaultdict(list)
        self.window: Optional[Tuple[float, float]] = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.ops.append((e["name"], ts, dur, corr))
            elif cat in LAUNCH_CATS and corr is not None:
                launches[corr] = (ts, e.get("tid"))
            elif cat == "user_annotation":
                if e["name"] == WINDOW:
                    self.window = (ts, ts + dur)
                self.ranges[(e.get("tid"), e["name"])].append((ts, ts + dur))
        for spans in self.ranges.values():
            spans.sort()
        self.launch = launches
        if self.window is not None:
            a, b = self.window
            self.ops = [op for op in self.ops
                        if op[1] + op[2] > a and op[1] < b]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        a, b = self.window
        return _union([(max(ts, a), min(ts + dur, b))
                       for _, ts, dur, _ in self.ops])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def _span_at(self, tid, label: str, t: float
                 ) -> Optional[Tuple[float, float]]:
        """The span of range ``label`` open on thread ``tid`` at time
        ``t``, or None (one range name does not nest in itself on a
        thread, so the last span that starts at or before ``t`` is the
        only candidate)."""
        spans = self.ranges.get((tid, label), ())
        i = bisect.bisect_right(spans, (t, float("inf")))
        if i and spans[i - 1][1] >= t:
            return spans[i - 1]
        return None

    def device_s(self, label: Optional[str] = None,
                 names: Tuple[str, ...] = ()) -> float:
        """Device seconds of the operations launched inside a range
        ``label`` (every one when None) whose names hold one of
        ``names`` (any name when empty)."""
        total = 0.0
        for name, _ts, dur, corr in self.ops:
            if names and not any(n in name for n in names):
                continue
            if label is not None:
                launch = self.launch.get(corr)
                if launch is None or self._span_at(launch[1], label,
                                                   launch[0]) is None:
                    continue
            total += dur
        return total / 1e6

    def breakdown(self, prefixes=("portbench.", "train.")
                  ) -> Dict[str, list]:
        """The ten device operations that took most time (summed by name),
        and the device's idle time summed by the innermost range of the
        benchmark or the program open on the host at each gap's middle."""
        by_op: Dict[str, float] = collections.Counter()
        for name, _ts, dur, _ in self.ops:
            by_op[name] += dur / 1e6
        busy = self.busy_intervals()
        a, b = self.window
        gaps, t = [], a
        for x, y in busy:
            if x > t:
                gaps.append((t, x))
            t = max(t, y)
        if b > t:
            gaps.append((t, b))
        labels = [key for key in self.ranges
                  if key[1] != WINDOW and key[1].startswith(prefixes)]
        by_gap: Dict[str, float] = collections.Counter()
        for x, y in gaps:
            mid, label, width = (x + y) / 2, "outside any range", None
            for tid, name in labels:
                span = self._span_at(tid, name, mid)
                if span is not None and (width is None
                                         or span[1] - span[0] < width):
                    label, width = name, span[1] - span[0]
            by_gap[label] += (y - x) / 1e6
        return {"device_ops": [[n, s] for n, s in by_op.most_common(10)],
                "idle_gaps": [[n, s] for n, s in by_gap.most_common(10)]}
