"""Device time under the program's own spans.

The port names its model layers and its optimizer with ``torch.profiler``
ranges (``dstack_tpu_torch/telemetry/spans.py``): ``model.*`` and
``train.optimizer``, on the thread that runs the forward and, for the
backward, on autograd's device thread.  Under remat the recompute's
ranges open inside the backward's, so a kernel belongs to the innermost
of these spans open on the thread that launched it (a name may nest in
itself there, which ``Trace.device_s`` does not follow).  A trace of a
program without the spans gives nothing to read.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, Iterable, List, Optional, Tuple

PROGRAM = ("model.", "train.optimizer")


def _spans_by_thread(trace) -> Dict[object, List[Tuple[float, float, str]]]:
    out: Dict[object, List[Tuple[float, float, str]]] = \
        collections.defaultdict(list)
    for (tid, name), spans in trace.ranges.items():
        if name.startswith(PROGRAM):
            out[tid].extend((a, b, name) for a, b in spans)
    for spans in out.values():
        spans.sort()
    return out


def innermost(spans: List[Tuple[float, float, str]], t: float
              ) -> Optional[str]:
    """The name of the span of ``spans`` (sorted) that holds ``t`` and
    started last, or None."""
    i = bisect.bisect_right(spans, (t, float("inf"), ""))
    while i:
        i -= 1
        a, b, name = spans[i]
        if b >= t:
            return name
    return None


def device_s_by_span(trace) -> Dict[Optional[str], float]:
    """Device seconds of the traced operations by the innermost program
    span open where each was launched (None: under none)."""
    spans = _spans_by_thread(trace)
    out: Dict[Optional[str], float] = collections.Counter()
    for _name, _ts, dur, corr in trace.ops:
        launch = trace.launch.get(corr)
        label = (innermost(spans.get(launch[1], []), launch[0])
                 if launch is not None else None)
        out[label] += dur / 1e6
    return out


def share(run, names: Iterable[str]) -> Optional[float]:
    """Device time of the operations launched under the spans ``names``
    (innermost), as a share of the device's busy time, in %."""
    tr = run.trace
    if tr is None or tr.window is None:
        return None
    by = device_s_by_span(tr)
    under = sum(by.get(n, 0.0) for n in names)
    return 100.0 * under / tr.busy_s if under > 0 else None
