"""In-process metric primitives: fixed-bucket histograms, counters, gauges.

One writer (the engine/train loop thread), any number of readers (the HTTP
handler thread).  Observations are a bisect + three int/float updates —
no locks, no allocation; Python's GIL makes each individual update atomic
and readers only ever see a histogram that is at most one observation
behind, which is exactly the consistency a Prometheus scrape gets anyway.

Snapshots are plain dicts (``{"buckets": [[le, cumulative], ...], "sum",
"count"}``) so they serialize straight into ``/stats`` JSON and merge
across replicas by adding per-bucket counts — the gateway computes
per-service percentiles from the merged histogram rather than averaging
per-replica percentiles (which is statistically meaningless).
"""

from __future__ import annotations

import math
import time
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from dstack_tpu_torch.telemetry.exposition import Sample

#: default latency buckets (seconds): 1 ms .. 60 s, roughly log-spaced.
#: Wide enough for queue waits under load, fine enough near the bottom for
#: inter-token latencies on a warm engine.
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

#: occupancy/utilization buckets (fractions of capacity)
RATIO_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


class Histogram:
    """Cumulative fixed-bucket histogram (Prometheus ``le`` semantics).

    ``observe(value, exemplar=trace_id)`` additionally remembers the last
    trace id that landed in each bucket — the OpenMetrics *exemplar* that
    lets a p99 bucket link straight to an example trace.  One extra list
    write per traced observation, nothing when no exemplar is passed.
    """

    __slots__ = ("name", "labels", "thresholds", "counts", "sum", "count",
                 "exemplars")

    def __init__(self, name: str, thresholds: Sequence[float],
                 labels: Optional[Dict[str, str]] = None) -> None:
        self.name = name
        self.labels = dict(labels or {})
        self.thresholds = tuple(sorted(thresholds))
        # one slot per finite threshold + the +Inf overflow slot
        self.counts = [0] * (len(self.thresholds) + 1)
        #: per-bucket last (trace_id, value, unix_ts) — same slot layout
        self.exemplars: List[Optional[tuple]] = [None] * len(self.counts)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float,
                exemplar: Optional[str] = None) -> None:
        idx = bisect_left(self.thresholds, value)
        self.counts[idx] += 1
        self.sum += value
        self.count += 1
        if exemplar is not None:
            self.exemplars[idx] = (exemplar, value, time.time())

    def snapshot(self) -> dict:
        """JSON-ready cumulative view: ``[[le, cum], ..., ["+Inf", total]]``."""
        cum = 0
        buckets: List[List] = []
        for le, n in zip(self.thresholds, self.counts):
            cum += n
            buckets.append([le, cum])
        buckets.append(["+Inf", cum + self.counts[-1]])
        return {"buckets": buckets, "sum": self.sum, "count": self.count}

    def samples(self) -> List[Sample]:
        snap = self.snapshot()
        out = []
        for i, (le, cum) in enumerate(snap["buckets"]):
            labels = dict(self.labels)
            labels["le"] = "+Inf" if le == "+Inf" else format(float(le), "g")
            ex = self.exemplars[i]
            out.append(Sample(
                name=self.name + "_bucket", labels=labels,
                value=float(cum), type="histogram",
                exemplar=(None if ex is None else
                          {"labels": {"trace_id": ex[0]},
                           "value": ex[1], "timestamp": ex[2]})))
        out.append(Sample(name=self.name + "_sum", labels=dict(self.labels),
                          value=snap["sum"], type="histogram"))
        out.append(Sample(name=self.name + "_count", labels=dict(self.labels),
                          value=float(snap["count"]), type="histogram"))
        return out


class Counter:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str,
                 labels: Optional[Dict[str, str]] = None) -> None:
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def samples(self) -> List[Sample]:
        return [Sample(name=self.name, labels=dict(self.labels),
                       value=self.value, type="counter")]


class Gauge:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str,
                 labels: Optional[Dict[str, str]] = None) -> None:
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def samples(self) -> List[Sample]:
        return [Sample(name=self.name, labels=dict(self.labels),
                       value=self.value, type="gauge")]


class MetricsRecorder:
    """Registry of metrics; renders exposition samples and JSON summaries.

    ``histogram``/``counter``/``gauge`` are get-or-create (keyed on name +
    sorted labels), so call sites can fetch lazily without registration
    boilerplate, and a dynamic label value (e.g. ``outcome="stop"``) makes
    its series on first use.
    """

    def __init__(self) -> None:
        self._metrics: Dict[Tuple, object] = {}
        self._order: List[Tuple] = []

    def _get(self, cls, name: str, labels: Optional[Dict[str, str]],
             *args):
        key = (cls.__name__, name, tuple(sorted((labels or {}).items())))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, *args, labels=labels) if args else cls(
                name, labels=labels)
            self._metrics[key] = m
            self._order.append(key)
        return m

    def histogram(self, name: str,
                  thresholds: Sequence[float] = LATENCY_BUCKETS,
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._get(Histogram, name, labels, thresholds)

    def counter(self, name: str,
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str,
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def samples(self) -> List[Sample]:
        out: List[Sample] = []
        for key in self._order:
            out.extend(self._metrics[key].samples())
        return out

    def summary(self) -> dict:
        """JSON summary: histogram snapshots + derived p50/p95/p99,
        counters and gauges flattened (labels folded into the key)."""
        histograms: Dict[str, dict] = {}
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        for key in self._order:
            m = self._metrics[key]
            label_sfx = "".join(
                f"{{{k}={v}}}" for k, v in sorted(m.labels.items()))
            if isinstance(m, Histogram):
                histograms[m.name + label_sfx] = m.snapshot()
            elif isinstance(m, Counter):
                counters[m.name + label_sfx] = m.value
            else:
                gauges[m.name + label_sfx] = m.value
        percentiles = {
            name: percentiles_from_snapshot(snap)
            for name, snap in histograms.items() if snap["count"]
        }
        return {"histograms": histograms, "percentiles": percentiles,
                "counters": counters, "gauges": gauges}


# -- percentile math / cross-replica merging --------------------------------


def _quantile_from_buckets(buckets: List[List], total: int,
                           q: float) -> float:
    """Quantile estimate from a cumulative bucket list, Prometheus
    ``histogram_quantile`` style: linear interpolation inside the bucket
    the target rank falls into (lower bound 0 for the first bucket; the
    +Inf bucket degrades to its lower finite edge)."""
    rank = q * total
    prev_le, prev_cum = 0.0, 0
    for le, cum in buckets:
        if cum >= rank:
            if le == "+Inf":
                return float(prev_le)
            le_f = float(le)
            if cum == prev_cum:
                return le_f
            return prev_le + (le_f - prev_le) * (rank - prev_cum) / (
                cum - prev_cum)
        if le != "+Inf":
            prev_le, prev_cum = float(le), cum
    return float(prev_le)


def percentiles_from_snapshot(snap: dict,
                              qs: Iterable[float] = (0.5, 0.95, 0.99),
                              ) -> Dict[str, float]:
    """``{"p50": ..., "p95": ..., "p99": ...}`` from one histogram
    snapshot.  Returns zeros for an empty histogram."""
    total = snap.get("count", 0)
    out = {}
    for q in qs:
        label = f"p{q * 100:g}".replace(".", "_")
        out[label] = (
            _quantile_from_buckets(snap["buckets"], total, q) if total
            else 0.0)
    return out


def merge_histogram_snapshots(snaps: List[dict]) -> Optional[dict]:
    """Merge same-bucket snapshots from several replicas by summing the
    per-bucket cumulative counts.  Snapshots whose bucket edges differ
    from the first one's are skipped (mixed engine versions mid-rolling-
    deploy must not corrupt the merged percentiles).  Returns None when
    nothing merges."""
    merged: Optional[dict] = None
    edges: Optional[List] = None
    for snap in snaps:
        try:
            snap_edges = [le for le, _ in snap["buckets"]]
            counts = [cum for _, cum in snap["buckets"]]
            s, c = float(snap.get("sum", 0.0)), int(snap.get("count", 0))
        except (KeyError, TypeError, ValueError):
            continue
        if merged is None:
            merged = {"buckets": [[le, cum] for le, cum
                                  in zip(snap_edges, counts)],
                      "sum": s, "count": c}
            edges = snap_edges
            continue
        if snap_edges != edges:
            continue
        for b, cum in zip(merged["buckets"], counts):
            b[1] += cum
        merged["sum"] += s
        merged["count"] += c
    if merged is not None and not math.isfinite(merged["sum"]):
        merged["sum"] = 0.0
    return merged
