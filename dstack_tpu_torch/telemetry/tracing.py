"""Distributed request tracing: W3C trace context + a lock-free span ring.

The per-request counterpart of ``recorder.py``'s aggregates: when p99 TTFT
moves, the histograms say THAT it moved — spans say WHERE an individual
request lost the time (admission queueing, a cold prefix, KV-block
starvation, a slow PD handoff, a contended replica).

Propagation is W3C ``traceparent`` (``00-<32 hex trace>-<16 hex span>-01``):
the gateway mints one when the client didn't send it, every proxy leg
forwards it with the leg's own span id as the parent, and the serving
server hands the trace id to the engine on the ``Request`` so scheduler
spans land in the same trace.  Replicas answer with an internal
``X-Dstack-Trace-Id`` response header (stripped from client responses on
every proxy leg, exactly like the ``X-Dstack-Load-*`` feed).

Recording follows the recorder's lock-free discipline (DT402: no locks in
this package): completed spans are plain dicts appended to a fixed
``deque`` — appends are GIL-atomic, readers snapshot with ``list()`` (a
single C-level copy, atomic under the GIL) — and the hot path pays one
``is None`` check when tracing is off (``DSTACK_TPU_TRACING=0``).

Retention is tail-based: the decision to KEEP a trace is made at the end,
when its fate is known — errors, 429s, and failovers are always kept, the
slowest-k seen so far are kept, and the rest are down-sampled
deterministically by trace-id hash, so overhead and storage stay bounded
at any request rate while the interesting tail is never lost.
"""

from __future__ import annotations

import heapq
import os
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

# internal span-context response headers (replica -> ingress); stripped
# from client responses on every proxy leg like the load feed — the
# names live in serving/wire.py with the rest of the wire contract
from dstack_tpu_torch.serving.wire import (  # noqa: E402
    TRACE_HEADER_PREFIX,
    TRACE_ID_HEADER,
    TRACEPARENT_HEADER,
)

__all__ = [
    "TRACEPARENT_HEADER", "TRACE_HEADER_PREFIX", "TRACE_ID_HEADER",
    "Span", "RequestTracer", "TailSampler", "make_tracer",
    "new_trace_id", "new_span_id", "parse_traceparent",
    "format_traceparent",
]


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def parse_traceparent(value: Optional[str]) -> Optional[Tuple[str, str]]:
    """``(trace_id, parent_span_id)`` from a W3C traceparent header, or
    None for absent/malformed values (version must be a known 2-hex byte,
    ids the right width, hex, and not all-zero — a malformed header means
    MINT a fresh trace, never propagate garbage)."""
    if not value:
        return None
    parts = value.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(version) != 2 or version == "ff":
        return None
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(version, 16), int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def format_traceparent(trace_id: str, span_id: str) -> str:
    # flags 01: sampled — tail sampling decides retention downstream, so
    # upstream legs always record
    return f"00-{trace_id}-{span_id}-01"


class Span:
    """One in-progress span; closes via ``with`` or an explicit ``end()``
    (dtlint DT403 enforces exactly that discipline) and records itself
    into its tracer's ring on close."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start",
                 "ended", "attrs", "status", "_tracer")

    def __init__(self, tracer: "RequestTracer", name: str, trace_id: str,
                 parent_id: Optional[str] = None,
                 attrs: Optional[dict] = None,
                 start: Optional[float] = None) -> None:
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.start = time.time() if start is None else start
        self.ended: Optional[float] = None
        self.attrs: dict = dict(attrs or {})
        self.status = "ok"

    @property
    def duration(self) -> float:
        return max((self.ended if self.ended is not None else time.time())
                   - self.start, 0.0)

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def end(self, now: Optional[float] = None) -> None:
        """Close and record; idempotent (a ``with`` exit after an explicit
        ``end()`` must not double-record)."""
        if self.ended is not None:
            return
        self.ended = time.time() if now is None else now
        self._tracer._record(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None and self.ended is None:
            self.status = "error"
        self.end()


class TailSampler:
    """Trace-retention policy, decided at trace END when its fate is known.

    - errors (5xx / engine failures), 429s, and failovers: ALWAYS kept —
      the traces an operator actually goes looking for;
    - slowest-k: a running top-k of durations keeps the tail exemplars a
      p99 regression investigation needs (converges after the first k);
    - the rest: deterministic sampling on the trace-id hash (no process
      randomness — every replica of a trace makes the same decision).
    """

    def __init__(self, sample_rate: float = 0.05,
                 slowest_k: int = 16) -> None:
        self.sample_rate = sample_rate
        self.slowest_k = slowest_k
        self._slow: List[float] = []  # min-heap of the retained-slow set

    def decide(self, trace_id: str, duration: float,
               error: bool = False) -> Optional[str]:
        """Retention reason (``"error"``/``"slow"``/``"sampled"``) or None
        to drop."""
        if error:
            return "error"
        if (self.slowest_k > 0
                and (len(self._slow) < self.slowest_k
                     or duration > self._slow[0])):
            heapq.heappush(self._slow, duration)
            if len(self._slow) > self.slowest_k:
                heapq.heappop(self._slow)
            return "slow"
        if self.sample_rate > 0:
            try:
                bucket = int(trace_id[:8], 16) / float(0xFFFFFFFF)
            except ValueError:
                return None
            if bucket < self.sample_rate:
                return "sampled"
        return None


class RequestTracer:
    """Lock-free span ring + tail-retained trace store.

    Writers: the engine scheduler thread (retroactive ``record_span``) and
    the HTTP event loop (``start_span``/``end``) — each append is one
    GIL-atomic ``deque.append``.  Readers (``/traces`` handlers) snapshot
    the ring with ``list()`` before filtering, so concurrent appends never
    raise mid-iteration.  ``finish_trace`` only pays the ring scan when
    the sampler KEEPS the trace (a bounded fraction of requests).
    """

    def __init__(self, ring_size: int = 4096,
                 sampler: Optional[TailSampler] = None,
                 max_retained: int = 256) -> None:
        self._ring: deque = deque(maxlen=ring_size)
        self.sampler = sampler if sampler is not None else TailSampler()
        self.max_retained = max_retained
        #: trace_id -> {"reason", "duration", "status", "spans": [...]}
        self._retained: "OrderedDict[str, dict]" = OrderedDict()
        self.finished_traces = 0

    # -- recording -------------------------------------------------------

    def start_span(self, name: str, trace_id: Optional[str] = None,
                   parent_id: Optional[str] = None,
                   attrs: Optional[dict] = None,
                   start: Optional[float] = None) -> Span:
        """A live span; MUST be closed via ``with`` or ``.end()``
        (dtlint DT403)."""
        return Span(self, name, trace_id or new_trace_id(),
                    parent_id=parent_id, attrs=attrs, start=start)

    def record_span(self, name: str, trace_id: str, start: float,
                    end: float, parent_id: Optional[str] = None,
                    attrs: Optional[dict] = None,
                    status: str = "ok") -> dict:
        """Record an already-finished span retroactively — the engine's
        path: scheduler stamps (submitted/admitted/first-token/finished)
        become spans at request finish with zero live bookkeeping in the
        decode loop.  Returns the span dict (its ``span_id`` parents
        children)."""
        d = {
            "trace_id": trace_id,
            "span_id": new_span_id(),
            "parent_id": parent_id,
            "name": name,
            "start": start,
            "duration": max(end - start, 0.0),
            "status": status,
            "attrs": dict(attrs or {}),
        }
        self._append(d)
        return d

    def _record(self, span: Span) -> None:
        self._append({
            "trace_id": span.trace_id,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "name": span.name,
            "start": span.start,
            "duration": span.duration,
            "status": span.status,
            "attrs": dict(span.attrs),
        })

    def _append(self, d: dict) -> None:
        self._ring.append(d)
        # spans recorded AFTER the retention decision (e.g. the gateway
        # root span ends after finish_trace ran on a replica) still join
        # their retained trace
        entry = self._retained.get(d["trace_id"])
        if entry is not None:
            entry["spans"].append(d)

    def finish_trace(self, trace_id: str, duration: float,
                     error: bool = False) -> Optional[str]:
        """Run the tail sampler on a completed trace; when kept, pin its
        spans out of the ring into the bounded retained store.  Returns
        the retention reason or None."""
        self.finished_traces += 1
        if trace_id in self._retained:
            entry = self._retained[trace_id]
            if error and entry["reason"] != "error":
                entry["reason"] = "error"  # errors outrank sampling
                entry["status"] = "error"
            return entry["reason"]
        reason = self.sampler.decide(trace_id, duration, error=error)
        if reason is None:
            return None
        spans = [s for s in list(self._ring) if s["trace_id"] == trace_id]
        self._retained[trace_id] = {
            "reason": reason,
            "duration": duration,
            "status": "error" if error else "ok",
            "spans": spans,
        }
        while len(self._retained) > self.max_retained:
            self._retained.popitem(last=False)
        return reason

    # -- read side -------------------------------------------------------

    def trace(self, trace_id: str) -> List[dict]:
        """Every known span of one trace (ring + retained, deduped),
        sorted by start time."""
        entry = self._retained.get(trace_id)
        spans = list(entry["spans"]) if entry is not None else []
        seen = {s["span_id"] for s in spans}
        for s in list(self._ring):
            if s["trace_id"] == trace_id and s["span_id"] not in seen:
                seen.add(s["span_id"])
                spans.append(s)
        spans.sort(key=lambda s: (s["start"], s["span_id"]))
        return spans

    def summary(self, limit: int = 50) -> dict:
        """``/traces`` payload: recent traces newest-first plus store
        gauges.  Each entry: trace_id, span count, start, duration_ms,
        status, retained reason (None when only in the ring)."""
        groups: "OrderedDict[str, List[dict]]" = OrderedDict()
        for s in list(self._ring):
            groups.setdefault(s["trace_id"], []).append(s)
        for tid, entry in self._retained.items():
            if tid not in groups and entry["spans"]:
                groups[tid] = list(entry["spans"])
        traces = []
        for tid, spans in groups.items():
            start = min(s["start"] for s in spans)
            end = max(s["start"] + s["duration"] for s in spans)
            entry = self._retained.get(tid)
            traces.append({
                "trace_id": tid,
                "spans": len(spans),
                "start": start,
                "duration_ms": round((end - start) * 1e3, 3),
                "status": ("error" if any(s["status"] == "error"
                                          for s in spans) else "ok"),
                "retained": entry["reason"] if entry is not None else None,
            })
        traces.sort(key=lambda t: t["start"], reverse=True)
        return {
            "traces": traces[:limit],
            "ring_spans": len(self._ring),
            "retained_traces": len(self._retained),
            "finished_traces": self.finished_traces,
        }


def make_tracer(env: Optional[dict] = None,
                **kw) -> Optional[RequestTracer]:
    """Env-gated constructor: ``DSTACK_TPU_TRACING=0`` disables — callers
    then hold ``tracer=None`` and every hot path pays a single ``is
    None`` check, exactly like the metrics recorder's gate."""
    env = env if env is not None else os.environ
    if str(env.get("DSTACK_TPU_TRACING", "1")).lower() in (
            "0", "false", "off", "no"):
        return None
    return RequestTracer(**kw)
