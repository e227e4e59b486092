"""Serving-engine telemetry: the metric set the gateway autoscaler and
SLO dashboards key on.

One ``EngineTelemetry`` instance per ``InferenceEngine``; all record_*
methods are called from the engine's scheduler thread only (the same
thread that runs ``step()``), so nothing here locks.  The HTTP side reads
through ``prometheus_samples()`` / ``stats()`` which only snapshot.

Metric names (all prefixed ``dstack_serving_``; scraped by the
server scraper through the auto-declared ``metrics:`` block and
republished with project/run/job/replica labels):

- ``queue_wait_seconds``    histogram — submit -> slot admission
- ``ttft_seconds``          histogram — submit -> first emitted token
- ``inter_token_seconds``   histogram — decode-window wall time / tokens
- ``e2e_seconds``           histogram — submit -> finish
- ``batch_occupancy{phase}``histogram — fraction of capacity used per
  prefill (real tokens / padded bucket) and per decode window
  (decoding slots / batch_size)
- ``kv_utilization``        gauge — KV blocks (paged) or cache rows
  (dense) in use, fraction of capacity
- ``active_slots`` / ``queue_depth`` gauges
- ``prefill_backlog_tokens`` gauge — prompt tokens still awaiting a
  chunked-prefill dispatch (the signal a router uses to avoid piling
  long prompts onto one replica)
- ``requests_total{outcome}``, ``prefill_tokens_total``,
  ``decode_tokens_total``, ``preemptions_total{reason}``,
  ``spec_steps_total``, ``spec_accepted_total`` counters
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

from dstack_tpu_torch.telemetry.recorder import (
    LATENCY_BUCKETS,
    MetricsRecorder,
    RATIO_BUCKETS,
)

from dstack_tpu_torch.serving.wire import LOAD_HEADER_PREFIX

PREFIX = "dstack_serving_"

#: response-header prefix the serving server uses to piggyback its load
#: snapshot on every proxied response (the gateway's passive load feed —
#: zero extra polling RPS); the name itself lives in serving/wire.py;
#: header suffix -> (snapshot field, parser)
LOAD_HEADER_FIELDS = {
    "Active": ("active_slots", int),
    "Queue": ("queue_depth", int),
    "Kv": ("kv_utilization", float),
    "Backlog": ("prefill_backlog_tokens", int),
    "Capacity": ("capacity_slots", int),
    # 0/1 — a draining replica finishes in-flight streams but admits no
    # new requests; routers must skip it (gateway drain-and-migrate)
    "Draining": ("draining", int),
    # 0/1 — DISTINCT from draining: a still-compiling (or unactivated
    # standby) replica has never served; routers and admission must not
    # count it toward routable capacity, but nothing should tear it
    # down — it is seconds from being capacity (elastic/standby.py)
    "Warming": ("warming", int),
}


def load_headers(snapshot: Dict) -> Dict[str, str]:
    """Render a load snapshot as ``X-Dstack-Load-*`` response headers.
    Integers render via str() — ``format(v, "g")`` would flip 7+ digit
    counts (a deep prefill backlog) into rounded scientific notation."""
    out = {}
    for suffix, (field, _parse) in LOAD_HEADER_FIELDS.items():
        if field in snapshot:
            v = snapshot[field]
            out[LOAD_HEADER_PREFIX + suffix] = (
                str(v) if isinstance(v, int) else format(v, "g"))
    return out


def parse_load_headers(headers) -> Optional[Dict]:
    """Inverse of :func:`load_headers`: pull the load snapshot off a
    response's headers.  Returns None when no load headers are present
    (non-dstack upstreams); individual malformed values are skipped
    rather than poisoning the rest."""
    out: Dict = {}
    for suffix, (field, parse) in LOAD_HEADER_FIELDS.items():
        raw = headers.get(LOAD_HEADER_PREFIX + suffix)
        if raw is None:
            continue
        try:
            out[field] = parse(float(raw))
        except (TypeError, ValueError):
            continue
    return out or None


class EngineTelemetry:
    """Recorder + ring buffer of recent per-request records.

    ``tracer`` (a `dstack_tpu_torch.telemetry.tracing.RequestTracer`) adds
    per-request attribution on top of the aggregates: the engine's
    scheduler stamps (submitted/admitted/first-token/finished, plus the
    KV-stall stamp) become spans at request finish — zero live span
    bookkeeping inside the decode loop — and the latency histograms
    attach the request's trace id as an OpenMetrics exemplar so a p99
    bucket links straight to an example trace.  ``tracer=None`` (the
    default, or ``DSTACK_TPU_TRACING=0``) keeps every added path at one
    ``is None`` check.
    """

    def __init__(self, ring_size: int = 512, tracer=None) -> None:
        self.tracer = tracer
        self.recorder = MetricsRecorder()
        r = self.recorder
        self.queue_wait = r.histogram(PREFIX + "queue_wait_seconds")
        self.ttft = r.histogram(PREFIX + "ttft_seconds")
        self.inter_token = r.histogram(PREFIX + "inter_token_seconds")
        self.e2e = r.histogram(PREFIX + "e2e_seconds")
        self.prefill_occupancy = r.histogram(
            PREFIX + "batch_occupancy", RATIO_BUCKETS,
            labels={"phase": "prefill"})
        self.decode_occupancy = r.histogram(
            PREFIX + "batch_occupancy", RATIO_BUCKETS,
            labels={"phase": "decode"})
        self.kv_utilization = r.gauge(PREFIX + "kv_utilization")
        self.active_slots = r.gauge(PREFIX + "active_slots")
        self.queue_depth = r.gauge(PREFIX + "queue_depth")
        self.prefill_backlog = r.gauge(PREFIX + "prefill_backlog_tokens")
        self.prefill_tokens = r.counter(PREFIX + "prefill_tokens_total")
        self.decode_tokens = r.counter(PREFIX + "decode_tokens_total")
        self.spec_steps = r.counter(PREFIX + "spec_steps_total")
        self.spec_accepted = r.counter(PREFIX + "spec_accepted_total")
        #: recent finished requests: {submitted_at, queue_wait, ttft, e2e,
        #: tokens_out, finish_reason}
        self.ring: deque = deque(maxlen=ring_size)
        self._started_at = time.time()

    # -- engine-thread recording hooks ----------------------------------

    def record_admitted(self, queue_wait: float,
                        trace_id: Optional[str] = None) -> None:
        self.queue_wait.observe(max(queue_wait, 0.0), exemplar=trace_id)

    def record_first_token(self, ttft: float,
                           trace_id: Optional[str] = None) -> None:
        self.ttft.observe(max(ttft, 0.0), exemplar=trace_id)

    def record_finished(self, req) -> None:
        now = req.finished_at or time.time()
        e2e = max(now - req.submitted_at, 0.0)
        outcome = req.finish_reason or "unknown"
        trace_id = getattr(req, "trace_id", None)
        self.e2e.observe(e2e, exemplar=trace_id)
        self.recorder.counter(PREFIX + "requests_total",
                              labels={"outcome": outcome}).inc()
        admitted = getattr(req, "admitted_at", None)
        self.ring.append({
            "submitted_at": req.submitted_at,
            "queue_wait": (max(admitted - req.submitted_at, 0.0)
                           if admitted else None),
            "ttft": (max(req.first_token_at - req.submitted_at, 0.0)
                     if req.first_token_at else None),
            "e2e": e2e,
            "tokens_out": len(req.output),
            "finish_reason": outcome,
            "trace_id": trace_id,
        })
        if self.tracer is not None and trace_id is not None:
            self._record_request_spans(req, trace_id, now, outcome)

    def _record_request_spans(self, req, trace_id: str, now: float,
                              outcome: str) -> None:
        """Engine-side span taxonomy, derived retroactively from the
        request's scheduler stamps (see the class docstring):

        - ``engine.request``     submitted -> finished (replica root)
        - ``engine.queue_wait``  submitted -> slot admission
        - ``engine.kv_wait``     KV-block stall -> admission (paged pool
                                 exhaustion — the starvation signal)
        - ``engine.prefill``     admission -> first token
        - ``engine.decode``      first token -> finished (spec-decode
                                 accept counters as attrs when enabled)
        """
        t = self.tracer
        status = "error" if outcome == "error" else "ok"
        root = t.record_span(
            "engine.request", trace_id,
            start=req.submitted_at, end=now,
            parent_id=getattr(req, "parent_span_id", None),
            status=status,
            attrs={"finish_reason": outcome, "tokens_out": len(req.output)})
        rid = root["span_id"]
        admitted = getattr(req, "admitted_at", None)
        t.record_span("engine.queue_wait", trace_id,
                      start=req.submitted_at,
                      end=admitted if admitted is not None else now,
                      parent_id=rid)
        stalled = getattr(req, "_kv_stalled_at", None)
        if stalled is not None:
            t.record_span("engine.kv_wait", trace_id, start=stalled,
                          end=admitted if admitted is not None else now,
                          parent_id=rid,
                          attrs={"reason": "kv_blocks_exhausted"})
        first = getattr(req, "first_token_at", None)
        if admitted is not None and first is not None:
            t.record_span("engine.prefill", trace_id, start=admitted,
                          end=first, parent_id=rid,
                          attrs={"prompt_tokens":
                                 len(getattr(req, "tokens", None) or ())})
        if first is not None:
            attrs = {"tokens_out": len(req.output),
                     "finish_reason": outcome}
            spec0 = getattr(req, "_spec0", None)
            if spec0 is not None:
                # engine-wide window deltas over this request's lifetime
                # (speculation verifies whole windows, not single slots)
                attrs["spec_steps"] = int(self.spec_steps.value - spec0[0])
                attrs["spec_accepted"] = int(
                    self.spec_accepted.value - spec0[1])
            t.record_span("engine.decode", trace_id, start=first, end=now,
                          parent_id=rid, attrs=attrs)

    def record_prefill(self, n_tokens: int, bucket: int) -> None:
        self.prefill_tokens.inc(n_tokens)
        if bucket > 0:
            self.prefill_occupancy.observe(min(n_tokens / bucket, 1.0))

    def record_window(self, decoding: int, batch_size: int) -> None:
        self.active_slots.set(decoding)
        if batch_size > 0:
            self.decode_occupancy.observe(min(decoding / batch_size, 1.0))

    def record_drain(self, tokens_emitted: int, wall: float,
                     decoding: int = 1) -> None:
        """``wall`` is the dispatch->drain time of one decode window that
        emitted ``tokens_emitted`` tokens across ``decoding`` slots.  The
        PER-REQUEST token gap is wall / (tokens per request) — dividing by
        the total emitted would shrink the metric with batch occupancy
        and understate what any single stream experiences."""
        if tokens_emitted <= 0:
            return
        self.decode_tokens.inc(tokens_emitted)
        self.inter_token.observe(
            max(wall, 0.0) * max(decoding, 1) / tokens_emitted)

    def record_kv_utilization(self, fraction: float) -> None:
        self.kv_utilization.set(min(max(fraction, 0.0), 1.0))

    def record_queue_depth(self, depth: int) -> None:
        self.queue_depth.set(depth)

    def record_prefill_backlog(self, tokens: int) -> None:
        """Prompt tokens still awaiting a chunked-prefill dispatch across
        all mid-chunking slots (0 when chunking is off or drained)."""
        self.prefill_backlog.set(max(tokens, 0))

    def record_preemption(self, reason: str) -> None:
        self.recorder.counter(PREFIX + "preemptions_total",
                              labels={"reason": reason}).inc()

    def record_spec(self, steps: int, accepted: int) -> None:
        self.spec_steps.inc(steps)
        self.spec_accepted.inc(accepted)

    # -- read side -------------------------------------------------------

    def load_snapshot(self) -> Dict:
        """O(1) load view for ``/load`` and the ``X-Dstack-Load-*``
        headers: four gauge reads, no iteration, no locks.  The gauges are
        refreshed by the engine at submit/dispatch cadence, which is
        exactly the freshness a router can use."""
        return {
            "active_slots": int(self.active_slots.value),
            "queue_depth": int(self.queue_depth.value),
            "kv_utilization": round(self.kv_utilization.value, 4),
            "prefill_backlog_tokens": int(self.prefill_backlog.value),
        }

    def prometheus_samples(self) -> List:
        return self.recorder.samples()

    def stats(self) -> Dict:
        """JSON for ``/stats``: recorder summary + ring-derived recency.

        The histogram snapshots inside are the gateway's aggregation
        input (mergeable across replicas); ``percentiles`` are this
        replica's own p50/p95/p99.
        """
        out = self.recorder.summary()
        recent = list(self.ring)
        out["recent_requests"] = len(recent)
        out["uptime_seconds"] = max(time.time() - self._started_at, 0.0)
        if recent:
            window = [r for r in recent
                      if r["submitted_at"] > time.time() - 300]
            out["recent_finished_5m"] = len(window)
            out["recent_tokens_out_5m"] = sum(
                r["tokens_out"] for r in window)
        return out


def make_engine_telemetry(env: Optional[dict] = None,
                          ) -> Optional[EngineTelemetry]:
    """Env-gated constructor: ``DSTACK_TPU_SERVING_TELEMETRY=0`` disables
    (the engine then carries ``telemetry=None`` and the hot path pays a
    single ``is None`` check).  Request tracing rides the same instance
    and is separately gated by ``DSTACK_TPU_TRACING`` (tracing.py)."""
    import os

    env = env if env is not None else os.environ
    if str(env.get("DSTACK_TPU_SERVING_TELEMETRY", "1")).lower() in (
            "0", "false", "off", "no"):
        return None
    from dstack_tpu_torch.telemetry.tracing import make_tracer

    return EngineTelemetry(tracer=make_tracer(env))


__all__ = ["EngineTelemetry", "make_engine_telemetry", "PREFIX",
           "LATENCY_BUCKETS", "RATIO_BUCKETS",
           "LOAD_HEADER_PREFIX", "LOAD_HEADER_FIELDS",
           "load_headers", "parse_load_headers"]
