"""Internal wire-contract constants: every ``X-Dstack-*`` header name.

The three planes (gateway <-> serving replicas <-> control-plane server)
talk to each other through a handful of internal HTTP headers.  Their
names are string contracts — a one-character drift between the side that
stamps a header and the side that parses it fails silently (the reader
just sees "absent"), which is exactly how the trace-header client leak
and the draining-header TTL miss shipped.  This module is the single
place those names are spelled; wirelint (DT902,
``analysis/rules/wire_contracts.py``) flags any ``X-Dstack-*`` literal
anywhere else in the tree.

Stdlib-only leaf module: imported by serving/, gateway/, telemetry/ and
the in-server proxy, so it must never import back into any of them.

The headers:

- ``X-Dstack-Deadline`` — remaining request budget in seconds, re-stamped
  on every proxy leg (``serving/deadlines.py``).
- ``X-Dstack-Trace-*`` — replica -> ingress span context
  (``telemetry/tracing.py``); stripped from client responses.
- ``X-Dstack-Load-*`` — the replica's piggybacked load snapshot, the
  gateway's passive routing feed (``telemetry/serving.py``); stripped
  from client responses.
- ``X-DStack-Router-Phase`` — PD two-phase marker (note the historical
  ``DStack`` capitalization: replicas compare it case-insensitively, but
  the wire spelling is frozen — changing it would break rolling upgrades
  mid-fleet) (``serving/pd_protocol.py``).
- ``traceparent`` — the one NON-internal propagation header (W3C trace
  context); listed here because proxy legs forward it while stripping
  the internal ``X-Dstack-Trace-*`` family.
"""

from __future__ import annotations

#: end-to-end deadline budget (seconds remaining), minted at the ingress
DEADLINE_HEADER = "X-Dstack-Deadline"

#: replica span-context response headers; never reach clients
TRACE_HEADER_PREFIX = "X-Dstack-Trace-"
TRACE_ID_HEADER = "X-Dstack-Trace-Id"

#: W3C trace context, forwarded (not internal — kept for completeness)
TRACEPARENT_HEADER = "traceparent"

#: replica load-snapshot response headers; never reach clients
LOAD_HEADER_PREFIX = "X-Dstack-Load-"
LOAD_ACTIVE_HEADER = "X-Dstack-Load-Active"
LOAD_QUEUE_HEADER = "X-Dstack-Load-Queue"
LOAD_KV_HEADER = "X-Dstack-Load-Kv"
LOAD_BACKLOG_HEADER = "X-Dstack-Load-Backlog"
LOAD_CAPACITY_HEADER = "X-Dstack-Load-Capacity"
LOAD_DRAINING_HEADER = "X-Dstack-Load-Draining"
LOAD_WARMING_HEADER = "X-Dstack-Load-Warming"

#: PD two-phase leg marker (prefill | decode); client-sent values are
#: discarded at the ingress so nobody outside the router can set it
PD_PHASE_HEADER = "X-DStack-Router-Phase"

__all__ = [
    "DEADLINE_HEADER",
    "TRACE_HEADER_PREFIX", "TRACE_ID_HEADER", "TRACEPARENT_HEADER",
    "LOAD_HEADER_PREFIX", "LOAD_ACTIVE_HEADER", "LOAD_QUEUE_HEADER",
    "LOAD_KV_HEADER", "LOAD_BACKLOG_HEADER", "LOAD_CAPACITY_HEADER",
    "LOAD_DRAINING_HEADER", "LOAD_WARMING_HEADER",
    "PD_PHASE_HEADER",
]
