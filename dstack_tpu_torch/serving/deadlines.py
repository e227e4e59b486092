"""End-to-end request deadlines — the wire contract every plane shares.

A deadline *budget* is minted at the ingress (gateway or in-server
proxy) and rides every proxy leg as the ``X-Dstack-Deadline`` header.
The wire value is the REMAINING budget in seconds at send time — a
relative duration, not a wall-clock instant, so it survives clock skew
between the gateway host and the replica host (each hop re-stamps the
header with its own remaining view).  Consumers:

- the gateway data plane (``gateway/app.py``) mints the budget
  (client-overridable up to a cap), charges every retry/hedge attempt
  against it, and answers 504 once it is exhausted;
- the PD two-phase forwarder stamps the remaining budget on both legs;
- the serving server (``serving/server.py``) converts it to an absolute
  engine deadline: requests that expire in the queue are refused/evicted
  with 504 *before* burning a prefill, and decode streams whose deadline
  passes are cancelled with their KV blocks freed.

Shared out of ``serving/`` (not ``gateway/``) for the same reason as
``pd_protocol``: the gateway already depends on serving, never the
reverse.
"""

from __future__ import annotations

import time
from typing import Optional

from dstack_tpu_torch.serving.wire import DEADLINE_HEADER

__all__ = ["DEADLINE_HEADER", "parse_remaining", "Deadline"]


def parse_remaining(headers) -> Optional[float]:
    """Remaining budget (seconds) off a request's headers, or None when
    no deadline rides the request.  Malformed values are treated as
    absent rather than failing the request — a bad proxy must not turn
    every call into a 400."""
    raw = headers.get(DEADLINE_HEADER)
    if raw is None:
        return None
    try:
        return max(float(raw), 0.0)
    except (TypeError, ValueError):
        return None


class Deadline:
    """An absolute deadline on the *monotonic* clock.

    ``remaining()`` is what gets stamped on outbound legs and what every
    per-attempt timeout derives from; once it hits zero the request is
    answered 504 instead of being retried/hedged further.
    """

    __slots__ = ("at",)

    def __init__(self, budget_s: float) -> None:
        self.at = time.monotonic() + max(budget_s, 0.0)

    @classmethod
    def mint(cls, headers, default_s: float, max_s: float) -> "Deadline":
        """Ingress mint: the client's own ``X-Dstack-Deadline`` wins when
        present (capped at ``max_s`` so a client cannot pin gateway
        resources forever), else the configured default."""
        budget = parse_remaining(headers)
        if budget is None:
            budget = default_s
        return cls(min(budget, max_s))

    def remaining(self) -> float:
        return self.at - time.monotonic()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def header_value(self) -> str:
        return f"{max(self.remaining(), 0.0):.3f}"

    def stamp(self, headers: dict) -> None:
        """Stamp the remaining budget onto an outbound leg's headers —
        every retry/hedge leg re-stamps, so the downstream replica always
        sees what is actually left, not the original budget."""
        headers[DEADLINE_HEADER] = self.header_value()
