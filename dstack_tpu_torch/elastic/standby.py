"""Pre-warmed standby engines: pay the cold start before the spike.

The autoscaler's reaction lag is provision + image + weights + compile
+ warmup — minutes, against spikes that breach the SLO in seconds.  A
standby pool moves all of that *ahead* of the spike: a small
configurable number of engines per service are built, their kernels'
libraries resolved (elastic/compile_cache.py) and warmed while idle, then
*activation* (the only thing left on the scale-up critical path) is a
state flip — O(milliseconds) in-process, O(seconds) through the gateway.

Lifecycle of one slot::

    warming ──(factory returns, warmup done)──▶ ready ──(activate)──▶ active

A ``warming`` standby is visible but NOT routable: the serving server
reports ``warming`` on ``/load`` / ``X-Dstack-Load-Warming`` and the
gateway's tracker and admission skip it exactly like a draining
replica.  A ``ready`` standby still refuses ``/v1`` traffic until
activated — capacity the autoscaler can claim, not capacity the router
may discover early.

The clock is injectable so tests stay deterministic.  A copy of the JAX
package's ``elastic/standby.py``: the pool holds whatever its factory
builds.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["StandbyPool", "StandbyRecord"]

WARMING = "warming"
READY = "ready"
ACTIVE = "active"

ENV_STANDBY_REPLICAS = "DSTACK_STANDBY_REPLICAS"


@dataclasses.dataclass
class StandbyRecord:
    """One standby slot's lifecycle, timestamps on the injected clock."""

    index: int
    state: str = WARMING
    warm_started: float = 0.0
    warm_done: float = 0.0
    activated: float = 0.0
    engine: Any = None

    @property
    def warmup_s(self) -> float:
        return max(0.0, self.warm_done - self.warm_started)


class StandbyPool:
    """A pool of warmed-but-idle engines, activated in O(ms).

    ``factory()`` builds one fully-warmed engine — it should run the
    model end-to-end once so every kernel's library is resolved (the
    compile cache makes the second and later standbys near-free).
    ``warm()`` runs factories synchronously; ``warm_in_background()``
    hides them on a daemon thread, the pattern the serving server uses so
    warming never blocks ``/load``.
    """

    def __init__(self, factory: Callable[[], Any], size: int = 1,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if size < 0:
            raise ValueError(f"standby pool size must be >= 0, got {size}")
        self._factory = factory
        self.size = size
        self._clock = clock
        self._lock = threading.Lock()
        self._records: List[StandbyRecord] = []
        self._threads: List[threading.Thread] = []

    # -- warming ------------------------------------------------------

    def _warm_one(self, record: StandbyRecord) -> None:
        engine = self._factory()
        with self._lock:
            record.engine = engine
            record.warm_done = self._clock()
            record.state = READY

    def warm(self, n: Optional[int] = None) -> List[StandbyRecord]:
        """Build ``n`` (default: up to pool size) standbys, blocking."""
        records = self._begin(n)
        for record in records:
            self._warm_one(record)
        return records

    def warm_in_background(self, n: Optional[int] = None
                           ) -> List[threading.Thread]:
        """Kick off warming on daemon threads; returns them for joins."""
        records = self._begin(n)
        threads = []
        for record in records:
            t = threading.Thread(target=self._warm_one, args=(record,),
                                 name=f"standby-warm-{record.index}",
                                 daemon=True)
            t.start()
            threads.append(t)
        self._threads.extend(threads)
        return threads

    def _begin(self, n: Optional[int]) -> List[StandbyRecord]:
        with self._lock:
            room = self.size - len(self._records)
            count = room if n is None else min(n, room)
            records = []
            for _ in range(max(0, count)):
                record = StandbyRecord(index=len(self._records),
                                       warm_started=self._clock())
                self._records.append(record)
                records.append(record)
            return records

    # -- activation ---------------------------------------------------

    def activate(self) -> Optional[StandbyRecord]:
        """Claim one READY standby; None when the pool has none.

        The caller owns the returned record's engine; the slot counts
        as ``active`` thereafter.  This is the entire scale-up critical
        path — no provision, no weights, no compile.
        """
        with self._lock:
            for record in self._records:
                if record.state == READY:
                    record.state = ACTIVE
                    record.activated = self._clock()
                    return record
            return None

    # -- introspection ------------------------------------------------

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out = {WARMING: 0, READY: 0, ACTIVE: 0}
            for record in self._records:
                out[record.state] = out.get(record.state, 0) + 1
            return out

    @property
    def ready(self) -> int:
        return self.counts()[READY]

    @property
    def warming(self) -> int:
        return self.counts()[WARMING]

    def snapshot(self) -> Dict[str, Any]:
        counts = self.counts()
        return {
            "standby_size": self.size,
            "standby_warming": counts[WARMING],
            "standby_ready": counts[READY],
            "standby_active": counts[ACTIVE],
        }
