"""Instant elasticity: remove the three legs of a replica's cold start.

A real scale-up pays provision + image pull + cold weight load, then the
nvcc build of every kernel library its path launches, then a warmup.
This package makes each leg skippable, as the JAX package's
``elastic/`` does for its replicas:

``compile_cache``
    Persistent content-addressed cache of the kernels' nvcc libraries,
    keyed by hash(source digest + card, nvcc and driver versions).  A
    scaling-up replica never runs nvcc for a library any peer has already
    built — it fetches the file instead.

``weight_stream``
    Peer-to-peer weight streaming: a new replica pulls the host-shard
    snapshot (the ``models/checkpoint.py`` manifest format, verbatim)
    over HTTP from a live replica, chunked and integrity-checked
    against the manifest's per-shard checksums, rate-limited below
    serving traffic, with a cold fallback.

``standby``
    Pre-warmed standby engines: a small pool of warmed-but-idle engines
    per service that the autoscaler activates in O(seconds) instead of
    provisioning.  While warming, a standby reports ``warming`` on
    ``/load`` so the router never counts it toward routable capacity.
"""

from dstack_tpu_torch.elastic.compile_cache import (
    CachedKernels,
    CompileCache,
    cache_key,
    maybe_cached,
    topology_fingerprint,
)
from dstack_tpu_torch.elastic.standby import StandbyPool, StandbyRecord
from dstack_tpu_torch.elastic.weight_stream import (
    TokenBucket,
    WeightStreamError,
    pull_weights,
    stream_snapshot,
)

__all__ = [
    "CachedKernels",
    "CompileCache",
    "StandbyPool",
    "StandbyRecord",
    "TokenBucket",
    "WeightStreamError",
    "cache_key",
    "maybe_cached",
    "pull_weights",
    "stream_snapshot",
    "topology_fingerprint",
]
