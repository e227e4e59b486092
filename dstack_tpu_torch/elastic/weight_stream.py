"""Peer-to-peer weight streaming: pull a snapshot from a live replica.

The weights leg of a scale-up cold start is a cold read of the full
model — minutes for an 8B checkpoint on a fresh host, while N live
replicas hold the identical bytes one rack away.  This module lets a
joining replica pull the published host-shard snapshot (the
``models/checkpoint.py`` manifest format, verbatim) over HTTP from a
peer that already has it:

- **chunked**: shard files stream in fixed-size chunks, never
  materialized twice in memory;
- **integrity-checked**: every shard's sha256 is verified against the
  manifest's ``checksums`` map, and the shard-file count against
  ``num_processes`` — a mismatching shard is refused, never written;
- **rate-limited below serving traffic**: a token bucket paces the
  transfer (the seeder side caps too, see serving/server.py) so seeding
  a new replica cannot starve the seeder's own request path;
- **cold fallback**: any peer failure falls through to the next peer,
  then to the caller's cold-source callable.

The seeder side is two HTTP routes on the serving server
(``GET /elastic/weights/manifest``, ``GET /elastic/weights/<file>``).
The wire format of a shard is the snapshot file itself, the JAX
package's byte for byte: a snapshot either package publishes streams
into the other, and this module is a copy of the JAX package's
``elastic/weight_stream.py`` over the port's checkpoint helpers.

Env knobs: ``DSTACK_SEED_RATE_BPS`` (seeder-side pacing, 0 = unlimited),
``DSTACK_WEIGHT_PEERS`` (comma-separated peer base URLs for the puller).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence

from dstack_tpu_torch.models.checkpoint import (
    LATEST_NAME,
    MANIFEST_NAME,
    publish_dir_atomic,
    write_file_atomic,
)

logger = logging.getLogger(__name__)

__all__ = [
    "TokenBucket",
    "WeightStreamError",
    "pull_weights",
    "stream_snapshot",
]

ENV_SEED_RATE_BPS = "DSTACK_SEED_RATE_BPS"
ENV_WEIGHT_PEERS = "DSTACK_WEIGHT_PEERS"

#: transfer chunk size — large enough to amortize syscalls, small enough
#: that the rate limiter's pauses stay sub-second at sane rates
CHUNK_BYTES = 1 << 20

_FETCH_TIMEOUT_S = 30.0


class WeightStreamError(Exception):
    """A peer transfer that must not be trusted: checksum mismatch,
    shard-count mismatch, malformed manifest, or transport failure."""


class TokenBucket:
    """Byte-rate pacing with an injectable clock and sleep (deterministic
    in tests).

    ``rate_bps <= 0`` disables pacing entirely.
    """

    def __init__(self, rate_bps: float, capacity: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        self.rate = float(rate_bps)
        self.capacity = float(capacity if capacity is not None
                              else max(self.rate, 1.0))
        self._clock = clock
        self._sleep = sleep
        self._tokens = self.capacity
        self._last = clock()

    def consume(self, n: int) -> float:
        """Block until ``n`` bytes may pass; returns seconds slept."""
        if self.rate <= 0:
            return 0.0
        slept = 0.0
        while True:
            now = self._clock()
            self._tokens = min(self.capacity,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return slept
            wait = (n - self._tokens) / self.rate
            self._sleep(wait)
            slept += wait


def _default_fetch(url: str, timeout: float = _FETCH_TIMEOUT_S
                   ) -> Iterator[bytes]:
    """Stream a URL's body in CHUNK_BYTES pieces (stdlib only)."""
    import urllib.request

    resp = urllib.request.urlopen(url, timeout=timeout)  # noqa: S310
    try:
        while True:
            block = resp.read(CHUNK_BYTES)
            if not block:
                return
            yield block
    finally:
        resp.close()


def _expected_host_files(num_processes: int) -> list[str]:
    return [f"host_{i:05d}.npz" for i in range(num_processes)]


def _validate_manifest(manifest: dict, peer: str
                       ) -> tuple[int, Dict[str, str]]:
    """(step, checksums) after structural validation, or raise."""
    if manifest.get("format") != 1:
        raise WeightStreamError(
            f"peer {peer} serves manifest format "
            f"{manifest.get('format')!r}, expected 1")
    try:
        step = int(manifest["step"])
        num_processes = int(manifest["num_processes"])
    except (KeyError, TypeError, ValueError) as e:
        raise WeightStreamError(
            f"peer {peer} manifest is missing step/num_processes: {e}")
    checksums = manifest.get("checksums") or {}
    expected = _expected_host_files(num_processes)
    if checksums and sorted(checksums) != expected:
        # the seeder's own snapshot is torn relative to its manifest —
        # a shard we cannot name a checksum for must not be trusted
        raise WeightStreamError(
            f"peer {peer} manifest records {len(checksums)} checksummed "
            f"shard(s) but num_processes={num_processes} — host-file "
            "count mismatch, refusing the seed")
    return step, checksums


def stream_snapshot(
    peer: str,
    dest: str | Path,
    *,
    fetch: Optional[Callable[[str], Iterable[bytes]]] = None,
    rate_bps: float = 0.0,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
) -> int:
    """Pull one peer's published snapshot into ``dest``; returns the step.

    The transfer stages into ``<dest>/step_NNNNNNNN.stream-<pid>`` and
    publishes with the checkpoint module's atomic rename, so a reader of
    ``dest`` never sees a half-streamed snapshot — the same torn-write
    contract local checkpoints already honor.  Every shard is
    sha256-verified against the manifest before publish; a mismatch
    raises :class:`WeightStreamError` and leaves ``dest`` untouched.
    """
    peer = peer.rstrip("/")
    dest = Path(dest)
    fetch = fetch or _default_fetch
    try:
        manifest_bytes = b"".join(fetch(f"{peer}/elastic/weights/manifest"))
        manifest = json.loads(manifest_bytes.decode("utf-8"))
    except WeightStreamError:
        raise
    except Exception as e:
        raise WeightStreamError(f"peer {peer} manifest fetch failed: {e}")
    step, checksums = _validate_manifest(manifest, peer)
    names = _expected_host_files(int(manifest["num_processes"]))

    bucket = TokenBucket(rate_bps, clock=clock, sleep=sleep)
    staging = dest / f"step_{step:08d}.stream-{os.getpid()}"
    if staging.exists():
        shutil.rmtree(staging)
    staging.mkdir(parents=True)
    try:
        for name in names:
            h = hashlib.sha256()
            tmp = staging / (name + ".part")
            try:
                with open(tmp, "wb") as f:
                    for block in fetch(f"{peer}/elastic/weights/{name}"):
                        bucket.consume(len(block))
                        h.update(block)
                        f.write(block)
                    f.flush()
                    os.fsync(f.fileno())
            except WeightStreamError:
                raise
            except Exception as e:
                raise WeightStreamError(
                    f"peer {peer} shard {name} transfer failed: {e}")
            want = checksums.get(name)
            if want is not None and h.hexdigest() != want:
                raise WeightStreamError(
                    f"peer {peer} shard {name} sha256 "
                    f"{h.hexdigest()[:12]}… does not match the manifest's "
                    f"{want[:12]}… — refusing the corrupt shard")
            os.replace(tmp, staging / name)
        write_file_atomic(staging / MANIFEST_NAME, manifest_bytes)
        publish_dir_atomic(staging, dest / f"step_{step:08d}")
        write_file_atomic(dest / LATEST_NAME, str(step).encode())
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)
        raise
    return step


def pull_weights(
    peers: Sequence[str],
    dest: str | Path,
    *,
    cold_fallback: Optional[Callable[[], int]] = None,
    fetch: Optional[Callable[[str], Iterable[bytes]]] = None,
    rate_bps: float = 0.0,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
) -> dict:
    """Try each seeding peer in order, then the cold source.

    Returns ``{"source": "peer"|"cold", "peer": url|None, "step": int,
    "errors": [...]}`` — the ``source`` field is what proves a warm start
    did zero cold-source reads.  Raises :class:`WeightStreamError` only
    when every peer fails AND no ``cold_fallback`` was given.
    """
    errors: list[str] = []
    for peer in peers:
        try:
            step = stream_snapshot(peer, dest, fetch=fetch,
                                   rate_bps=rate_bps, clock=clock,
                                   sleep=sleep)
            return {"source": "peer", "peer": peer, "step": step,
                    "errors": errors}
        except WeightStreamError as e:
            logger.warning("weight stream from %s failed: %s", peer, e)
            errors.append(f"{peer}: {e}")
    if cold_fallback is None:
        raise WeightStreamError(
            "every seeding peer failed and no cold fallback was given: "
            + "; ".join(errors))
    step = cold_fallback()
    return {"source": "cold", "peer": None, "step": int(step),
            "errors": errors}
