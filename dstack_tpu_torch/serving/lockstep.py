"""Lockstep between the ranks of a sharded serving engine.

The JAX engine serves a mesh from one controller that drives every
device.  The port runs one process per card, so it needs a stand-in for
that controller: rank 0 owns the scheduler, the HTTP server, the
allocator and prefix cache, requests, deadlines, cancels, drain, the
watchdog and telemetry, and every other rank runs :meth:`Follower.run`,
a loop that executes the same device operations on its own shards.

Before rank 0's engine runs a device operation it broadcasts the
operation's name and host arguments (:meth:`Leader.send`: slot ids,
tokens, lengths, block tables, sampling parameters); a follower receives
them and calls the same method of its engine (``_do_<name>``).  Every
decision that depends on time or on the host's queues is taken on rank 0
and reaches the followers as data, so every rank queues the same
launches and collectives in the same order.  Rank 0 may send from two
threads: the scheduler's, and an HTTP handler's for a prefill leg
(``export``); the engine sends and runs each operation under one lock.
A decode leg's K/V travel whole in its ``install`` operation, and each
rank keeps its heads of them.

Sampled tokens come out alike on every rank: after the collectives the
logits are the same bytes everywhere, and the noise generators are
seeded and advanced alike.  That is checked, not assumed: rank 0 sends
the tokens it produced with its next operation, and each follower
compares them with its own, in order, raising :class:`LockstepError` on a
difference.

The channel is a gloo group over all ranks: its tensors live on the host,
so a broadcast never waits on a card.  An operation travels as two
broadcasts, its length and then its bytes (:func:`encode`, a pickle:
the group joins only the ranks of one job, which read only what rank 0
of the same program wrote).
"""

from __future__ import annotations

import pickle
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

#: operations with no engine method
STOP = "stop"
NOOP = "noop"
#: the engine operations whose result is checked, and the log each goes to
PRODUCES = {"activate": "first", "window": "window", "window_spec": "window"}


class LockstepError(RuntimeError):
    """A follower's tokens differ from rank 0's."""


def encode(op: str, args: dict, checks: list) -> bytes:
    """One operation on the wire: its name, its host arguments (ints,
    floats, lists, numpy arrays, None) and rank 0's produced tokens to
    check."""
    return pickle.dumps((op, args, checks), protocol=pickle.HIGHEST_PROTOCOL)


def decode(payload: bytes) -> tuple:
    """Inverse of :func:`encode`: ``(op, args, checks)``."""
    return pickle.loads(payload)


class Channel:
    """Rank 0's broadcasts to every rank over a gloo group (made here
    unless given: a collective call, made by every rank in turn)."""

    def __init__(self, group: Any = None) -> None:
        import torch.distributed as dist

        self.group = group if group is not None else dist.new_group(
            backend="gloo")
        self.rank = dist.get_rank()

    def send(self, payload: bytes) -> None:
        import torch.distributed as dist

        n = torch.tensor([len(payload)], dtype=torch.int64)
        dist.broadcast(n, 0, group=self.group)
        dist.broadcast(torch.frombuffer(bytearray(payload), dtype=torch.uint8),
                       0, group=self.group)

    def recv(self) -> bytes:
        import torch.distributed as dist

        n = torch.zeros(1, dtype=torch.int64)
        dist.broadcast(n, 0, group=self.group)
        buf = torch.empty(int(n[0]), dtype=torch.uint8)
        dist.broadcast(buf, 0, group=self.group)
        return buf.numpy().tobytes()


class Leader:
    """Rank 0's end: sends each operation before its engine runs it."""

    def __init__(self, channel: Channel) -> None:
        self.channel = channel
        self._checks: list = []
        self._sent_at = time.monotonic()
        #: token arrays sent for the followers to check
        self.checks_sent = 0

    def send(self, op: str, args: dict) -> None:
        checks, self._checks = self._checks, []
        self.channel.send(encode(op, args, checks))
        self._sent_at = time.monotonic()
        self.checks_sent += len(checks)

    def produced(self, kind: str, *arrays) -> None:
        """Tokens rank 0 produced (a first token, a window's tokens): sent
        with the next operation for the followers to check."""
        self._checks.append((kind, [np.asarray(a) for a in arrays]))

    def keepalive(self, every_s: float) -> None:
        """A no-op when nothing was sent for ``every_s``: an idle server's
        followers never wait on a broadcast past the group's timeout."""
        if time.monotonic() - self._sent_at > every_s:
            self.send(NOOP, {})

    def stop(self) -> None:
        """End the followers' loops (with the last tokens to check)."""
        self.send(STOP, {})


class Follower:
    """Another rank's end: runs rank 0's operations on ``engine`` until
    rank 0 stops, checking rank 0's tokens against its own."""

    def __init__(self, channel: Channel, engine: Any) -> None:
        self.channel, self.engine = channel, engine
        self.logs = {kind: deque() for kind in set(PRODUCES.values())}
        self.ops = self.checked = 0

    def run(self) -> dict:
        """The loop; returns ``{"ops", "checked"}`` once rank 0 stops.
        Raises :class:`LockstepError` when tokens differ, and whatever an
        operation or the channel raises (rank 0 gone)."""
        while True:
            op, args, checks = decode(self.channel.recv())
            self._check(checks)
            if op == STOP:
                return {"ops": self.ops, "checked": self.checked}
            if op == NOOP:
                continue
            out = getattr(self.engine, "_do_" + op)(**args)
            self.ops += 1
            if op in PRODUCES:
                self.logs[PRODUCES[op]].append(
                    out if isinstance(out, tuple) else (out,))

    def _check(self, checks: list) -> None:
        for kind, theirs in checks:
            if not self.logs[kind]:
                raise LockstepError(f"rank {self.channel.rank}: rank 0 "
                                    f"produced a {kind} this rank did not")
            mine = self.logs[kind].popleft()
            for m, t in zip(mine, theirs):
                if isinstance(m, torch.Tensor):
                    m = m.cpu().numpy()
                if not np.array_equal(np.asarray(m), t):
                    raise LockstepError(
                        f"rank {self.channel.rank}: {kind} #{self.checked} "
                        f"differs from rank 0's: {np.asarray(m).tolist()} "
                        f"vs {t.tolist()}")
            self.checked += 1


def role(engine: Any, group: Optional[Any] = None):
    """(Leader, None) on rank 0, (None, Follower) elsewhere, over a new
    channel; (None, None) in a world of one."""
    import torch.distributed as dist

    if dist.get_world_size() == 1:
        return None, None
    channel = Channel(group)
    if channel.rank == 0:
        return Leader(channel), None
    return None, Follower(channel, engine)
