"""Training input pipeline: memmapped token shards -> device batches.

- **Zero-copy source**: a corpus is one or more flat binary token files
  (uint16/uint32) read through ``np.memmap``.
- **Deterministic global order**: each epoch is a seeded permutation of
  fixed-length windows; every process computes the same permutation and
  takes a disjoint stripe of each global batch (``process_index``), so
  data parallelism needs no coordination.
- **Resumable by step**: the stream is a pure function of (seed, step).
- **Device prefetch**: with a ``device``, the next batch is copied from
  pinned host memory with ``non_blocking=True`` while the current step
  runs (double buffering).

The same windows and order as the JAX package's ``models/data.py``; the
process index and count are given explicitly (default one process), or
taken from a rank's place on a device mesh (:meth:`DataLoader.on_mesh`),
which under sequence parallelism also gives each rank its stripe of the
sequence (:func:`seq_slice`).
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Iterator, Optional, Sequence, Union

import numpy as np
import torch

TokenSource = Union[str, Path, np.ndarray]


def _as_array(src: TokenSource, dtype) -> np.ndarray:
    if isinstance(src, np.ndarray):
        return src
    return np.memmap(src, dtype=dtype, mode="r")


@dataclasses.dataclass(frozen=True)
class TokenDataset:
    """Fixed-length LM windows over concatenated token shards.

    Each example is ``seq_len + 1`` tokens (inputs ``[:-1]``, targets
    ``[1:]``, the layout ``train.make_train_step`` consumes).  Windows do
    not overlap and never cross a shard boundary.
    """

    sources: tuple
    seq_len: int
    dtype: np.dtype = np.uint16

    @classmethod
    def from_files(cls, paths: Sequence[TokenSource], seq_len: int,
                   dtype=np.uint16) -> "TokenDataset":
        if seq_len < 1:
            raise ValueError("seq_len must be >= 1")
        arrays = tuple(_as_array(p, dtype) for p in paths)
        if not arrays:
            raise ValueError("no sources")
        window = seq_len + 1
        if all(len(a) < window for a in arrays):
            raise ValueError(
                f"no source holds even one window of {window} tokens")
        return cls(sources=arrays, seq_len=seq_len, dtype=np.dtype(dtype))

    @functools.cached_property
    def _offsets(self) -> np.ndarray:
        """Cumulative window counts per source (cached: ``window`` runs
        batch-size times per step)."""
        counts = [len(a) // (self.seq_len + 1) for a in self.sources]
        return np.concatenate([[0], np.cumsum(counts)])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def window(self, index: int) -> np.ndarray:
        """The ``index``-th window as int32 [seq_len + 1]."""
        offsets = self._offsets
        if not 0 <= index < offsets[-1]:
            raise IndexError(index)
        src = int(np.searchsorted(offsets, index, side="right")) - 1
        local = index - int(offsets[src])
        w = self.seq_len + 1
        return np.asarray(self.sources[src][local * w:(local + 1) * w],
                          dtype=np.int32)


def seq_slice(seq_len: int, index: int, count: int) -> slice:
    """The columns of a ``[.., seq_len + 1]`` token window that stripe
    ``index`` of ``count`` reads: its ``seq_len / count`` inputs and one
    more, so its targets (inputs shifted by one, before striping) are
    ``[1:]`` of the same slice."""
    if seq_len % count:
        raise ValueError(f"seq_len={seq_len} not divisible by {count} "
                         f"sequence stripes")
    n = seq_len // count
    return slice(index * n, (index + 1) * n + 1)


def rank_tokens(tokens, mesh, policy=None):
    """This rank's part of a global token batch ``[B, S + 1]`` (a tensor
    or an array): its rows (its coordinate on the policy's batch axes)
    and, when the policy's ``seq_axis`` is on the mesh, its stripe of the
    sequence (:func:`seq_slice`): what a sharded train step takes.  An
    MoE step takes whole sequences under ``seq`` (its ranks there are
    replicas): pass it :func:`dstack_tpu_torch.models.moe.token_policy`
    of its policy."""
    from dstack_tpu_torch.models.llama import ShardingPolicy
    from dstack_tpu_torch.parallel.mesh import (batch_stripe,
                                                mesh_coordinate, mesh_sizes)

    policy = policy or ShardingPolicy()
    sizes, coord = mesh_sizes(mesh), mesh_coordinate(mesh)
    index, count = batch_stripe(sizes, coord, policy.batch_axes)
    rows = tokens.shape[0] // count
    cols = seq_slice(tokens.shape[1] - 1, *_seq_stripe(sizes, coord, policy))
    return tokens[index * rows:(index + 1) * rows, cols]


def _seq_stripe(sizes: dict, coord: dict, policy) -> tuple:
    """(index, count) of the rank's sequence stripe (0, 1 without one)."""
    axis = policy.seq_axis
    if axis is None or sizes.get(axis, 1) == 1:
        return 0, 1
    return coord[axis], sizes[axis]


@functools.lru_cache(maxsize=2)
def _epoch_permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    # memoized: host_batch asks every step; two entries cover the current
    # epoch and the next one that prefetching reaches at the boundary
    return np.random.default_rng((seed, epoch)).permutation(n)


@dataclasses.dataclass
class DataLoader:
    """Deterministic, striped, prefetching batch iterator.

    ``global_batch`` is the batch across all processes; this process
    yields its ``global_batch / num_processes`` stripe, and of each
    window its sequence stripe ``seq_index`` of ``seq_count``
    (:func:`seq_slice`).  Batches are a pure function of (seed, step).
    With a ``device``, :meth:`batches` yields int32 tensors there, each
    copied one step ahead of use; without one, CPU tensors.  Partial tail
    batches are dropped.
    """

    dataset: TokenDataset
    global_batch: int
    seed: int = 0
    process_index: int = 0
    num_processes: int = 1
    device: Optional[Union[str, torch.device]] = None
    seq_index: int = 0
    seq_count: int = 1

    def __post_init__(self):
        if not 0 <= self.process_index < self.num_processes:
            raise ValueError(
                f"process_index={self.process_index} out of range for "
                f"{self.num_processes} processes")
        if self.global_batch % self.num_processes:
            raise ValueError(
                f"global_batch={self.global_batch} not divisible by "
                f"{self.num_processes} processes")
        if not 0 <= self.seq_index < self.seq_count:
            raise ValueError(
                f"seq_index={self.seq_index} out of range for "
                f"{self.seq_count} sequence stripes")
        seq_slice(self.dataset.seq_len, self.seq_index, self.seq_count)
        if len(self.dataset) < self.global_batch:
            raise ValueError(
                f"dataset has {len(self.dataset)} windows < one global "
                f"batch of {self.global_batch}")

    @classmethod
    def on_mesh(cls, dataset: TokenDataset, global_batch: int, mesh,
                policy=None, **kw) -> "DataLoader":
        """The loader of this rank of ``mesh``: its stripe is its
        coordinate along the policy's batch axes (major first, as the
        sharded step shards the batch), not its rank, so ranks that
        differ only in ``tensor`` (or ``stage``) read the same rows; under
        the policy's ``seq_axis`` its coordinate there picks its stripe
        of the sequence.  An MoE trainer passes
        :func:`dstack_tpu_torch.models.moe.token_policy` of its policy:
        whole sequences, its ``seq`` ranks being replicas."""
        from dstack_tpu_torch.models.llama import ShardingPolicy
        from dstack_tpu_torch.parallel.mesh import (batch_stripe,
                                                    mesh_coordinate,
                                                    mesh_sizes)

        policy = policy or ShardingPolicy()
        sizes, coord = mesh_sizes(mesh), mesh_coordinate(mesh)
        index, count = batch_stripe(sizes, coord, policy.batch_axes)
        seq_index, seq_count = _seq_stripe(sizes, coord, policy)
        return cls(dataset, global_batch, process_index=index,
                   num_processes=count, seq_index=seq_index,
                   seq_count=seq_count, **kw)

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.num_processes

    @property
    def steps_per_epoch(self) -> int:
        return len(self.dataset) // self.global_batch

    def host_batch(self, step: int) -> np.ndarray:
        """This process's stripe of global batch ``step`` (pure function)."""
        if step < 0:
            raise ValueError("step must be >= 0")
        epoch, within = divmod(step, self.steps_per_epoch)
        perm = _epoch_permutation(len(self.dataset), self.seed, epoch)
        start = within * self.global_batch
        stripe = perm[start + self.process_index * self.local_batch:
                      start + (self.process_index + 1) * self.local_batch]
        cols = seq_slice(self.dataset.seq_len, self.seq_index,
                         self.seq_count)
        return np.stack([self.dataset.window(int(i))[cols] for i in stripe])

    def _to_device(self, step: int) -> torch.Tensor:
        host = torch.from_numpy(self.host_batch(step))
        if self.device is None:
            return host
        dev = torch.device(self.device)
        if dev.type == "cuda":
            host = host.pin_memory()
        return host.to(dev, non_blocking=True)

    def batches(self, step: int = 0) -> Iterator[dict]:
        """Yield ``{"tokens": [local_batch, seq_len / seq_count + 1]}``
        from ``step`` on, forever (epochs reshuffle); the next batch's copy
        is issued before the current one is handed out."""
        inflight = self._to_device(step)
        while True:
            step += 1
            nxt = self._to_device(step)
            yield {"tokens": inflight}
            inflight = nxt
