"""The device mesh: named parallelism axes over the ranks of a process group.

The JAX package's ``parallel/mesh.py`` maps a TPU slice onto a logical
``jax.sharding.Mesh``; the port maps its process group (one process per
card, see :mod:`dstack_tpu_torch.parallel.distributed`) onto a
``torch.distributed.device_mesh.DeviceMesh`` with the same named axes, in
the same order:

- ``dcn``    — data parallelism across slices (slowest-varying);
- ``stage``  — pipeline parallelism (stacked layers split into contiguous
               runs, one a stage: ``parallel/pipeline.py``);
- ``data``   — pure data parallelism;
- ``fsdp``   — fully-sharded data parallelism (params and moments sharded,
               gathered per layer);
- ``expert`` — expert parallelism (MoE experts; activations replicated);
- ``seq``    — sequence (context) parallelism: each rank holds a stripe
               of the sequence (``ops/ring_attention.py``,
               ``ops/ulysses.py``);
- ``tensor`` — tensor parallelism over heads and the ffn (fastest-varying,
               so it sits on adjacent ranks).

A sharding spec is the port's counterpart of a JAX ``PartitionSpec``: a
tuple with one entry per tensor dim, each an axis name, a tuple of names
(the first the major one) or None.  :func:`placements` turns one into
DTensor placements over a mesh and :func:`shard_index` gives the block of
the global tensor a rank holds, as JAX's ``addressable_shards`` index it.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Optional, Sequence, Tuple, Union

import torch

DCN = "dcn"
STAGE = "stage"
DATA = "data"
FSDP = "fsdp"
TENSOR = "tensor"
SEQ = "seq"
EXPERT = "expert"

#: Canonical axis order: slowest-varying (DCN) first, tensor last.
AXIS_ORDER = (DCN, STAGE, DATA, FSDP, EXPERT, SEQ, TENSOR)

#: a spec entry: one axis, several (major first), or None (not sharded)
SpecEntry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[SpecEntry, ...]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism layout. Product of sizes must equal device count."""

    dcn: int = 1   # number of slices (multislice over DCN)
    stage: int = 1
    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1

    @property
    def sizes(self) -> dict[str, int]:
        return {
            DCN: self.dcn,
            STAGE: self.stage,
            DATA: self.data,
            FSDP: self.fsdp,
            EXPERT: self.expert,
            SEQ: self.seq,
            TENSOR: self.tensor,
        }

    @property
    def num_devices(self) -> int:
        return math.prod(self.sizes.values())

    def axis_names(self) -> tuple[str, ...]:
        return AXIS_ORDER

    @staticmethod
    def auto(
        n_devices: int,
        *,
        tensor: Optional[int] = None,
        seq: int = 1,
        data: int = 1,
        dcn: int = 1,
        stage: int = 1,
    ) -> "MeshSpec":
        """Pick a default layout: given optional tensor/seq/data/dcn/stage
        degrees, put all remaining parallelism on ``fsdp``."""
        tensor = tensor or 1
        used = tensor * seq * data * dcn * stage
        if n_devices % used != 0:
            raise ValueError(
                f"n_devices={n_devices} not divisible by "
                f"tensor*seq*data*dcn*stage={used}"
            )
        return MeshSpec(dcn=dcn, stage=stage, data=data,
                        fsdp=n_devices // used, tensor=tensor, seq=seq)


def shrink_spec(spec: MeshSpec, n_devices: int) -> MeshSpec:
    """Recompute ``spec`` for a smaller (or larger) surviving device count.

    The axes that change the program (``tensor``/``seq``/``stage``) are
    kept; the data-parallel axes fold into what the survivors support:
    ``data`` and ``expert`` shrink first (the largest divisor of the
    remainder that divides their old degree), the rest goes to ``fsdp``,
    and ``dcn`` becomes 1.  A restored state reshards onto the new mesh
    (``train.resume_train_state``) with the model's function unchanged.

    Raises ValueError when ``n_devices`` cannot host the kept axes.
    """
    if n_devices <= 0:
        raise ValueError(f"n_devices must be positive, got {n_devices}")
    fixed = spec.tensor * spec.seq * spec.stage
    if n_devices % fixed != 0:
        raise ValueError(
            f"{n_devices} surviving devices cannot keep tensor={spec.tensor} "
            f"x seq={spec.seq} x stage={spec.stage} (= {fixed}); shrink one "
            "of the model-topology axes explicitly"
        )
    remaining = n_devices // fixed
    data = math.gcd(remaining, spec.data)
    remaining //= data
    expert = math.gcd(remaining, spec.expert)
    remaining //= expert
    return MeshSpec(
        dcn=1, stage=spec.stage, data=data, fsdp=remaining,
        tensor=spec.tensor, seq=spec.seq, expert=expert,
    )


def multislice_spec(n_devices: int, **kw) -> MeshSpec:
    """:meth:`MeshSpec.auto` with ``dcn`` from ``MEGASCALE_NUM_SLICES`` (the
    control plane's slice count for multislice jobs)."""
    dcn = int(os.environ.get("MEGASCALE_NUM_SLICES", "1"))
    return MeshSpec.auto(n_devices, dcn=dcn, **kw)


def build_mesh(spec: MeshSpec, device_type: Optional[str] = None,
               backend: Optional[str] = None):
    """A DeviceMesh over the whole process group with ``spec``'s sizes in
    :data:`AXIS_ORDER` as its dims and the axis names as its dim names.

    Ranks are laid out row-major, so ``tensor`` (the last axis) varies
    fastest: tensor-parallel peers are adjacent ranks, on one host first.
    ``device_type`` is "cuda" unless the caller names "cpu".  ``backend``
    ("gloo") makes every axis's group that backend's, whatever the device
    (ranks sharing one card)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from dstack_tpu_torch.utils.device import resolve_device

    device_type = resolve_device(device_type).type
    world = dist.get_world_size()
    if spec.num_devices != world:
        raise ValueError(
            f"MeshSpec wants {spec.num_devices} devices, have {world}: {spec}")
    shape = tuple(spec.sizes[a] for a in AXIS_ORDER)
    kw = {} if backend is None else {
        "backend_override": {a: backend for a in AXIS_ORDER}}
    return init_device_mesh(device_type, shape, mesh_dim_names=AXIS_ORDER,
                            **kw)


def local_mesh(spec: Optional[MeshSpec] = None,
               device_type: Optional[str] = None):
    """Mesh over every rank of the process group (``MeshSpec.auto`` of the
    world size unless ``spec`` is given)."""
    import torch.distributed as dist

    if spec is None:
        spec = MeshSpec.auto(dist.get_world_size())
    return build_mesh(spec, device_type)


# -- specs over a mesh ---------------------------------------------------------


def entry_axes(entry: SpecEntry) -> Tuple[str, ...]:
    """The axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_sizes(mesh: Any) -> dict[str, int]:
    """Axis name -> size of a DeviceMesh (or anything with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _check_spec(spec: Spec, sizes: dict[str, int]) -> None:
    seen = set()
    for entry in spec:
        axes = entry_axes(entry)
        for a in axes:
            if a not in sizes:
                raise ValueError(f"spec {spec} names {a!r}, not a mesh axis "
                                 f"of {tuple(sizes)}")
            if a in seen:
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            seen.add(a)
        order = [AXIS_ORDER.index(a) for a in axes]
        if order != sorted(order):
            # a DTensor shards one tensor dim over several mesh dims in the
            # mesh's order; JAX takes the entry's order
            raise NotImplementedError(
                f"spec entry {entry} lists its axes out of the mesh order "
                f"{AXIS_ORDER}")


def placements(spec: Spec, mesh: Any) -> tuple:
    """DTensor placements over ``mesh`` for ``spec``: ``Shard(d)`` on each
    mesh dim that shards tensor dim ``d``, ``Replicate()`` elsewhere.  A
    tensor dim over several axes is split major-first, as JAX splits it."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_sizes(mesh)
    _check_spec(spec, sizes)
    dim_of = {a: d for d, entry in enumerate(spec) for a in entry_axes(entry)}
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.mesh_dim_names)


def shard_index(spec: Spec, shape: Sequence[int], sizes: dict[str, int],
                coord: dict[str, int]) -> list:
    """``[[start, stop], ...]`` per dim: the block of a ``shape`` tensor
    that the rank at mesh coordinate ``coord`` holds under ``spec`` (the
    format of a snapshot's shard index).  Every sharded dim must divide
    evenly."""
    _check_spec(spec, sizes)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, (n, entry) in enumerate(zip(shape, spec)):
        count, index = 1, 0
        for a in entry_axes(entry):
            count *= sizes[a]
            index = index * sizes[a] + coord[a]
        if n % count:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"into {count} shards of spec {spec}")
        block = n // count
        out.append([index * block, (index + 1) * block])
    return out


def mesh_coordinate(mesh: Any) -> dict[str, int]:
    """This rank's coordinate on each axis of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def local_block(full: torch.Tensor, spec: Spec, mesh: Any) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a view)."""
    index = shard_index(spec, full.shape, mesh_sizes(mesh),
                        mesh_coordinate(mesh))
    return full[tuple(slice(s, e) for s, e in index)]


def copy_to(block: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``block`` (a view of a whole tensor) on
    ``device``, sharing no memory with the whole."""
    return torch.empty(block.shape, dtype=block.dtype,
                       device=device).copy_(block)


def distribute(local: torch.Tensor, spec: Spec, mesh: Any,
               shape: Sequence[int]):
    """A DTensor of global ``shape`` from this rank's ``local`` block."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=shape, stride=stride)


def shard_call(fn, mesh: Any, spec: Spec, *xs):
    """``fn`` on the local shards of DTensors ``xs``, each placed by
    ``spec`` first (redistributed when placed otherwise): the result is a
    DTensor placed by ``spec`` with the first input's global shape.  The
    per-rank body of the JAX package's ``shard_map`` wrappers."""
    from torch.distributed.tensor import DTensor

    want = placements(spec, mesh)

    def local(x):
        if tuple(x.placements) != want:
            x = x.redistribute(mesh, want)
        return x.to_local()

    out = fn(*(local(x) for x in xs))
    return DTensor.from_local(out, mesh, want, run_check=False,
                              shape=xs[0].shape, stride=xs[0].stride())


def batch_stripe(sizes: dict[str, int], coord: dict[str, int],
                 batch_axes: Sequence[str]) -> Tuple[int, int]:
    """``(index, count)``: which of ``count`` equal row stripes of the
    global batch the rank at ``coord`` feeds, the batch being sharded over
    ``batch_axes`` major-first (as JAX shards ``P(batch_axes)``).  Ranks
    that differ only on other axes (``tensor``) read the same rows."""
    count, index = 1, 0
    for a in batch_axes:
        if a in sizes:
            count *= sizes[a]
            index = index * sizes[a] + coord[a]
    return index, count


def mesh_device(mesh: Any) -> torch.device:
    """The device this rank's shards live on: its current card for a CUDA
    mesh, else the mesh's device type."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_tensor(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor itself (the same object on every call, not
    a differentiable view), or ``x`` when it is a plain tensor."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        with torch.no_grad():
            return x.to_local()
    return x


def dtensor_spec(x: Any) -> Spec:
    """The spec of a DTensor's placements (each tensor dim's mesh axes in
    the mesh's order)."""
    names = x.device_mesh.mesh_dim_names
    entries = [[] for _ in range(x.dim())]
    for name, p in zip(names, x.placements):
        if p.is_shard():
            entries[p.dim].append(name)
    return tuple(None if not e else e[0] if len(e) == 1 else tuple(e)
                 for e in entries)


def owns(x: Any) -> bool:
    """Whether this rank is the first holder of its shard of DTensor ``x``:
    coordinate 0 on every axis that replicates it (so each block of the
    global tensor has exactly one owner)."""
    return all(c == 0 for c, p in zip(x.device_mesh.get_coordinate(),
                                      x.placements) if not p.is_shard())
