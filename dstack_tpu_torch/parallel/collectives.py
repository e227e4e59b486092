"""Differentiable collectives over the axes of a mesh, on local tensors.

The sharded training path computes on each rank's local shards and moves
data with these.  Each is an autograd function whose backward is the
forward's adjoint under the invariant the model keeps: an activation that
is the same on every rank of an axis (replicated) carries, on each of
them, its whole gradient.

- :func:`gather` all-gathers a tensor along one dim over an axis.  Over a
  batch axis (``fsdp``: each rank's rows give part of the gradient) its
  backward reduce-scatters, summing; over an axis whose ranks compute the
  same thing (``tensor`` before the loss) it keeps the rank's own slice.
- :func:`reduce_scatter` sums a tensor over an axis, each rank keeping
  its part along one dim (an MoE rank's experts' slots of every stripe's
  dispatch); its backward all-gathers, the adjoint of :func:`gather`'s
  reducing backward.
- :func:`sum_grad` is the identity whose backward all-reduces (a replicated
  input read by rank-local work: the batch axes for a replicated weight,
  ``tensor`` for the input of a column-parallel product).
- :func:`psum` all-reduces, and its backward is the identity (the sum of
  a row-parallel product, whose consumers are replicated).
- :func:`ppermute` sends a tensor to a neighbour along an axis (``lax.
  ppermute``: a rank that no pair sends to receives zeros); its backward
  is the inverse permutation.
- :func:`all_to_all` is the tiled swap of ``lax.all_to_all`` (split one
  dim into a part per rank, concatenate the received parts along
  another); its backward is the inverse swap.

:func:`ppermute` picks its route by the axis group's backend: NCCL
sends device memory (``batch_isend_irecv``); gloo, whose send and recv
read a CUDA tensor's device pointer as host memory (on an H100 they fail
with "Bad address"), gets a copy in host memory and its result is copied
back.  :func:`all_to_all` is ``all_to_all_single`` under both (gloo
takes CUDA tensors there, as it does for all-reduce, broadcast and both
all-gathers; its list ``all_to_all`` does not exist).  Ranks that share
one card run under gloo.

No DTensor op runs here: DTensor's sharding propagation over the seven
axes of a mesh costs seconds per new op signature.  Each collective runs
in a ``collective.<name>`` span while ``torch.profiler`` runs
(:mod:`dstack_tpu_torch.telemetry.spans`; its host time: the whole
collective under gloo, the launch under NCCL).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.distributed as dist

from dstack_tpu_torch.telemetry import spans

# newer torch names the tensor-in, tensor-out collectives *_single
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    shape = list(x.shape)
    out = torch.empty([n * shape[0]] + shape[1:], dtype=x.dtype,
                      device=x.device)
    with spans.span("collective.all_gather"):
        _all_gather_single(out, x.contiguous(), group=group)
    if dim == 0:
        return out
    shape[dim] *= n
    return out.reshape([n] + list(x.shape)).movedim(0, dim).reshape(shape)


def _reduce_scatter(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] //= n
    parts = x.reshape(shape[:dim] + [n] + shape[dim:]).movedim(dim, 0)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    # NCCL reads the buffer as if it were contiguous, and along dim 0 this
    # is a view of x, which may be strided (an einsum's gradient); gloo
    # copies such a buffer, NCCL sums the wrong elements
    parts = parts.reshape([n * shape[0]] + shape[1:]).contiguous()
    with spans.span("collective.reduce_scatter"):
        _reduce_scatter_single(out, parts, group=group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, rank, reduce):
        ctx.args = (dim, group, n, rank, reduce)
        return _all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, grad):
        dim, group, n, rank, reduce = ctx.args
        if reduce:
            return _reduce_scatter(grad, dim, group, n), *(None,) * 5
        size = grad.shape[dim] // n
        return (grad.narrow(dim, rank * size, size).contiguous(),
                *(None,) * 5)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.args = (dim, group, n)
        return _reduce_scatter(x, dim, group, n)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, *ctx.args), None, None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        with spans.span("collective.all_reduce"):
            dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        with spans.span("collective.all_reduce"):
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _permute(x: torch.Tensor, group, pairs, index: int) -> torch.Tensor:
    """What this rank (``index`` on the axis of ``group``) receives when
    every ``(src, dst)`` of ``pairs`` sends its ``x``: zeros when no pair
    sends to it.  Under gloo through host memory."""
    host = dist.get_backend(group) != "nccl"
    send = x.contiguous()
    if host:
        send = send.cpu()
    recv = torch.zeros_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, d),
                      group=group) for s, d in pairs if s == index]
    ops += [dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, s),
                       group=group) for s, d in pairs if d == index]
    with spans.span("collective.ppermute"):
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
    return recv.to(x.device) if host else recv


def _swap(x: torch.Tensor, group, n: int, split_dim: int,
          concat_dim: int) -> torch.Tensor:
    """``x`` split along ``split_dim`` into ``n`` parts, part j sent to
    rank j of the group, and the parts received concatenated along
    ``concat_dim`` in rank order."""
    send = torch.stack(x.chunk(n, split_dim))
    recv = torch.empty_like(send)
    with spans.span("collective.all_to_all"):
        dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, pairs, index):
        ctx.args = (group, [(d, s) for s, d in pairs], index)
        return _permute(x, group, pairs, index)

    @staticmethod
    def backward(ctx, grad):
        return _permute(grad, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_dim, concat_dim):
        ctx.args = (group, n, concat_dim, split_dim)
        return _swap(x, group, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return _swap(grad, *ctx.args), None, None, None, None


def gather(x: torch.Tensor, dim: int, mesh: Any, axis: str,
           reduce: bool) -> torch.Tensor:
    """``x`` all-gathered along ``dim`` over ``axis`` of ``mesh`` (rank
    order along the axis); the backward reduce-scatters when ``reduce``,
    else takes this rank's slice."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n == 1:
        return x
    return _Gather.apply(x, dim, mesh.get_group(axis), n,
                         mesh.get_local_rank(axis), reduce)


def reduce_scatter(x: torch.Tensor, dim: int, mesh: Any,
                   axis: str) -> torch.Tensor:
    """``x`` summed over ``axis`` of ``mesh``, rank j keeping part j of
    the sum split along ``dim`` (which must divide by the axis size); the
    backward all-gathers the parts' gradients along ``dim``."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    return _ReduceScatter.apply(x, dim, mesh.get_group(axis), n)


def sum_grad(x: torch.Tensor, mesh: Any, axes: Sequence[str]) -> torch.Tensor:
    """The identity, whose backward sums the gradient over ``axes``."""
    for axis in axes:
        if mesh.size(mesh.mesh_dim_names.index(axis)) > 1:
            x = _SumGrad.apply(x, mesh.get_group(axis))
    return x


def psum(x: torch.Tensor, mesh: Any, axis: str) -> torch.Tensor:
    """``x`` summed over ``axis``; the backward passes the gradient on."""
    if mesh.size(mesh.mesh_dim_names.index(axis)) == 1:
        return x
    return _Psum.apply(x, mesh.get_group(axis))


def ppermute(x: torch.Tensor, mesh: Any, axis: str,
             perm: Sequence[tuple]) -> torch.Tensor:
    """What this rank receives when each ``(src, dst)`` of ``perm``
    (indices along ``axis``) sends its ``x`` to ``dst``; zeros where no
    pair sends (``lax.ppermute``).  The backward sends each gradient back
    along the inverse pairs."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    pairs = [(int(s), int(d)) for s, d in perm]
    for pair in pairs:
        if not all(0 <= i < n for i in pair):
            raise ValueError(f"ppermute pair {pair} is not on an axis of {n}")
    for side in (0, 1):
        if len({p[side] for p in pairs}) != len(pairs):
            raise ValueError(f"ppermute pairs {pairs} are no permutation")
    if n == 1:
        return x if (0, 0) in pairs else torch.zeros_like(x)
    return _Ppermute.apply(x, mesh.get_group(axis), pairs,
                           mesh.get_local_rank(axis))


def all_to_all(x: torch.Tensor, mesh: Any, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all over ``axis`` (``lax.all_to_all(tiled=True)``):
    ``x`` split along ``split_dim`` into one part per rank, part j sent to
    rank j, the received parts concatenated along ``concat_dim`` in rank
    order.  ``x.shape[split_dim]`` must divide by the axis size.  The
    backward is the inverse swap."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    return _AllToAll.apply(x, mesh.get_group(axis), n, split_dim, concat_dim)


def all_reduce_sum(x: torch.Tensor, mesh: Any, axes: Sequence[str]
                   ) -> torch.Tensor:
    """``x`` (no gradient) summed over ``axes`` of ``mesh``."""
    out = x.detach().clone()
    for axis in axes:
        if mesh.size(mesh.mesh_dim_names.index(axis)) > 1:
            dist.all_reduce(out, group=mesh.get_group(axis))
    return out


def all_gather_list(x: torch.Tensor, dim: int, mesh: Any,
                    axis: str) -> torch.Tensor:
    """``x`` (no gradient) all-gathered along ``dim`` over ``axis`` of
    ``mesh``, in rank order, through the list form of all-gather: with
    all-reduce and broadcast, the collectives whose CUDA tensors gloo
    takes as well as NCCL (the serving path's, which may run under
    either)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)
