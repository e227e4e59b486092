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
- :func:`sum_grad` is the identity whose backward all-reduces (a replicated
  input read by rank-local work: the batch axes for a replicated weight,
  ``tensor`` for the input of a column-parallel product).
- :func:`psum` all-reduces, and its backward is the identity (the sum of
  a row-parallel product, whose consumers are replicated).

No DTensor op runs here: DTensor's sharding propagation over the seven
axes of a mesh costs seconds per new op signature.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.distributed as dist

# newer torch names the tensor-in, tensor-out collectives *_single
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    shape = list(x.shape)
    out = torch.empty([n * shape[0]] + shape[1:], dtype=x.dtype,
                      device=x.device)
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
    _reduce_scatter_single(
        out, parts.reshape([n * shape[0]] + shape[1:]), group=group)
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


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


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


def all_reduce_sum(x: torch.Tensor, mesh: Any, axes: Sequence[str]
                   ) -> torch.Tensor:
    """``x`` (no gradient) summed over ``axes`` of ``mesh``."""
    out = x.detach().clone()
    for axis in axes:
        if mesh.size(mesh.mesh_dim_names.index(axis)) > 1:
            dist.all_reduce(out, group=mesh.get_group(axis))
    return out
