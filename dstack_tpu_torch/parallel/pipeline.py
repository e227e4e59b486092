"""Pipeline parallelism over a ``stage`` mesh axis: the GPipe schedule.

The stacked layer weights ``[L, ...]`` are sharded over ``stage`` on
their layer dim (``L = stages x layers a stage``), so each stage holds a
contiguous run of layers and the activation hand-off between stages is
one :func:`~dstack_tpu_torch.parallel.collectives.ppermute` hop.

Schedule: fill-drain, as the JAX package's ``lax.scan`` runs it.  With M
microbatches and S stages the loop runs M + S - 1 ticks; each tick every
stage applies its layers to the microbatch it holds (the bubbles
included: the fill ticks run on zeros, the drain ticks of stage 0 on its
last microbatch again), the last stage banks its finished microbatch and
the activations move one hop.  The bubble share is (S - 1) / (M + S - 1).

Every stage takes the same operations in the same order whatever its
index: which input a stage picks up and what it banks are
``torch.where`` selections on its index, not branches, so autograd's
backward issues each rank's collectives in one order (the adjoint of each
hand-off sends the gradient one hop back).  The backward is autograd's
through the schedule; no schedule is written for it.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from dstack_tpu_torch.parallel.collectives import ppermute, psum, sum_grad
from dstack_tpu_torch.parallel.mesh import mesh_sizes


def stage_size(mesh: Any, stage_axis: Optional[str]) -> int:
    if mesh is None or not stage_axis:
        return 1
    return mesh_sizes(mesh).get(stage_axis, 1)


def _map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _stage_run(w, stage: int, per: int, stage_axis: str):
    """This stage's ``per`` layers of a stacked weight: a DTensor's local
    shard (sharded over ``stage_axis`` on its layer dim), or a slice of a
    whole plain tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(w, DTensor):
        return w[stage * per:(stage + 1) * per]
    names = w.device_mesh.mesh_dim_names
    p = w.placements[names.index(stage_axis)]
    if not (p.is_shard() and p.dim == 0):
        raise ValueError(f"a stacked layer weight placed {w.placements}: its "
                         f"layer dim must be sharded over {stage_axis!r}")
    return w.to_local()


def pipeline_layers(layer_fn: Callable[[torch.Tensor, Any], torch.Tensor],
                    layers: Any, x: torch.Tensor, *, mesh: Any,
                    stage_axis: str = "stage",
                    num_microbatches: Optional[int] = None) -> torch.Tensor:
    """``x`` through every layer of ``layers``, pipelined over
    ``stage_axis``.

    ``layer_fn(x, lp) -> x`` is the layer body (remat applied inside it);
    ``layers`` the stacked ``[L, ...]`` weights, a tensor or a dict of
    them: DTensors sharded over ``stage_axis`` on the layer dim, or whole
    plain tensors (each stage then takes its own run of layers); ``x``
    the activation ``[B, ...]`` this rank holds, the same on every stage.
    Returns the output on every stage (summed over ``stage`` from the last
    stage's bank); its gradient reaches ``x`` summed over ``stage``, so
    the input (the embedding) gets it on every stage.

    Raises ValueError unless ``L % stages == 0`` and ``B %
    num_microbatches == 0`` (the default microbatch count is the stage
    count)."""
    num_stages = stage_size(mesh, stage_axis)
    if num_stages <= 1:
        n = _first_leaf(layers).shape[0]
        for layer in range(n):
            x = layer_fn(x, _map(lambda w: w[layer], layers))
        return x
    n_layers = _first_leaf(layers).shape[0]
    if n_layers % num_stages:
        raise ValueError(
            f"num_layers={n_layers} not divisible by {num_stages} pipeline "
            f"stages (axis {stage_axis!r})")
    m = num_microbatches or num_stages
    batch = x.shape[0]
    if batch % m:
        raise ValueError(f"batch={batch} not divisible by "
                         f"num_microbatches={m}")
    stage = mesh.get_local_rank(stage_axis)
    per = n_layers // num_stages
    local = _map(lambda w: _stage_run(w, stage, per, stage_axis), layers)
    run = [_map(lambda w: w[i], local) for i in range(per)]

    # the input is the same on every stage and only stage 0 reads it:
    # the adjoint of that replication sums the gradient over the stages
    x = sum_grad(x, mesh, [stage_axis])
    xs = x.reshape(m, batch // m, *x.shape[1:])
    first = torch.tensor(stage == 0, device=x.device)
    buf = torch.zeros_like(xs[0])
    outs = [torch.zeros_like(xs[0])] * m
    # no wraparound pair: stage 0 overwrites what it would receive
    fwd = [(i, i + 1) for i in range(num_stages - 1)]
    ticks = m + num_stages - 1
    for t in range(ticks):
        # stage 0 picks up microbatch t (the drain ticks repeat the last)
        buf = torch.where(first, xs[min(t, m - 1)], buf)
        for lp in run:
            buf = layer_fn(buf, lp)
        # the last stage banks finished microbatch t - (S - 1)
        oi = t - (num_stages - 1)
        bank = torch.tensor(stage == num_stages - 1 and oi >= 0,
                            device=x.device)
        oi = max(oi, 0)
        outs[oi] = torch.where(bank, buf, outs[oi])
        if t < ticks - 1:  # the last tick's hand-off would go unread
            buf = ppermute(buf, mesh, stage_axis, fwd)
    # only the last stage banked non-zeros: the sum replicates its output
    return psum(torch.cat(outs), mesh, stage_axis).reshape(x.shape)
