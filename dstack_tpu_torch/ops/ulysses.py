"""Ulysses sequence parallelism: an all-to-all swap of heads for sequence.

The second context-parallel scheme beside ring attention
(:mod:`dstack_tpu_torch.ops.ring_attention`), the DeepSpeed-Ulysses
formulation:

1. activations arrive sequence-sharded, ``[B, S/n, H, D]`` a rank;
2. an all-to-all makes them head-sharded, ``[B, S, H/n, D]``: each rank
   holds the whole sequence for a slice of the heads;
3. attention runs locally and unchanged, through the fused causal
   kernels (:func:`dstack_tpu_torch.ops.flash_attention.flash_attention`)
   where they take the shape;
4. a second all-to-all restores the sequence sharding.

It moves ``2 x B·S·H·D/n`` elements in two all-to-alls and needs both
head counts to divide over ``seq`` (times ``tensor``, which splits the
heads first); ring attention takes any head count.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from dstack_tpu_torch.ops import flash_attention as flash
from dstack_tpu_torch.ops.attention import causal_attention
from dstack_tpu_torch.parallel.collectives import all_to_all


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh: Any, axis_name: str = "seq") -> torch.Tensor:
    """Causal GQA attention on this rank's sequence stripe.

    q: [B, S/n, Hq, D]; k, v: [B, S/n, Hkv, D]; Hq and Hkv must divide by
    n.  Returns [B, S/n, Hq, D]."""
    d = q.shape[-1]
    qf, kf, vf = (all_to_all(x, mesh, axis_name, split_dim=2, concat_dim=1)
                  for x in (q, k, v))
    s = qf.shape[1]
    group = qf.shape[2] // kf.shape[2]  # kept: both head counts split n ways
    if flash.supports(s, d, qf.dtype, group=group):
        out = flash.flash_attention(qf, kf, vf)
    else:
        pos = torch.arange(s, device=q.device)[None, :]
        out = causal_attention(qf, kf, vf, q_positions=pos, kv_positions=pos)
    return all_to_all(out, mesh, axis_name, split_dim=1, concat_dim=2)


def ulysses_attention_sharded(mesh: Any, q, k, v, *, seq_axis: str = "seq",
                              batch_axes=("dcn", "data", "fsdp"),
                              head_axis: Optional[str] = "tensor"):
    """:func:`ulysses_attention` over DTensors of the global shapes: the
    batch over ``batch_axes``, the heads over ``head_axis`` (the swap then
    exchanges the heads left on each rank), the sequence over
    ``seq_axis``.  Returns a DTensor placed as q."""
    from dstack_tpu_torch.parallel.mesh import shard_call

    def local(q, k, v):
        return ulysses_attention(q, k, v, mesh=mesh, axis_name=seq_axis)

    return shard_call(local, mesh, (tuple(batch_axes), seq_axis, head_axis,
                                    None), q, k, v)


def supports(cfg, n_seq: int, n_tensor: int = 1) -> bool:
    """Whether Ulysses fits this model and mesh: both head counts split
    over tensor x seq."""
    if n_seq <= 1:
        return True
    return (cfg.num_kv_heads % (n_seq * n_tensor) == 0
            and cfg.num_heads % (n_seq * n_tensor) == 0)
