"""Ring attention: causal attention with the sequence sharded over a mesh
axis (context parallelism for long sequences).

Each rank holds a [B, S/n, H, D] stripe of Q/K/V.  K/V blocks rotate
around the ``seq`` ring (:func:`dstack_tpu_torch.parallel.collectives.
ppermute`) while each rank folds the blocks it receives into an
online-softmax accumulator, so attention memory stays O(S/n * S/n) a
rank.  The blocks are plain PyTorch products in f32, as the JAX
package's ``jnp`` einsums are: no fused kernel runs here.  The backward
is autograd's, through the rotations (each one's adjoint sends the
gradient back around the ring).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from dstack_tpu_torch.parallel.collectives import ppermute

_NEG_INF = -1e30


def _block_attn(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                q_pos: torch.Tensor, kv_pos: torch.Tensor) -> tuple:
    """Partial attention for one KV block.

    qg: [B, Sq, Hkv, G, D] f32, pre-scaled; k, v: [B, Skv, Hkv, D];
    positions [1 or B, S].  Returns (m, l, o): the block's row max
    [B, Hkv, G, Sq] (-1e30 on a row with no visible key), its sum of exp
    and its unnormalised output [B, Sq, Hkv, G, D], all f32.

    m is a constant to autograd: the output divides ``o`` by ``l``, which
    carry the same exp(-m), so its gradient is zero, and max's backward
    would keep the [.., Sq, Skv] scores alive.  A row with no visible
    key takes its exp against 0, which makes every entry exp(-1e30) = 0
    (the JAX package zeroes that row after the exp; the values agree)."""
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    mask = q_pos[:, None, None, :, None] >= kv_pos[:, None, None, None, :]
    scores = torch.where(mask, scores, _NEG_INF)
    m = scores.detach().amax(dim=-1)
    seen = m > 0.5 * _NEG_INF
    p = torch.exp(scores - torch.where(seen, m, 0.0)[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return m, l, o


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[B, Hkv, G, Sq] -> [B, Sq, Hkv, G, 1], to scale the accumulator."""
    return x[..., None].permute(0, 3, 1, 2, 4)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: Any, axis_name: str = "seq",
                   scale: Optional[float] = None) -> torch.Tensor:
    """Causal GQA ring attention on this rank's shards.

    q: [B, S/n, Hq, D]; k, v: [B, S/n, Hkv, D], rank r of ``axis_name``
    holding positions r·S/n onwards.  Folds in its own block, then makes
    n − 1 rotations of K/V one step along the ring (the last block held
    is not sent on).  Returns [B, S/n, Hq, D] in q's dtype."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    my = mesh.get_local_rank(axis_name)
    dev = q.device

    qg = (q * scale).float().reshape(b, sq, hkv, hq // hkv, d)
    q_pos = (my * sq + torch.arange(sq, device=dev))[None, :]
    perm = [(j, (j + 1) % n) for j in range(n)]

    def accumulate(state, i, k_cur, v_cur):
        m, l, acc = state
        src = (my - i) % n  # whose block this rank holds now
        kv_pos = (src * skv + torch.arange(skv, device=dev))[None, :]
        bm, bl, bo = _block_attn(qg, k_cur, v_cur, q_pos, kv_pos)
        new_m = torch.maximum(m, bm)
        alpha = torch.exp(m - new_m)  # rescales the old accumulator
        beta = torch.exp(bm - new_m)  # and the block's contribution
        return (new_m, l * alpha + bl * beta,
                acc * _rows(alpha) + bo * _rows(beta))

    state = (torch.full((b, hkv, hq // hkv, sq), _NEG_INF, device=dev),
             torch.zeros((b, hkv, hq // hkv, sq), device=dev),
             torch.zeros((b, sq, hkv, hq // hkv, d), device=dev))
    state = accumulate(state, 0, k, v)
    for i in range(1, n):
        k = ppermute(k, mesh, axis_name, perm)
        v = ppermute(v, mesh, axis_name, perm)
        state = accumulate(state, i, k, v)
    _, l, acc = state
    out = acc / _rows(torch.clamp_min(l, 1e-30))  # rows with no key
    return out.reshape(b, sq, hq, d).to(q.dtype)


def ring_attention_sharded(mesh: Any, q, k, v, *, seq_axis: str = "seq",
                           batch_axes=("dcn", "data", "fsdp"),
                           head_axis: Optional[str] = "tensor"):
    """:func:`ring_attention` over DTensors of the global shapes: the batch
    sharded over ``batch_axes``, the sequence over ``seq_axis`` and the
    heads over ``head_axis``.  Returns a DTensor placed as q."""
    from dstack_tpu_torch.parallel.mesh import shard_call

    def local(q, k, v):
        return ring_attention(q, k, v, mesh=mesh, axis_name=seq_axis)

    return shard_call(local, mesh, (tuple(batch_axes), seq_axis, head_axis,
                                    None), q, k, v)
