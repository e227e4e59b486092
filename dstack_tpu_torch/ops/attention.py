"""Grouped-query causal attention, plain PyTorch.

The route :func:`dstack_tpu_torch.models.llama.backbone` takes when the
fused kernel does not handle the shape (custom positions, a sequence that
is not a multiple of 128), and the reference the flash kernels' plain
versions are tested against.  It materialises the [B, Hkv, G, Sq, Skv] f32
scores, as the JAX package's ``causal_attention`` does.  :class:`KVCache`
and :func:`decode_step_attention` are the plain-cache decode of
:func:`dstack_tpu_torch.models.llama.decode_step`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_NEG_INF = -1e30


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     q_positions: Optional[torch.Tensor] = None,
                     kv_positions: Optional[torch.Tensor] = None,
                     kv_valid_length: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """Causal GQA attention.

    q: [B, Sq, Hq, D]; k: [B, Skv, Hkv, D]; v: [B, Skv, Hkv, Dv] (Dv may
    differ from D: latent attention).  Positions ([B or 1, S])
    default to 0..S-1; ``kv_valid_length`` [B] masks cache rows at or past
    it; a ``window`` W masks the keys W or more positions behind the
    query (a sliding-window layer).  ``q * scale`` goes into the dot, scores and softmax are f32 with
    -1e30 where masked, and the probabilities are cast to v's dtype before
    the PV product.  Returns [B, Sq, Hq, Dv] in q's dtype; the scale
    defaults to D^-0.5.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(sq, device=dev)[None, :]
    if kv_positions is None:
        kv_positions = torch.arange(skv, device=dev)[None, :]

    qg = (q * scale).reshape(b, sq, hkv, hq // hkv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    mask = q_positions[:, None, None, :, None] >= kv_positions[:, None, None, None, :]
    if window is not None:
        mask = mask & (q_positions[:, None, None, :, None]
                       - kv_positions[:, None, None, None, :] < window)
    if kv_valid_length is not None:
        valid = (torch.arange(skv, device=dev)[None, :]
                 < kv_valid_length[:, None])
        mask = mask & valid[:, None, None, None, :]
    scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, hq, v.shape[-1]).to(q.dtype)


class KVCache(NamedTuple):
    """The plain decode cache: ``k``, ``v`` [B, max_seq, Hkv, D] and the
    tokens filled so far, ``length`` (a 0-d int tensor, one for the whole
    batch)."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor


def decode_step_attention(q: torch.Tensor, cache: KVCache,
                          new_k: torch.Tensor, new_v: torch.Tensor) -> tuple:
    """One-token decode: write ``new_k``/``new_v`` at ``cache.length``
    and attend over the ``length + 1`` filled rows.  q, new_k, new_v:
    [B, 1, H*, D].  Returns ``(out [B, 1, Hq, D], new cache)``; the cache
    tensors are new ones, as the JAX package's functional update gives
    them."""
    b = q.shape[0]
    idx = torch.as_tensor(cache.length, device=q.device)
    # clamped into the cache as dynamic_update_slice clamps its start
    at = idx.long().clamp(0, cache.k.shape[1] - 1).reshape(1)
    k = cache.k.index_copy(1, at, new_k)
    v = cache.v.index_copy(1, at, new_v)
    out = causal_attention(
        q, k, v, q_positions=idx.long().reshape(1, 1).expand(b, 1),
        kv_positions=torch.arange(k.shape[1], device=q.device)[None, :],
        kv_valid_length=(idx.long() + 1).reshape(1).expand(b))
    return out, KVCache(k=k, v=v, length=idx + 1)
