"""Sequence-chunked cross entropy.

The [B, S, V] f32 logits of a Llama vocabulary dominate training memory
(b8 x s1024 x 128,256 is 4.2 GB).  This never builds them whole: it walks
sequence chunks, and each chunk's ``x @ head`` and NLL run under
``torch.utils.checkpoint``, so the backward recomputes one chunk's logits
at a time (one extra head matmul per step), as the JAX package's
``jax.checkpoint(body)`` does.  The chunk's default is
``DSTACK_TPU_CE_CHUNK``, read at each call (:func:`ce_chunk`).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def _pick_chunk(seq: int, target: int) -> int:
    chunk = min(target, seq)
    while seq % chunk:
        chunk -= 1
    return chunk


def f32_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """``x @ head`` as f32 logits from f32 sums, as the JAX package's
    ``preferred_element_type=float32`` matmul gives them.  bf16 inputs on
    the card go through ``torch.mm``'s ``out_dtype`` (bf16 tensor cores,
    f32 output, no rounding to bf16); elsewhere the inputs are widened to
    f32 first, which for bf16 inputs gives the same exact products."""
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        return _MmF32.apply(x, head)
    return torch.matmul(x.float(), head.float())


class _MmF32(torch.autograd.Function):
    """bf16 [..., D] @ bf16 [D, V] -> f32 [..., V]; the backward takes the
    f32 output gradient back to bf16 for the two bf16 products."""

    @staticmethod
    def forward(ctx, x, head):
        ctx.save_for_backward(x, head)
        flat = x.reshape(-1, x.shape[-1])
        return torch.mm(flat, head, out_dtype=torch.float32).reshape(
            *x.shape[:-1], head.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        x, head = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1]).to(x.dtype)
        dx = (g @ head.T).reshape(x.shape)
        dhead = x.reshape(-1, x.shape[-1]).T @ g
        return dx, dhead


def _chunk_nll(x, head, targets, mask):
    logits = f32_logits(x, head)                          # [B, C, V] f32
    # nll = logsumexp(logits) - logits[target]: no [B, C, V] log-softmax
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = lse - picked
    return nll.sum() if mask is None else (nll * mask.float()).sum()


def ce_chunk(chunk: Optional[int] = None) -> int:
    """The sequence chunk of the cross entropy: ``chunk``, or else
    ``DSTACK_TPU_CE_CHUNK`` read now (default 512, the JAX package's
    measured best for the 1B bench shape), with the JAX package's
    errors."""
    if chunk is None:
        raw = os.environ.get("DSTACK_TPU_CE_CHUNK", "512")
        try:
            chunk = int(raw)
        except ValueError:
            raise ValueError(f"DSTACK_TPU_CE_CHUNK={raw!r} is not an int")
        if chunk < 1:
            raise ValueError(f"DSTACK_TPU_CE_CHUNK must be >= 1, got {raw}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return chunk


def chunked_nll_sum(x: torch.Tensor, head: torch.Tensor,
                    targets: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    chunk: Optional[int] = None) -> tuple:
    """``(total, count)``: the NLL summed over the (masked) positions, f32
    and differentiable, and the number of those positions, f32 without a
    gradient (see :func:`chunked_cross_entropy`; a sharded loss sums both
    over the batch's ranks)."""
    chunk = ce_chunk(chunk)
    b, s, _ = x.shape
    chunk = _pick_chunk(s, chunk)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, s, chunk):
        part = slice(start, start + chunk)
        total = total + checkpoint(
            _chunk_nll, x[:, part], head, targets[:, part],
            None if mask is None else mask[:, part],
            use_reentrant=False, preserve_rng_state=False)
    count = (torch.tensor(float(b * s)) if mask is None
             else mask.float().sum())
    return total, count.to(total.device)


def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor,
                          targets: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          chunk: Optional[int] = None) -> torch.Tensor:
    """Mean NLL over (masked) positions without full logits.

    x: [B, S, D] final hidden states; head: [D, V] (``embed.T`` when tied);
    targets: [B, S] int; mask: [B, S], 1 where the loss counts.  ``chunk``
    is the target sequence chunk, shrunk to a divisor of S (None:
    :func:`ce_chunk`'s)."""
    total, count = chunked_nll_sum(x, head, targets, mask, chunk)
    return total / count.clamp_min(1.0)
