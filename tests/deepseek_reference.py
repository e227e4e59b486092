"""DeepSeek-V3's block as Kanana-2 publishes it (``deepseek_v3``), in
float32 plain PyTorch: the forward, the loss and its gradients, written
from the published description (kakaocorp/kanana-2-30b-a3b-instruct-2601
``config.json`` and DeepSeek-V3's modelling code), independent of the
port: no kernel, no cache, nothing of ``dstack_tpu_torch``, ``jax`` or
``dstack_tpu``.  The routed MLP, its capacity, AdamW and the expert
bias's rule are Trinity's and come from ``tests/afmoe_reference.py``
(itself plain PyTorch, no port).

A layer: h = rmsnorm(x); q = h Wq, each head [nope + rope], split into
q_nope and q_pe; [c, k_pe] = h W_kv_a; [k_nope, v] per head = rmsnorm(c)
W_kv_b; q_pe and the one k_pe rotated as the modelling code does with
``rope_interleave``: each head's rope dimensions permuted from
(x0, x1, x2, ...) to (x0, x2, ..., x1, x3, ...), then rotated by split
halves at positions 0..S-1; q = [q_nope, q_pe], k = [k_nope, k_pe]
(k_pe the same for every head); causal softmax attention at scale
(nope + rope)^-0.5; the heads' outputs @ Wo, added to x.  Then rmsnorm
and the MLP branch: SwiGLU on the first ``num_dense_layers`` layers, the
routed experts plus the shared SwiGLU on the others (``noaux_tc`` with
one group: sigmoid scores, top k of scores + bias, the chosen scores over
their sum + 1e-20 times ``routed_scaling_factor``).  A final rmsnorm and
the head.

Departures from the published model, both the port's: GShard's static
capacity (``capacity_factor``) and ``held`` experts (one card's share),
as ``tests/afmoe_reference.py`` states them.  Multi-token prediction is
not part of the trained block here.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from tests.afmoe_reference import (_leaves, _rebuild, adamw, bias_update,
                                   moe, route, swiglu)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["adamw", "bias_update", "route", "forward", "loss_and_grads"]


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope_interleave(x, theta: float):
    """x [B, S, H, d], DeepSeek's interleaved convention at positions
    0..S-1: (x0, x1, ...) -> (x0, x2, .., x1, x3, ..), then split
    halves."""
    s, d = x.shape[1], x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
    ang = torch.arange(s, dtype=torch.float64)[:, None] * inv
    cos = ang.cos().float()[:, None, :].to(x.device)
    sin = ang.sin().float()[:, None, :].to(x.device)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v):
    """q, k [B, S, H, dq], v [B, S, H, dv]: causal, scale dq^-0.5."""
    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)


def layer(x, w, cfg, bias):
    """One layer on x [B, S, D]: ``(x, expert counts or None)``."""
    b, s, _ = x.shape
    nope, rope, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
        cfg.v_head_dim
    eps = cfg.rms_eps
    h = rms_norm(x, w["attn_norm"], eps)
    q = (h @ w["wq"]).view(b, s, -1, nope + rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    ckv = h @ w["w_kv_a"]
    c, k_pe = ckv[..., :cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    kv = (rms_norm(c, w["kv_norm"], eps) @ w["w_kv_b"]).view(
        b, s, -1, nope + dv)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_pe = rope_interleave(q_pe, cfg.rope_theta)
    k_pe = rope_interleave(k_pe[:, :, None, :], cfg.rope_theta)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(-1, -1, k_nope.shape[2], -1)], dim=-1)
    a = attention(q, k, v).reshape(b, s, -1)
    x = x + a @ w["wo"]
    h = rms_norm(x, w["mlp_norm"], eps)
    counts = None
    if "router" in w:
        y, counts = moe(h.reshape(b * s, -1), w, cfg, bias,
                        held=cfg.held_experts)
        y = y.view(b, s, -1)
    else:
        y = swiglu(h, w["w_gate"], w["w_up"], w["w_down"])
    return x + y, counts


def forward(params, tokens, cfg, biases: List[torch.Tensor]):
    """``(logits [B, S, V], counts [L_moe, E])`` of tokens [B, S];
    ``biases``: each routed layer's expert bias, in order."""
    x = params["embed"][tokens]
    counts, r = [], 0
    for w in params["layers"]:
        x, c = layer(x, w, cfg, biases[r] if "router" in w else None)
        if c is not None:
            counts.append(c)
            r += 1
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x @ params["lm_head"], torch.stack(counts)


def loss_and_grads(params, tokens, cfg, biases):
    """``(loss, grads, counts)``: the mean cross entropy of tokens [B, S+1]
    (inputs [:, :-1], targets [:, 1:]) and its gradient in ``params``'
    tree."""
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    logits, counts = forward(params, tokens[:, :-1], cfg, biases)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), _rebuild(params, grads), counts
