"""Trinity (``afmoe``) in float32 plain PyTorch: the forward, the loss, its
gradients, AdamW and the expert bias's rule, written from the published
description (arcee-ai/Trinity-Mini ``config.json`` and its modelling
code), independent of the port: no kernel, no cache, no batching tricks,
nothing of ``dstack_tpu_torch``, ``jax`` or ``dstack_tpu``.

A layer: h = rmsnorm(x); q, k, v = h Wq, h Wk, h Wv per head; q and k
RMS-normed over each head; RoPE (split halves, positions 0..S-1) on
sliding-window layers only; attention causal, and on sliding layers only
the keys fewer than ``window`` positions behind; the output times
sigmoid(h Wg), then Wo; rmsnorm of that; added to x.  Then the MLP branch
the same way between two norms: SwiGLU on the dense layers, on the others
the routed experts plus a shared SwiGLU expert.  The embedding times
``embed_scale``, a final rmsnorm, the head.

Routing: s = sigmoid(h Wr); each token takes the top k of s + bias
(stable: equal values to the lower expert), gates the chosen s over their
sum + 1e-20, times ``route_scale``.  Departures from the published model,
both the port's: GShard's static capacity (``capacity_factor``: each
expert's slots taken choice-major, token-minor; a choice past them is
dropped), and ``held`` experts (one card's share: the routed experts in
``[first, stop)`` alone add their part, routing over all of them).

The parameters are a dict of global leaves and ``layers``, a list of
per-layer dicts; expert stacks ``[E_held, in, out]``; matrices ``[in,
out]``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """x [B, S, H, D], split halves, positions 0..S-1."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
    ang = torch.arange(s, dtype=torch.float64)[:, None] * inv
    cos = ang.cos().float()[:, None, :].to(x.device)
    sin = ang.sin().float()[:, None, :].to(x.device)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: Optional[int]):
    """q [B, S, Hq, D], k/v [B, S, Hkv, D]: query head h reads kv head
    h // (Hq / Hkv); query i sees key j iff j <= i (and i - j < window)."""
    s, d = q.shape[1], q.shape[-1]
    group = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    i = torch.arange(s)[:, None]
    j = torch.arange(s)[None, :]
    keep = j <= i
    if window is not None:
        keep = keep & (i - j < window)
    scores = scores.masked_fill(~keep.to(q.device), float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def route(h, router, bias, k: int, scale: float):
    """``(experts [T, k], gates [T, k], scores [T, E])``."""
    scores = torch.sigmoid(h @ router)
    experts = torch.sort(scores + bias, dim=-1, descending=True,
                         stable=True).indices[:, :k]
    gates = scores.gather(1, experts)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20) * scale
    return experts, gates, scores


def kept_by_capacity(experts, num_experts: int, capacity: int):
    """[T, k] bool: each choice within its expert's first ``capacity``
    slots, taken choice-major, token-minor."""
    t, k = experts.shape
    taken = torch.zeros(num_experts, dtype=torch.long)
    kept = torch.zeros(t, k, dtype=torch.bool)
    for j in range(k):
        for i in range(t):
            e = int(experts[i, j])
            kept[i, j] = bool(taken[e] < capacity)
            taken[e] += 1
    return kept


def moe(h, w: Dict[str, torch.Tensor], cfg, bias,
        held: Optional[Tuple[int, int]] = None,
        shared: bool = True):
    """The routed MLP on h [T, D]: ``(out, counts [E])``, the held experts'
    part (all experts when ``held`` is None) plus the shared expert."""
    t = h.shape[0]
    e, k = cfg.num_experts, cfg.experts_per_token
    first, stop = held if held is not None else (0, e)
    experts, gates, _ = route(h, w["router"], bias, k, cfg.route_scale)
    capacity = max(int(math.ceil(t * k / e * cfg.capacity_factor)), 1)
    kept = kept_by_capacity(experts.cpu(), e, capacity).to(h.device)
    out = torch.zeros_like(h)
    for x in range(first, stop):
        rows, j = ((experts == x) & kept).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        y = swiglu(h[rows], w["w_gate"][x - first], w["w_up"][x - first],
                   w["w_down"][x - first])
        out = out.index_add(0, rows, y * gates[rows, j, None])
    if shared:
        out = out + swiglu(h, w["shared_gate"], w["shared_up"],
                           w["shared_down"])
    counts = torch.bincount(experts.reshape(-1), minlength=e).float()
    return out, counts


def layer(x, w: Dict[str, torch.Tensor], cfg, sliding: bool,
          bias: Optional[torch.Tensor]):
    """One layer on x [B, S, D]: ``(x, expert counts or None)``."""
    b, s, _ = x.shape
    hd, eps = cfg.head_dim, cfg.rms_eps
    h = rms_norm(x, w["attn_norm"], eps)
    q = rms_norm((h @ w["wq"]).view(b, s, -1, hd), w["q_norm"], eps)
    kk = rms_norm((h @ w["wk"]).view(b, s, -1, hd), w["k_norm"], eps)
    v = (h @ w["wv"]).view(b, s, -1, hd)
    if sliding:
        q, kk = rope(q, cfg.rope_theta), rope(kk, cfg.rope_theta)
    a = attention(q, kk, v, cfg.sliding_window if sliding else None)
    a = a.reshape(b, s, -1) * torch.sigmoid(h @ w["w_attn_gate"])
    x = x + rms_norm(a @ w["wo"], w["post_attn_norm"], eps)
    h = rms_norm(x, w["mlp_norm"], eps)
    counts = None
    if "router" in w:
        y, counts = moe(h.reshape(b * s, -1), w, cfg, bias,
                        held=cfg.held_experts)
        y = y.view(b, s, -1)
    else:
        y = swiglu(h, w["w_gate"], w["w_up"], w["w_down"])
    return x + rms_norm(y, w["post_mlp_norm"], eps), counts


def forward(params, tokens, cfg, biases: List[torch.Tensor]):
    """``(logits [B, S, V], counts [L_moe, E])`` of tokens [B, S];
    ``biases``: each routed layer's expert bias, in order."""
    x = params["embed"][tokens] * cfg.embed_scale
    counts, r = [], 0
    for l, w in enumerate(params["layers"]):
        x, c = layer(x, w, cfg, cfg.layer_types[l] == "sliding_attention",
                     biases[r] if "router" in w else None)
        if c is not None:
            counts.append(c)
            r += 1
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return x @ head, torch.stack(counts)


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


def bias_update(bias, counts, rate: float):
    """The expert bias after a step (torchtitan's rule): ``rate *
    sign(mean(n) - n)`` less its mean, ``n`` the step's choices of each
    expert."""
    delta = rate * torch.sign(counts.mean() - counts)
    return bias + (delta - delta.mean())


def adamw(params, grads, m, v, step: int, lr: float, wd: float, clip: float,
          b1: float, b2: float, eps: float):
    """optax's ``chain(clip_by_global_norm(clip), adamw(...))``, one step
    (``step`` counts from 1): the new params, m and v trees."""
    ps, gs, ms, vs = (_leaves(t) for t in (params, grads, m, v))
    norm = math.sqrt(sum(float(g.square().sum()) for g in gs))
    factor = clip / max(norm, clip)
    out_p, out_m, out_v = [], [], []
    for p, g, mi, vi in zip(ps, gs, ms, vs):
        g = g * factor
        mi = b1 * mi + (1 - b1) * g
        vi = b2 * vi + (1 - b2) * g * g
        upd = (mi / (1 - b1 ** step)) / ((vi / (1 - b2 ** step)).sqrt()
                                        + eps) + wd * p
        out_p.append(p - lr * upd)
        out_m.append(mi)
        out_v.append(vi)
    return (_rebuild(params, out_p), _rebuild(params, out_m),
            _rebuild(params, out_v))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for key in tree for x in _leaves(tree[key])]
    if isinstance(tree, list):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(tree, leaves):
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {key: walk(t[key]) for key in t}
        if isinstance(t, list):
            return [walk(x) for x in t]
        return next(it)
    return walk(tree)
