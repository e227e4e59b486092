"""The plain reference of the served models: Llama/Mistral and Mixtral in
float32 PyTorch, one sequence at a time, no cache, no batching, nothing of
the port.

Layer ``l`` is drawn again from the seed (``weights.reference_layer``)
when the forward reaches it, and every sequence passes through it before
the next layer is drawn, so one layer's float32 weights are on the card
at a time.  Attention is causal GQA over blocks of queries.  An MoE layer
routes each token to its ``k`` experts by a stable descending sort of its
router logits, with the gates renormalised over the k chosen (Mixtral);
``route`` may give the experts and which of them the token keeps instead
(the judge replays the program's routing there: ``judge.py``).

``precision="int8"`` is the control: every matrix but the router rounded
to int8 with one scale per output channel (the step below bf16 that a
later change would be tempted to take), the arithmetic still float32.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench import weights

ROUTER = "router"


def use_exact_matmuls() -> None:
    """float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def int8_rounded(w: torch.Tensor) -> torch.Tensor:
    """``w`` [..., in, out] through int8 with one absmax scale per output
    channel (per row for the [V, D] embedding, whose rows are read)."""
    scale = w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.round(w / scale).clamp_(-127, 127) * scale


def _precision(tree: Dict[str, torch.Tensor], precision: str
               ) -> Dict[str, torch.Tensor]:
    if precision == "f32":
        return tree
    if precision != "int8":
        raise ValueError(f"unknown precision {precision!r}")
    out = {}
    for name, w in tree.items():
        if w.dim() < 2 or name == ROUTER:
            out[name] = w
        elif name == "embed":
            out[name] = int8_rounded(w.T).T
        else:
            out[name] = int8_rounded(w)
    return out


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """Rotary embedding, split halves, at positions 0..n-1; x [n, h, d]."""
    n, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = torch.arange(n, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, block: int = 1024):
    """Causal attention of q [n, Hq, d] over k, v [n, Hkv, d] (query head
    h reads kv head h // (Hq / Hkv))."""
    n, hq, d = q.shape
    group = hq // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    out = torch.empty_like(q)
    for s in range(0, n, block):
        e = min(s + block, n)
        scores = torch.einsum("qhd,khd->hqk", q[s:e], k[:e]) * d ** -0.5
        keep = (torch.arange(s, e, device=q.device)[:, None]
                >= torch.arange(e, device=q.device)[None, :])
        scores = scores.masked_fill(~keep, float("-inf"))
        out[s:e] = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1),
                                v[:e])
    return out


def top_k(logits, k: int):
    return torch.sort(logits, dim=-1, descending=True, stable=True).indices[
        :, :k]


Route = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def moe(h, w, k: int, route: Optional[Route] = None):
    """Routed SwiGLU experts on h [n, D]; returns (out, router logits)."""
    logits = h @ w[ROUTER]
    probs = torch.softmax(logits, dim=-1)
    if route is None:
        experts = top_k(logits, k)
        kept = torch.ones_like(experts, dtype=torch.bool)
    else:
        experts, kept = route(logits)
    gates = probs.gather(1, experts)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    gates = gates * kept
    out = torch.zeros_like(h)
    for e in range(w["w_gate"].shape[0]):
        rows, slot = (experts == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        y = (F.silu(x @ w["w_gate"][e]) * (x @ w["w_up"][e])) @ w["w_down"][e]
        out.index_add_(0, rows, y * gates[rows, slot, None])
    return out, logits


def layer(cfg, x, w, route: Optional[Route] = None):
    """One decoder layer on x [n, D]; returns (x, router logits or None)."""
    n = x.shape[0]
    h = rms_norm(x, w["attn_norm"], cfg.rms_eps)
    q = rope((h @ w["wq"]).view(n, cfg.num_heads, cfg.head_dim), cfg.rope_theta)
    kk = rope((h @ w["wk"]).view(n, cfg.num_kv_heads, cfg.head_dim),
              cfg.rope_theta)
    v = (h @ w["wv"]).view(n, cfg.num_kv_heads, cfg.head_dim)
    x = x + attention(q, kk, v).reshape(n, -1) @ w["wo"]
    h = rms_norm(x, w["mlp_norm"], cfg.rms_eps)
    if ROUTER in w:
        out, logits = moe(h, w, cfg.experts_per_token, route)
        return x + out, logits
    return x + (F.silu(h @ w["w_gate"]) * (h @ w["w_up"])) @ w["w_down"], None


def forward(cfg, seed: int, seqs: List[List[int]],
            spans: List[Tuple[int, int]], device, precision: str = "f32",
            route: Optional[Callable[[int, int], Route]] = None,
            keep_routes: bool = False):
    """Logits [stop - start, V] at each sequence's positions
    ``spans[i]``, and (``keep_routes``) each sequence's router logits a
    layer.  ``route(layer, i)`` gives sequence i's routing at a layer."""
    use_exact_matmuls()
    g = _precision(weights.reference_globals(cfg, seed, device), precision)
    with torch.no_grad():
        xs = [g["embed"][torch.tensor(s, device=device)] for s in seqs]
        routes: List[List[torch.Tensor]] = [[] for _ in seqs]
        for l in range(cfg.num_layers):
            w = _precision(weights.reference_layer(cfg, seed, l, device),
                           precision)
            for i, x in enumerate(xs):
                xs[i], logits = layer(cfg, x, w,
                                      None if route is None else route(l, i))
                if keep_routes and logits is not None:
                    routes[i].append(logits)
            del w
        head = g["lm_head"] if "lm_head" in g else g["embed"].T
        out = [rms_norm(x[a:b], g["final_norm"], cfg.rms_eps) @ head
               for x, (a, b) in zip(xs, spans)]
    return out, routes
