"""The plain reference of the served models: the model of the cell's
family (``families/``: its embedding, layers and head) in float32
PyTorch, one sequence at a time, no cache, no batching, nothing of the
port; and the pieces the families build their references from.

Layer ``l`` is drawn again from the seed (``weights.reference_layer``)
when the forward reaches it, and every sequence passes through it before
the next layer is drawn, so one layer's float32 weights are on the card
at a time.  A routed layer takes ``route``'s experts, and which of them
the token keeps, where given (the judge replays the program's routing
there: ``judge.py``).

``precision="int8"`` is the control: the matrices rounded to int8 as the
family's ``int8_control`` says (one scale per output channel; the step
below bf16 that a later change would be tempted to take), the arithmetic
still float32.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from portbench import weights


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


def _precision(family, tree: Dict[str, torch.Tensor], precision: str
               ) -> Dict[str, torch.Tensor]:
    if precision == "f32":
        return tree
    if precision != "int8":
        raise ValueError(f"unknown precision {precision!r}")
    return {name: family.int8_control(name, w) for name, w in tree.items()}


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


def forward(family, cfg, seed: int, seqs: List[List[int]],
            spans: List[Tuple[int, int]], device, precision: str = "f32",
            route: Optional[Callable[[int, int], Route]] = None):
    """Logits [stop - start, V] at each sequence's positions
    ``spans[i]``, and each sequence's router logits a layer (None: not
    routed).  ``route(layer, i)`` gives sequence i's routing at a
    layer."""
    use_exact_matmuls()
    g = _precision(family, weights.reference_globals(family, cfg, seed,
                                                     device), precision)
    with torch.no_grad():
        xs = [family.ref_embed(cfg, g, torch.tensor(s, device=device))
              for s in seqs]
        routes: List[List[torch.Tensor]] = [[] for _ in seqs]
        for l in range(cfg.num_layers):
            w = _precision(family, weights.reference_layer(
                family, cfg, seed, l, device), precision)
            for i, x in enumerate(xs):
                xs[i], logits = family.ref_serve_layer(
                    cfg, l, x, w, None if route is None else route(l, i))
                routes[i].append(logits)
            del w
        out = [family.ref_head(cfg, g, x[a:b], torch.matmul)
               for x, (a, b) in zip(xs, spans)]
    return out, routes
