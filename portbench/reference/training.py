"""The plain reference of the first training steps: the same model in
float32 PyTorch, its loss, gradients and AdamW (optax's chain: clip by
global norm, then decoupled weight decay), nothing of the port.

A step runs layer by layer: the forward keeps each layer's input, the
backward runs each layer again under autograd from its input and the
gradient of its output, so one layer's graph is held at a time.  Every
parameter slice (a leaf of one layer) is a float32 tensor of its own with
its two moments.  An MoE layer routes the batch's tokens with the static
capacity of the configuration (GShard: choice-major slots, a token over
its expert's capacity dropped), gates renormalised over the k chosen, and
adds the Switch load-balancing loss.

The state is stored as the configuration states it: each parameter
slice and its two moments in the leaf's dtype (bf16; the router float32),
rounded there after every update, as the port's AdamW keeps them (optax's
for bf16 parameters).  The arithmetic is float32 throughout.

``precision="fp8"`` is the control: each weight matrix and the
activations it multiplies rounded to float8 e4m3 (one scale a tensor) in
the forward, the step below bf16 that a later change would be tempted to
take for training; the backward passes through the rounding unchanged.
``precision="fp8_experts"`` rounds the experts' matrices alone, as a
change that moved only the expert matmuls to fp8 would.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import weights
from portbench.reference import model
from portbench.reference.judge import _fits, leaf_key

FP8_MAX = 448.0


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp_min(1e-12) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    @staticmethod
    def backward(ctx, g):
        return g


def _fp8_mm(a, b):
    return torch.matmul(_Fp8.apply(a), _Fp8.apply(b))


#: precision -> the matmul of every other matrix, and the experts'
_MATMULS = {"f32": (torch.matmul, torch.matmul), "fp8": (_fp8_mm, _fp8_mm),
            "fp8_experts": (torch.matmul, _fp8_mm)}


def _mm(precision: str):
    if precision not in _MATMULS:
        raise ValueError(f"unknown precision {precision!r}")
    return _MATMULS[precision]


def _attention(q, k, v):
    """Causal GQA on [B, S, H, D], each (row, kv head) recomputed in the
    backward."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv

    def one(qh, kh, vh):                       # [S, g, D], [S, D], [S, D]
        scores = torch.einsum("sgd,td->gst", qh, kh) * d ** -0.5
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
        return torch.einsum("gst,td->sgd", torch.softmax(scores, -1), vh)

    rows = []
    for r in range(b):
        heads = [checkpoint(one, q[r, :, h * g:(h + 1) * g], k[r, :, h],
                            v[r, :, h], use_reentrant=False)
                 for h in range(hkv)]
        rows.append(torch.cat(heads, dim=1))
    return torch.stack(rows)


def _moe(cfg, h, w, mm, follow=None):
    """[T, D] -> (out, aux, router logits) with the configuration's static
    capacity, the experts multiplied by ``mm``; ``follow`` (another side's router logits [T, E] and
    capacity) routes the tokens as that side did instead."""
    t, _ = h.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    capacity = max(int(math.ceil(t * k / e * cfg.capacity_factor)), 1)
    logits = h @ w["router"]
    probs = torch.softmax(logits, -1)
    theirs = logits.detach() if follow is None else follow[0]
    if follow is not None and follow[1] is not None:
        capacity = follow[1]
    experts = model.top_k(theirs, k)
    chosen = F.one_hot(experts, e).float()                     # [T, k, E]
    kept = _fits(theirs, k, capacity, None)                    # [T, k]
    gates = probs.gather(1, experts)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9) * kept
    out = torch.zeros_like(h)
    for j in range(e):
        rows, slot = ((experts == j) & kept).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        y = mm(F.silu(mm(x, w["w_gate"][j])) * mm(x, w["w_up"][j]),
               w["w_down"][j])
        out = out.index_add(0, rows, y * gates[rows, slot, None])
    aux = e * torch.sum(chosen[:, 0, :].mean(0) * probs.mean(0))
    return out, aux, logits.detach()


def _layer(cfg, x, w, mms, follow=None):
    """[B, S, D] -> (x, aux, router logits); ``mms``: the matmul of every
    matrix but the experts', and the experts', as :func:`_mm` gives
    them."""
    mm, mm_experts = mms
    b, s, _ = x.shape
    h = model.rms_norm(x, w["attn_norm"], cfg.rms_eps)
    q = mm(h, w["wq"]).view(b, s, cfg.num_heads, cfg.head_dim)
    kk = mm(h, w["wk"]).view(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = mm(h, w["wv"]).view(b, s, cfg.num_kv_heads, cfg.head_dim)
    q = torch.stack([model.rope(q[r], cfg.rope_theta) for r in range(b)])
    kk = torch.stack([model.rope(kk[r], cfg.rope_theta) for r in range(b)])
    x = x + mm(_attention(q, kk, v).reshape(b, s, -1), w["wo"])
    h = model.rms_norm(x, w["mlp_norm"], cfg.rms_eps)
    if "router" in w:
        out, aux, logits = _moe(cfg, h.reshape(b * s, -1), w, mm_experts,
                                follow)
        return x + out.view(b, s, -1), aux, logits
    y = mm(F.silu(mm(h, w["w_gate"])) * mm(h, w["w_up"]), w["w_down"])
    return x + y, None, None


class Reference:
    """Float32 state: every (leaf, layer) slice with its two moments.

    An MoE layer of step t follows ``follow[t][l]`` (another side's router
    logits and capacity) where given, as the served check does: the
    program computes its router in bf16 activations, and a near tie
    decided the other way would change everything after it; the router
    logits are compared by themselves (``router_gap``).  Each step's own
    router logits are kept in ``routes``."""

    def __init__(self, cfg, seed: int, device, precision: str = "f32"):
        model.use_exact_matmuls()
        self.cfg, self.seed, self.device = cfg, seed, device
        self.mm = _mm(precision)
        self.p: Dict[str, torch.Tensor] = {}
        #: the dtype each slice is stored in
        self.dtype: Dict[str, torch.dtype] = {}
        #: layer -> {leaf name: key of its slice in ``p``}
        self.keys: List[Dict[str, str]] = []
        for name, t in weights.reference_globals(cfg, seed, device).items():
            self.p[leaf_key(name, -1)] = t
            self.dtype[leaf_key(name, -1)] = weights.stored_dtype(cfg, name)
        for l in range(cfg.num_layers):
            names = {}
            for name, t in weights.reference_layer(cfg, seed, l,
                                                   device).items():
                names[name] = leaf_key(name, l)
                self.p[names[name]] = t
                self.dtype[names[name]] = weights.stored_dtype(cfg, name)
            self.keys.append(names)
        self.routes: List[List[torch.Tensor]] = []
        self.router_gap = 0.0
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.t = 0

    def _w(self, l: int, grad: bool) -> Dict[str, torch.Tensor]:
        return {name: self.p[key].detach().requires_grad_(grad)
                for name, key in self.keys[l].items()}

    def loss_and_grads(self, tokens: torch.Tensor, follow=None):
        cfg, mm = self.cfg, self.mm
        mm_head = mm[0]
        t = (tokens.shape[1] - 1) * tokens.shape[0]
        if follow is not None and (len(follow) != cfg.num_layers or any(
                f[0].shape[0] != t for f in follow)):
            # the other side routed other tokens than this batch's: no
            # routing to follow, and the router check fails
            self.router_gap, follow = float("inf"), None
        follow = follow or [None] * cfg.num_layers
        own: List[torch.Tensor] = []
        inp, tgt = tokens[:, :-1].long(), tokens[:, 1:].long()
        b, s = inp.shape
        embed = self.p["embed"]
        xs = [embed[inp]]
        aux_w = getattr(cfg, "router_aux_weight", 0.0) / cfg.num_layers
        aux_total = 0.0
        with torch.no_grad():
            for l in range(cfg.num_layers):
                x, aux, logits = _layer(cfg, xs[-1], self._w(l, False), mm,
                                        follow[l])
                xs.append(x)
                if aux is not None:
                    aux_total += float(aux)
                    own.append(logits)
                    if follow[l] is not None:
                        self.router_gap = max(self.router_gap, float(
                            (logits - follow[l][0]).abs().amax()))
        self.routes.append(own)
        grads: Dict[str, torch.Tensor] = {}
        x_last = xs.pop().requires_grad_(True)
        fn = self.p["final_norm"].detach().requires_grad_(True)
        head_key = "lm_head" if "lm_head" in self.p else "embed"
        head = self.p[head_key].detach().requires_grad_(True)
        h = model.rms_norm(x_last, fn, cfg.rms_eps).reshape(b * s, -1)
        w_head = head if head_key == "lm_head" else head.T
        ce = F.cross_entropy(mm_head(h, w_head), tgt.reshape(-1))
        ce.backward()
        grads["final_norm"] = fn.grad
        grads[head_key] = head.grad
        dout = x_last.grad
        for l in reversed(range(cfg.num_layers)):
            x_in = xs[l].detach().requires_grad_(True)
            w = self._w(l, True)
            out, aux, _ = _layer(cfg, x_in, w, mm, follow[l])
            if aux is None:
                torch.autograd.backward([out], [dout])
            else:
                torch.autograd.backward(
                    [out, aux], [dout, torch.tensor(aux_w, device=out.device)])
            for name, t in w.items():
                grads[leaf_key(name, l)] = t.grad
            dout = x_in.grad
            del out, w, x_in
        g_embed = torch.zeros_like(embed)
        g_embed.index_add_(0, inp.reshape(-1), dout.reshape(b * s, -1))
        if head_key == "embed":
            grads["embed"] = grads["embed"] + g_embed
        else:
            grads["embed"] = g_embed
        return float(ce.detach()), aux_total / cfg.num_layers, grads

    @torch.no_grad()
    def adamw(self, grads, lr: float, wd: float, clip: float, b1: float,
              b2: float, eps: float) -> Dict[str, torch.Tensor]:
        """One update; returns the clipped gradients."""
        norm = math.sqrt(sum(float(g.square().sum()) for g in grads.values()))
        factor = clip / max(norm, clip)
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, g in grads.items():
            g.mul_(factor)
            m, v, p, dt = self.m[k], self.v[k], self.p[k], self.dtype[k]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (m / c1) / ((v / c2).sqrt() + eps) + wd * p
            p.sub_(lr * upd)
            for t in (m, v, p):
                t.copy_(t.to(dt))
        return grads

    def steps(self, batches: List[torch.Tensor], opt, follow=None) -> Dict:
        """The first ``len(batches)`` steps: each step's loss, the first
        clipped gradient's norm a slice, the parameters' change a slice
        (``follow[i]``: step i's routing to follow, a layer)."""
        out: Dict = {"loss": [], "aux": []}
        for i, tokens in enumerate(batches):
            loss, aux, grads = self.loss_and_grads(
                tokens.to(self.device), None if follow is None else follow[i])
            out["loss"].append(loss)
            out["aux"].append(aux)
            grads = self.adamw(grads, opt.lr, opt.weight_decay,
                               opt.grad_clip, opt.b1, opt.b2, opt.eps)
            if i == 0:
                out["grad"] = {k: float(g.norm()) for k, g in grads.items()}
            del grads
        start = weights.reference_globals(self.cfg, self.seed, self.device)
        out["update"] = {leaf_key(name, -1): float((self.p[leaf_key(
            name, -1)] - t).norm()) for name, t in start.items()}
        for l in range(self.cfg.num_layers):
            start = weights.reference_layer(self.cfg, self.seed, l,
                                            self.device)
            for name, key in self.keys[l].items():
                out["update"][key] = float((self.p[key] - start[name]).norm())
        if self.routes and self.routes[0]:
            out["router_gap"] = self.router_gap
        return out
