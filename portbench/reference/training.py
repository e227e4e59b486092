"""The plain reference of the first training steps: the model of the
cell's family (``families/``: its embedding, layers and head) in float32
PyTorch, its loss, gradients and AdamW (optax's chain: clip by global
norm, then decoupled weight decay), nothing of the port.

A step runs layer by layer: the forward keeps each layer's input, the
backward runs each layer again under autograd from its input and the
gradient of its output, so one layer's graph is held at a time.  Every
parameter slice (a leaf of one layer) is a float32 tensor of its own with
its two moments.  A layer's aux loss (an MoE layer's load balancing)
enters the loss with the family's weight.

The state is stored as the configuration states it: each parameter
slice and its two moments in the leaf's dtype (the family's table: bf16,
a router float32), rounded there after every update, as the port's AdamW
keeps them (optax's for bf16 parameters).  The arithmetic is float32
throughout.

``precision="fp8"`` is the control: each weight matrix and the
activations it multiplies rounded to float8 e4m3 (one scale a tensor) in
the forward, the step below bf16 that a later change would be tempted to
take for training; the backward passes through the rounding unchanged.
``precision="fp8_experts"`` rounds the experts' matrices alone, as a
change that moved only the expert matmuls to fp8 would (the family's
layer takes both matmuls and uses the second for its experts).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import weights
from portbench.reference import model
from portbench.reference.judge import leaf_key

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


def causal_attention(q, k, v):
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


class Reference:
    """Float32 state: every (leaf, layer) slice with its two moments.

    A routed layer of step t follows ``follow[t][l]`` (another side's
    router logits and capacity) where given, as the served check does: the
    program computes its router in bf16 activations, and a near tie
    decided the other way would change everything after it; the router
    logits are compared by themselves (``router_gap``).  Each step's own
    router logits are kept in ``routes``, a layer (None: not routed)."""

    def __init__(self, family, cfg, seed: int, device,
                 precision: str = "f32"):
        model.use_exact_matmuls()
        self.family, self.cfg, self.seed, self.device = (family, cfg, seed,
                                                          device)
        self.mm = _mm(precision)
        self.p: Dict[str, torch.Tensor] = {}
        #: the dtype each slice is stored in
        self.dtype: Dict[str, torch.dtype] = {}
        table = family.globals_table(cfg)
        #: the global leaves' names
        self.names = list(table)
        #: layer -> {leaf name: key of its slice in ``p``}
        self.keys: List[Dict[str, str]] = []
        for name, t in weights.reference_globals(family, cfg, seed,
                                                 device).items():
            self.p[leaf_key(name, -1)] = t
            self.dtype[leaf_key(name, -1)] = table[name][2]
        for l in range(cfg.num_layers):
            names = {}
            table = family.layer_table(cfg, l)
            for name, t in weights.reference_layer(family, cfg, seed, l,
                                                   device).items():
                names[name] = leaf_key(name, l)
                self.p[names[name]] = t
                self.dtype[names[name]] = table[name][2]
            self.keys.append(names)
        self.routes: List[List[Optional[torch.Tensor]]] = []
        self.router_gap = 0.0
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.t = 0

    def _w(self, l: int, grad: bool) -> Dict[str, torch.Tensor]:
        return {name: self.p[key].detach().requires_grad_(grad)
                for name, key in self.keys[l].items()}

    def loss_and_grads(self, tokens: torch.Tensor, follow=None):
        cfg, mm, fam = self.cfg, self.mm, self.family
        mm_head = mm[0]
        t = (tokens.shape[1] - 1) * tokens.shape[0]
        if follow is not None and (len(follow) != cfg.num_layers or any(
                f is not None and f[0].shape[0] != t for f in follow)):
            # the other side routed other tokens than this batch's: no
            # routing to follow, and the router check fails
            self.router_gap, follow = float("inf"), None
        follow = follow or [None] * cfg.num_layers
        own: List[Optional[torch.Tensor]] = []
        inp, tgt = tokens[:, :-1].long(), tokens[:, 1:].long()
        g = {name: self.p[leaf_key(name, -1)] for name in self.names}
        xs = [fam.ref_embed(cfg, g, inp)]
        aux_w = fam.ref_aux_weight(cfg)
        aux_total = 0.0
        with torch.no_grad():
            for l in range(cfg.num_layers):
                x, aux, logits = fam.ref_layer(cfg, l, xs[-1],
                                               self._w(l, False), mm,
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
        # the head's leaves take their gradients in the table's order
        head = {name: t.detach().requires_grad_(True)
                for name, t in g.items()}
        ce = F.cross_entropy(fam.ref_head(cfg, head, x_last, mm_head),
                             tgt.reshape(-1))
        ce.backward()
        for name, t in head.items():
            if t.grad is not None:
                grads[leaf_key(name, -1)] = t.grad
        dout = x_last.grad
        for l in reversed(range(cfg.num_layers)):
            x_in = xs[l].detach().requires_grad_(True)
            w = self._w(l, True)
            out, aux, _ = fam.ref_layer(cfg, l, x_in, w, mm, follow[l])
            if aux is None:
                torch.autograd.backward([out], [dout])
            else:
                torch.autograd.backward(
                    [out, aux], [dout, torch.tensor(aux_w, device=out.device)])
            for name, t in w.items():  # a leaf the layer leaves unused: 0
                grads[leaf_key(name, l)] = (torch.zeros_like(t)
                                            if t.grad is None else t.grad)
            dout = x_in.grad
            del out, w, x_in
        for name, t in fam.ref_embed_grads(cfg, g, inp, dout).items():
            key = leaf_key(name, -1)
            grads[key] = grads[key] + t if key in grads else t
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
        fam, cfg = self.family, self.cfg
        start = weights.reference_globals(fam, cfg, self.seed, self.device)
        out["update"] = {leaf_key(name, -1): float((self.p[leaf_key(
            name, -1)] - t).norm()) for name, t in start.items()}
        for l in range(cfg.num_layers):
            start = weights.reference_layer(fam, cfg, self.seed, l,
                                            self.device)
            for name, key in self.keys[l].items():
                out["update"][key] = float((self.p[key] - start[name]).norm())
        if self.routes and any(r is not None for r in self.routes[0]):
            out["router_gap"] = self.router_gap
        return out
