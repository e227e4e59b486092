"""The Llama family: Llama, Mistral and Mixtral (``model_type`` ``llama``,
``mistral`` and ``mixtral``, and a configuration that names none).

Every layer alike: pre-norm GQA attention with RoPE under a causal mask,
then a SwiGLU MLP or, with ``num_local_experts``, Mixtral's routed
experts (softmax router, the top k renormalised over the k chosen,
GShard's static capacity in training, the Switch load-balancing loss).
The program is the port's ``models/train.py`` or ``models/moe.py`` train
step and its ``InferenceEngine``, over a tree that stacks each layer leaf
``[L, ...]`` (``[in, out]`` matrices, a float32 router).  The protocol is
``families/__init__.py``'s.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench import weights
from portbench.frozen import bounds, flops
from portbench.reference import judge, model
from portbench.reference.training import causal_attention

__all__ = [
    "port_config", "globals_table", "layer_table", "program_params",
    "program_slice", "train_program", "engine", "SERVE_RANGES", "route_tap",
    "served_routes", "replayed_routes", "ref_embed", "ref_embed_grads",
    "ref_head", "ref_layer", "ref_aux_weight", "ref_serve_layer",
    "int8_control", "train_flops", "flash_least_s",
]

ROUTER = "router"

Table = Dict[str, Tuple[tuple, int, torch.dtype]]


def port_config(hf: Dict[str, Any]):
    """The port's ``LlamaConfig`` or ``MoEConfig`` of a published
    ``config.json`` (Llama, Mistral or Mixtral keys).  A key the port has
    no counterpart for must hold the value the port computes."""
    from dstack_tpu_torch.models.llama import LlamaConfig
    from dstack_tpu_torch.models.moe import MoEConfig

    if hf.get("hidden_act", "silu") != "silu":
        raise ValueError("the port's MLP is SwiGLU (silu)")
    if hf.get("sliding_window") is not None:
        raise ValueError("the port has no sliding-window attention")
    if hf.get("rope_scaling") is not None:
        raise ValueError("rope scaling is not mapped")
    heads = hf["num_attention_heads"]
    kw = dict(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"], num_heads=heads,
        num_kv_heads=hf["num_key_value_heads"],
        head_dim=hf.get("head_dim") or hf["hidden_size"] // heads,
        rope_theta=float(hf["rope_theta"]), rms_eps=float(hf["rms_norm_eps"]),
        max_seq_len=hf["max_position_embeddings"],
        dtype=getattr(torch, hf.get("torch_dtype", "bfloat16")),
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)))
    if "num_local_experts" not in hf:
        return LlamaConfig(**kw)
    assumed = hf.get("assumed", {})
    return MoEConfig(num_experts=hf["num_local_experts"],
                     experts_per_token=hf["num_experts_per_tok"],
                     capacity_factor=float(assumed["capacity_factor"]),
                     router_aux_weight=float(hf["router_aux_loss_coef"]),
                     **kw)


def _routed(cfg) -> bool:
    return hasattr(cfg, "num_experts")


# -- the parameters

def globals_table(cfg) -> Table:
    d = cfg.hidden_size
    out = {"embed": ((cfg.vocab_size, d), d, cfg.dtype),
           "final_norm": ((d,), 0, cfg.dtype)}
    if not cfg.tie_embeddings:
        out["lm_head"] = ((d, cfg.vocab_size), d, cfg.dtype)
    return out


def layer_table(cfg, layer: int) -> Table:
    """The same leaves in every layer."""
    d, f = cfg.hidden_size, cfg.intermediate_size
    out = {
        "attn_norm": ((d,), 0, cfg.dtype),
        "wq": ((d, cfg.q_dim), d, cfg.dtype),
        "wk": ((d, cfg.kv_dim), d, cfg.dtype),
        "wv": ((d, cfg.kv_dim), d, cfg.dtype),
        "wo": ((cfg.q_dim, d), cfg.q_dim, cfg.dtype),
        "mlp_norm": ((d,), 0, cfg.dtype),
    }
    if _routed(cfg):
        e = cfg.num_experts
        out[ROUTER] = ((d, e), d, torch.float32)
        out.update(w_gate=((e, d, f), d, cfg.dtype),
                   w_up=((e, d, f), d, cfg.dtype),
                   w_down=((e, f, d), f, cfg.dtype))
    else:
        out.update(w_gate=((d, f), d, cfg.dtype), w_up=((d, f), d, cfg.dtype),
                   w_down=((f, d), f, cfg.dtype))
    return out


def program_params(cfg, seed: int, device) -> dict:
    """The port's tree: the global leaves, and ``layers`` with each layer
    leaf stacked over every layer."""
    params = {name: weights.draw(seed, name, -1, *spec, device)
              for name, spec in globals_table(cfg).items()}
    params["layers"] = {
        name: weights.stack(seed, name, range(cfg.num_layers), spec, device)
        for name, spec in layer_table(cfg, 0).items()}
    return params


def program_slice(params, name: str, layer: int):
    return (params[name], None) if layer < 0 else (
        params["layers"][name], layer)


# -- the program

def train_program(cfg, params, opt, compile_cache=None):
    """The port's train state over ``params`` and its step at its defaults
    (remat, AdamW), the dense one with the flash kernels from
    ``compile_cache``."""
    from dstack_tpu_torch.models import moe, train

    state = train.state_from_params(params, cfg, opt)
    if compile_cache is not None:
        for name in ("flash_fwd", "flash_bwd"):
            compile_cache.ensure(name)
    if _routed(cfg):
        return state, moe.make_train_step(cfg, opt)
    return state, train.make_train_step(cfg, opt, compile_cache=compile_cache)


def engine(cfg, params, settings: Dict[str, Any], device,
           compile_cache=None):
    from dstack_tpu_torch.serving.engine import InferenceEngine

    return InferenceEngine(
        cfg, params=params, batch_size=settings["batch_size"],
        max_len=settings["max_len"], paged=settings["paged"],
        kv_block_size=settings["kv_block_size"], device=device,
        compile_cache=compile_cache)


SERVE_RANGES = (("dstack_tpu_torch.models.moe", "_moe_mlp", "portbench.moe"),)


# -- the routing the reference follows

class RouteTap:
    """The router logits of every ``moe._route`` call while
    :attr:`enabled`, with the call's capacity and token mask: what the
    checks replay where the program and the reference route a token
    differently (see ``reference/judge.py``)."""

    def __init__(self, num_layers: int):
        self.num_layers = num_layers
        self.enabled = False
        self.calls: List[Tuple[Any, int, Optional[Any]]] = []

    def install(self, patches) -> bool:
        from dstack_tpu_torch.models import moe

        def make(route):
            def tap(logits, k, capacity, *args, **kwargs):
                if self.enabled:
                    mask = kwargs.get("token_mask", args[0] if args else None)
                    self.calls.append((logits.detach(), int(capacity),
                                       None if mask is None
                                       else mask.detach()))
                return route(logits, k, capacity, *args, **kwargs)
            return tap
        return patches.wrap(moe, "_route", make)

    def by_layer(self, calls) -> List[Tuple[Any, int]]:
        """A training step's calls from its first: the forward's, one a
        layer (remat's second pass comes after)."""
        return [(logits, capacity)
                for logits, capacity, _ in calls[:self.num_layers]]


def route_tap(cfg) -> Optional[RouteTap]:
    return RouteTap(cfg.num_layers) if _routed(cfg) else None


def served_routes(cfg, calls, device):
    if not _routed(cfg):
        return False
    try:
        return judge.ProgramRoutes(calls, cfg.num_layers,
                                   cfg.experts_per_token, device)
    except ValueError:  # no whole forwards tapped: nothing to follow
        return None


def replayed_routes(cfg, routes):
    return (judge.ReplayRoutes(routes, cfg.experts_per_token)
            if _routed(cfg) else False)


# -- the plain reference

def ref_embed(cfg, g, ids):
    return g["embed"][ids]


def ref_embed_grads(cfg, g, ids, dout) -> Dict[str, torch.Tensor]:
    g_embed = torch.zeros_like(g["embed"])
    g_embed.index_add_(0, ids.reshape(-1), dout.reshape(ids.numel(), -1))
    return {"embed": g_embed}


def ref_head(cfg, g, x, mm):
    h = model.rms_norm(x, g["final_norm"], cfg.rms_eps)
    h = h.reshape(-1, h.shape[-1])
    return mm(h, g["lm_head"] if "lm_head" in g else g["embed"].T)


def _moe(cfg, h, w, mm, follow=None):
    """[T, D] -> (out, aux, router logits) with the configuration's static
    capacity, the experts multiplied by ``mm``; ``follow`` (another side's
    router logits [T, E] and capacity) routes the tokens as that side did
    instead."""
    t, _ = h.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    capacity = max(int(math.ceil(t * k / e * cfg.capacity_factor)), 1)
    logits = h @ w[ROUTER]
    probs = torch.softmax(logits, -1)
    theirs = logits.detach() if follow is None else follow[0]
    if follow is not None and follow[1] is not None:
        capacity = follow[1]
    experts = model.top_k(theirs, k)
    chosen = F.one_hot(experts, e).float()                     # [T, k, E]
    kept = judge._fits(theirs, k, capacity, None)              # [T, k]
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


def ref_layer(cfg, layer: int, x, w, mms, follow=None):
    """[B, S, D] -> (x, aux, router logits); ``mms``: the matmul of every
    matrix but the experts', and the experts'."""
    mm, mm_experts = mms
    b, s, _ = x.shape
    h = model.rms_norm(x, w["attn_norm"], cfg.rms_eps)
    q = mm(h, w["wq"]).view(b, s, cfg.num_heads, cfg.head_dim)
    kk = mm(h, w["wk"]).view(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = mm(h, w["wv"]).view(b, s, cfg.num_kv_heads, cfg.head_dim)
    q = torch.stack([model.rope(q[r], cfg.rope_theta) for r in range(b)])
    kk = torch.stack([model.rope(kk[r], cfg.rope_theta) for r in range(b)])
    x = x + mm(causal_attention(q, kk, v).reshape(b, s, -1), w["wo"])
    h = model.rms_norm(x, w["mlp_norm"], cfg.rms_eps)
    if ROUTER in w:
        out, aux, logits = _moe(cfg, h.reshape(b * s, -1), w, mm_experts,
                                follow)
        return x + out.view(b, s, -1), aux, logits
    y = mm(F.silu(mm(h, w["w_gate"])) * mm(h, w["w_up"]), w["w_down"])
    return x + y, None, None


def ref_aux_weight(cfg) -> float:
    return getattr(cfg, "router_aux_weight", 0.0) / cfg.num_layers


def _serve_moe(h, w, k: int, route: Optional[model.Route] = None):
    """Routed SwiGLU experts on h [n, D], each token to its ``k`` experts
    by a stable descending sort of its router logits (no capacity), or as
    ``route`` gives them; returns (out, router logits)."""
    logits = h @ w[ROUTER]
    probs = torch.softmax(logits, dim=-1)
    if route is None:
        experts = model.top_k(logits, k)
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


def ref_serve_layer(cfg, layer: int, x, w, route: Optional[model.Route] = None):
    """One decoder layer on x [n, D]; returns (x, router logits or None)."""
    n = x.shape[0]
    h = model.rms_norm(x, w["attn_norm"], cfg.rms_eps)
    q = model.rope((h @ w["wq"]).view(n, cfg.num_heads, cfg.head_dim),
                   cfg.rope_theta)
    kk = model.rope((h @ w["wk"]).view(n, cfg.num_kv_heads, cfg.head_dim),
                    cfg.rope_theta)
    v = (h @ w["wv"]).view(n, cfg.num_kv_heads, cfg.head_dim)
    x = x + model.attention(q, kk, v).reshape(n, -1) @ w["wo"]
    h = model.rms_norm(x, w["mlp_norm"], cfg.rms_eps)
    if ROUTER in w:
        out, logits = _serve_moe(h, w, cfg.experts_per_token, route)
        return x + out, logits
    return x + (F.silu(h @ w["w_gate"]) * (h @ w["w_up"])) @ w["w_down"], None


def int8_control(name: str, w):
    """Every matrix but the router through int8 a output channel; the
    [V, D] embedding, whose rows are read, a row."""
    if w.dim() < 2 or name == ROUTER:
        return w
    if name == "embed":
        return model.int8_rounded(w.T).T
    return model.int8_rounded(w)


# -- the yardsticks

def train_flops(cfg, batch: int, seq: int) -> int:
    return flops.train_step_flops(cfg, batch, seq)


def flash_least_s(cfg, batch: int, seq: int, n_fwd: int, n_bwd: int
                  ) -> float:
    """Every launch at the cell's causal shape."""
    least = bounds.flash_bounds((batch, seq, cfg.num_heads,
                                 cfg.num_kv_heads, cfg.head_dim))
    return (n_fwd * least["fwd"][0] + n_bwd * least["bwd"][0]) / 1e3
