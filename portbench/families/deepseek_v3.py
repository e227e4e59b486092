"""The deepseek_v3 family: DeepSeek-V3's block as Kanana-2 publishes it
(``model_type`` ``deepseek_v3``).

Attention is multi-head latent attention with a full-rank query
(``q_lora_rank`` null): q = h Wq, each head [``qk_nope_head_dim`` +
``qk_rope_head_dim``]; [c, k_pe] = h W_kv_a, c [``kv_lora_rank``]
RMS-normed (``kv_a_layernorm``) and expanded by W_kv_b into each head's
k_nope and v [``v_head_dim``]; q's rope dimensions and the one k_pe
rotated in DeepSeek's interleaved pairs (``rope_interleave``); causal
attention at QK width nope + rope and V width ``v_head_dim``, scale
(nope + rope)^-0.5.  The first ``first_k_dense_replace`` layers have a
SwiGLU MLP; the others route as Trinity's (``families/afmoe.py``, whose
routed MLP, route tap and bias rule this family takes): sigmoid scores
over the router's ``published.n_routed_experts`` experts (``noaux_tc``
with one group), the top k of the scores plus an expert bias moved after
each step by the rule, the chosen scores over their sum times
``routed_scaling_factor``, GShard's static capacity; a shared SwiGLU of
``n_shared_experts`` x ``moe_intermediate_size`` beside.  The card holds
``n_routed_experts`` of the router's experts (one card's share of an
expert-parallel layer).

The program is the port's ``models/deepseek.py`` train step over two
stacks, ``dense_layers`` and ``moe_layers``, in the published layout (no
permutation: the port turns the interleaved pairs in place).  The
reference permutes each rotated head to split halves as DeepSeek's
modelling code does, which gives the same scores.  The protocol is
``families/__init__.py``'s.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import weights
from portbench.families import afmoe
from portbench.frozen import bounds
from portbench.reference import model

ROUTER = afmoe.ROUTER
#: query rows of one block of the reference's attention
ATTN_BLOCK = 1024

Table = afmoe.Table


def port_config(hf: Dict[str, Any]):
    """The port's ``DeepseekV3Config`` of a published deepseek_v3
    ``config.json``; raises where the port has no ``models/deepseek``
    (before anything is built) or where a key asks for what it does not
    compute."""
    from dstack_tpu_torch.models.deepseek import DeepseekV3Config

    want = {"q_lora_rank": None, "rope_scaling": None, "n_group": 1,
            "topk_group": 1, "topk_method": "noaux_tc",
            "scoring_func": "sigmoid", "norm_topk_prob": True,
            "hidden_act": "silu", "attention_bias": False,
            "moe_layer_freq": 1, "rope_interleave": True}
    for key, value in want.items():
        if hf.get(key, value) != value:
            raise ValueError(f"{key} {hf[key]!r}: the port computes {value!r}")
    if hf["head_dim"] != hf["qk_rope_head_dim"]:
        raise ValueError(f"head_dim {hf['head_dim']} is not qk_rope_head_dim "
                         f"{hf['qk_rope_head_dim']}: the port rotates the "
                         f"rope dimensions alone")
    routed = hf.get("published", {}).get("n_routed_experts",
                                         hf["n_routed_experts"])
    heads = hf["num_attention_heads"]
    return DeepseekV3Config(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"], num_heads=heads,
        num_kv_heads=heads, head_dim=hf["qk_rope_head_dim"],
        kv_lora_rank=hf["kv_lora_rank"],
        qk_nope_head_dim=hf["qk_nope_head_dim"],
        qk_rope_head_dim=hf["qk_rope_head_dim"],
        v_head_dim=hf["v_head_dim"],
        rope_theta=float(hf["rope_theta"]), rms_eps=float(hf["rms_norm_eps"]),
        max_seq_len=hf["max_position_embeddings"],
        dtype=getattr(torch, hf.get("torch_dtype", "bfloat16")),
        tie_embeddings=bool(hf["tie_word_embeddings"]),
        num_experts=routed, held_experts=(0, hf["n_routed_experts"]),
        experts_per_token=hf["num_experts_per_tok"],
        capacity_factor=float(hf["assumed"]["capacity_factor"]),
        route_scale=float(hf["routed_scaling_factor"]),
        shared_intermediate_size=(hf["moe_intermediate_size"]
                                  * hf["n_shared_experts"]),
        bias_update_rate=float(hf["assumed"]["bias_update_rate"]),
        num_dense_layers=hf["first_k_dense_replace"],
        moe_intermediate_size=hf["moe_intermediate_size"])


def _dense(cfg, layer: int) -> bool:
    return layer < cfg.num_dense_layers


def _qk(cfg) -> int:
    return cfg.qk_nope_head_dim + cfg.qk_rope_head_dim


# -- the parameters

def globals_table(cfg) -> Table:
    d = cfg.hidden_size
    out = {"embed": ((cfg.vocab_size, d), d, cfg.dtype),
           "final_norm": ((d,), 0, cfg.dtype)}
    if not cfg.tie_embeddings:
        out["lm_head"] = ((d, cfg.vocab_size), d, cfg.dtype)
    return out


def layer_table(cfg, layer: int) -> Table:
    """Latent attention and its norms in every layer; a SwiGLU of
    ``intermediate_size`` in a dense layer, else the router (float32),
    the held experts and the shared expert."""
    d, h, dt, rank = cfg.hidden_size, cfg.num_heads, cfg.dtype, \
        cfg.kv_lora_rank
    out = {
        "attn_norm": ((d,), 0, dt),
        "wq": ((d, h * _qk(cfg)), d, dt),
        "w_kv_a": ((d, rank + cfg.qk_rope_head_dim), d, dt),
        "kv_norm": ((rank,), 0, dt),
        "w_kv_b": ((rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                   rank, dt),
        "wo": ((h * cfg.v_head_dim, d), h * cfg.v_head_dim, dt),
        "mlp_norm": ((d,), 0, dt),
    }
    if _dense(cfg, layer):
        f = cfg.intermediate_size
        out.update(w_gate=((d, f), d, dt), w_up=((d, f), d, dt),
                   w_down=((f, d), f, dt))
        return out
    first, stop = afmoe._held(cfg)
    e, f, fs = stop - first, cfg.moe_intermediate_size, \
        cfg.shared_intermediate_size
    out.update({ROUTER: ((d, cfg.num_experts), d, torch.float32),
                "w_gate": ((e, d, f), d, dt), "w_up": ((e, d, f), d, dt),
                "w_down": ((e, f, d), f, dt),
                "shared_gate": ((d, fs), d, dt),
                "shared_up": ((d, fs), d, dt),
                "shared_down": ((fs, d), fs, dt)})
    return out


def program_params(cfg, seed: int, device) -> dict:
    """The port's tree: the global leaves, ``dense_layers`` and
    ``moe_layers`` with each leaf stacked over its stack's layers."""
    params = {name: weights.draw(seed, name, -1, *spec, device)
              for name, spec in globals_table(cfg).items()}
    nd = cfg.num_dense_layers
    for stack, layers in (("dense_layers", range(nd)),
                          ("moe_layers", range(nd, cfg.num_layers))):
        params[stack] = {
            name: weights.stack(seed, name, layers, spec, device)
            for name, spec in layer_table(cfg, layers[0]).items()}
    return params


program_slice = afmoe.program_slice


# -- the program

def train_program(cfg, params, opt, compile_cache=None):
    """The port's deepseek train state over ``params`` (the expert bias at
    zero) and its step at its defaults (selective remat, AdamW)."""
    from dstack_tpu_torch.models import deepseek

    state = deepseek.state_from_params(params, cfg, opt)
    if compile_cache is not None:
        for name in ("flash_fwd", "flash_bwd"):
            compile_cache.ensure(name)
    return state, deepseek.make_train_step(cfg, opt)


def engine(cfg, params, settings, device, compile_cache=None):
    raise NotImplementedError("serving latent attention (a latent paged "
                              "cache) is not ported")


SERVE_RANGES = ()


# -- the routing the reference follows

route_tap = afmoe.route_tap


def served_routes(cfg, calls, device):
    return False


def replayed_routes(cfg, routes):
    return False


# -- the plain reference

def ref_embed(cfg, g, ids):
    return g["embed"][ids]


def ref_embed_grads(cfg, g, ids, dout) -> Dict[str, torch.Tensor]:
    g_embed = torch.zeros_like(g["embed"])
    g_embed.index_add_(0, ids.reshape(-1), dout.reshape(ids.numel(), -1))
    return {"embed": g_embed}


def ref_head(cfg, g, x, mm):
    h = model.rms_norm(x, g["final_norm"], cfg.rms_eps)
    return mm(h.reshape(-1, h.shape[-1]), g["lm_head"])


def rope_interleave(x, theta: float):
    """x [n, h, d] at positions 0..n-1 as DeepSeek's modelling code turns
    it with ``rope_interleave``: (x0, x1, x2, ..) permuted to (x0, x2, ..,
    x1, x3, ..), then rotated by split halves."""
    n, h, d = x.shape
    x = x.view(n, h, d // 2, 2).transpose(-1, -2).reshape(n, h, d)
    return model.rope(x, theta)


def _attention_block(q, k, v, first: int, scale: float):
    """Queries ``first ..`` of one row, q [n, H, dq], over that row's keys
    0 .. first + n - 1 of k [S, H, dq] and v [S, H, dv]; [n, H, dv]."""
    n = q.shape[0]
    k, v = k[:first + n].transpose(0, 1), v[:first + n].transpose(0, 1)
    scores = (q.transpose(0, 1) @ k.transpose(1, 2)) * scale
    qpos = torch.arange(first, first + n, device=q.device)[:, None]
    kpos = torch.arange(first + n, device=q.device)[None, :]
    scores = scores.masked_fill(kpos > qpos, float("-inf"))
    return (torch.softmax(scores, -1) @ v).transpose(0, 1)


def attention(q, k, v, scale: float):
    """Causal attention on q, k [B, S, H, dq] and v [B, S, H, dv];
    ``ATTN_BLOCK`` queries of one row, every head at once, over the keys
    they can see, each block recomputed in the backward, so no [S, S]
    scores outlive their block.  Rows and blocks are taken by ``unbind``
    and ``split``, whose backward writes each piece's gradient once."""
    rows = []
    for q_r, k_r, v_r in zip(q.unbind(0), k.unbind(0), v.unbind(0)):
        rows.append(torch.cat([
            checkpoint(_attention_block, q_blk, k_r, v_r, i * ATTN_BLOCK,
                       scale, use_reentrant=False)
            for i, q_blk in enumerate(q_r.split(ATTN_BLOCK, dim=0))]))
    return torch.stack(rows)


def ref_layer(cfg, layer: int, x, w, mms, follow=None):
    """[B, S, D] -> (x, None, router logits or None); ``mms``: the matmul
    of every matrix but the experts', and the experts' (routed and
    shared)."""
    mm, mm_experts = mms
    b, s, _ = x.shape
    nope, rope, dv, rank = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                            cfg.v_head_dim, cfg.kv_lora_rank)
    eps, heads = cfg.rms_eps, cfg.num_heads
    h = model.rms_norm(x, w["attn_norm"], eps)
    q = mm(h, w["wq"]).view(b, s, heads, nope + rope)
    ckv = mm(h, w["w_kv_a"])
    c = model.rms_norm(ckv[..., :rank], w["kv_norm"], eps)
    kv = mm(c, w["w_kv_b"]).view(b, s, heads, nope + dv)
    k = torch.cat([kv[..., :nope],
                   ckv[:, :, None, rank:].expand(-1, -1, heads, -1)], dim=-1)
    first = nope  # q's and k's first rotated dimension
    q, k = (torch.cat([t[..., :first], torch.stack([
        rope_interleave(t[r, :, :, first:], cfg.rope_theta)
        for r in range(b)])], dim=-1) for t in (q, k))
    a = attention(q, k, kv[..., nope:], (nope + rope) ** -0.5)
    x = x + mm(a.reshape(b, s, -1), w["wo"])
    h = model.rms_norm(x, w["mlp_norm"], eps)
    logits = None
    if ROUTER in w:
        y, logits = afmoe._moe(cfg, h.reshape(b * s, -1), w, mm_experts,
                               follow)
        y = y.view(b, s, -1)
    else:
        y = afmoe._swiglu(h, w, "w_", mm)
    return x + y, None, logits


def ref_aux_weight(cfg) -> float:
    return 0.0


def ref_serve_layer(cfg, layer: int, x, w, route=None):
    raise NotImplementedError("no served deepseek_v3 cell")


int8_control = afmoe.int8_control


# -- the yardsticks

def causal_pairs(batch: int, heads: int, seq: int) -> int:
    """(query, key) pairs the causal mask keeps over every head and row."""
    return batch * heads * seq * (seq + 1) // 2


def active_params(cfg) -> int:
    """Weights a token multiplies: latent attention in every layer (Wq,
    W_kv_a, W_kv_b, Wo), the dense MLP, the router, the shared expert
    and, of the held experts, what a token's k choices of the router's
    experts land on (k * held / routed experts a token), and the head."""
    d, h, rank = cfg.hidden_size, cfg.num_heads, cfg.kv_lora_rank
    attn = (d * h * _qk(cfg) + d * (rank + cfg.qk_rope_head_dim)
            + rank * h * (cfg.qk_nope_head_dim + cfg.v_head_dim)
            + h * cfg.v_head_dim * d)
    dense = 3 * d * cfg.intermediate_size
    first, stop = afmoe._held(cfg)
    expert = 3 * d * cfg.moe_intermediate_size
    routed = (d * cfg.num_experts + 3 * d * cfg.shared_intermediate_size
              + expert * cfg.experts_per_token * (stop - first)
              // cfg.num_experts)
    nd = cfg.num_dense_layers
    return (cfg.num_layers * attn + nd * dense
            + (cfg.num_layers - nd) * routed + d * cfg.vocab_size)


def train_flops(cfg, batch: int, seq: int) -> int:
    """6 operations a weight a token, and attention's 8 * d_qk + 6 * d_v a
    kept (query, key) pair, head and layer (forward QK^T and PV, backward
    S and dP again, dV, dK, dQ)."""
    pairs = causal_pairs(batch, cfg.num_heads, seq) * cfg.num_layers
    return (6 * active_params(cfg) * batch * seq
            + (8 * _qk(cfg) + 6 * cfg.v_head_dim) * pairs)


def mla_bounds(batch: int, seq: int, heads: int, d_qk: int, d_v: int
               ) -> Dict[str, bounds.Bound]:
    """Least times (ms) of latent attention's K1 and K2 at one launch's
    shape, each with what bounds it.  Bytes: each input read once and each
    output written once (forward: q, k at the QK width, v at the V width
    -> o at the V width, lse; backward: q, k, v, o, do, lse -> dq, dk,
    dv).  Operations: 2 per multiply-add over the kept pairs, per head:
    forward QK^T over d_qk and PV over d_v; backward S and dP again, dV
    (d_v), dK and dQ (d_qk each)."""
    pairs = causal_pairs(batch, heads, seq)
    rows = batch * seq * heads
    qk, vo, lse = rows * d_qk * 2, rows * d_v * 2, batch * heads * seq * 4
    return {
        "fwd": bounds._least(2 * qk + 2 * vo + lse,
                             2 * (d_qk + d_v) * pairs),
        "bwd": bounds._least(4 * qk + 4 * vo + lse,
                             2 * (3 * d_qk + 2 * d_v) * pairs),
    }


def flash_least_s(cfg, batch: int, seq: int, n_fwd: int, n_bwd: int
                  ) -> float:
    """The least time of ``n_fwd`` latent K1 and ``n_bwd`` latent K2
    launches at the cell's shape."""
    least = mla_bounds(batch, seq, cfg.num_heads, _qk(cfg), cfg.v_head_dim)
    return (n_fwd * least["fwd"][0] + n_bwd * least["bwd"][0]) / 1e3
