"""The afmoe family: Arcee's Trinity (``model_type`` ``afmoe``).

Each layer's attention is windowed (``sliding_attention``: the keys fewer
than ``sliding_window`` positions behind, RoPE) or full (causal, no
positional encoding), as ``layer_types`` says; q and k are RMS-normed
over each head, the attention's output is gated by sigmoid(h @ Wg)
before ``wo``, and each residual branch is normed before and after
(sandwich norms).  The first ``num_dense_layers`` layers have a SwiGLU
MLP; the others route: sigmoid scores over the router's
``published.num_experts`` experts, the top k of the scores plus an expert
bias (no gradient; after each step it moves by ``load_balance_coeff``
times the sign of the tokens' count against the mean, torchtitan's rule,
less the move's mean), the chosen scores over their sum times
``route_scale``, GShard's static capacity; a shared SwiGLU expert beside.
The embedding is scaled by sqrt(hidden) (``mup_enabled``).  The card
holds ``num_experts`` of the router's experts (one card's share of an
expert-parallel layer): the program and the reference add the held
experts' part.

The program is the port's ``models/afmoe.py`` train step over two
stacks, ``dense_layers`` and ``moe_layers``.  The reference follows the
program's router logits and capacity, tapped in the timed path, and
chooses by its own expert bias: the route tap's follower starts it at zero
and moves it by the rule on the choices those logits and that bias give.
The router gap a reference shows counts both inputs of the choice: the
logits, and the program's bias against the reference's in moves of the
rule (``load_balance_coeff``), so a program whose bias strays from the
rule by one move reads 1.  A reference given no bias to follow (the
calibration's control and its follower) routes with none.  The protocol
is ``families/__init__.py``'s.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench import weights
from portbench.frozen import bounds
from portbench.reference import model

ROUTER = "router"
SLIDING = "sliding_attention"
#: query rows of one block of the reference's attention
ATTN_BLOCK = 1024

Table = Dict[str, Tuple[tuple, int, torch.dtype]]


def port_config(hf: Dict[str, Any]):
    """The port's ``AfmoeConfig`` of a published afmoe ``config.json``;
    raises where the port has no ``models/afmoe`` (before anything is
    built) or where a key asks for what it does not compute."""
    from dstack_tpu_torch.models.afmoe import AfmoeConfig

    want = {"hidden_act": "silu", "score_func": "sigmoid", "n_group": 1,
            "topk_group": 1, "rope_scaling": None, "route_norm": True}
    for key, value in want.items():
        if hf.get(key, value) != value:
            raise ValueError(f"{key} {hf[key]!r}: the port computes {value!r}")
    layers = hf["num_hidden_layers"]
    routed = hf.get("published", {}).get("num_experts", hf["num_experts"])
    return AfmoeConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"], num_layers=layers,
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf["num_key_value_heads"], head_dim=hf["head_dim"],
        rope_theta=float(hf["rope_theta"]), rms_eps=float(hf["rms_norm_eps"]),
        max_seq_len=hf["max_position_embeddings"],
        dtype=getattr(torch, hf.get("torch_dtype", "bfloat16")),
        tie_embeddings=bool(hf["tie_word_embeddings"]),
        num_experts=routed, held_experts=(0, hf["num_experts"]),
        experts_per_token=hf["num_experts_per_tok"],
        capacity_factor=float(hf["assumed"]["capacity_factor"]),
        route_scale=float(hf["route_scale"]),
        shared_intermediate_size=(hf["moe_intermediate_size"]
                                  * hf["num_shared_experts"]),
        bias_update_rate=float(hf["load_balance_coeff"]),
        layer_types=tuple(hf["layer_types"][:layers]),
        sliding_window=hf["sliding_window"],
        num_dense_layers=hf["num_dense_layers"],
        moe_intermediate_size=hf["moe_intermediate_size"],
        embed_scale=(math.sqrt(hf["hidden_size"]) if hf["mup_enabled"]
                     else 1.0))


def _dense(cfg, layer: int) -> bool:
    return layer < cfg.num_dense_layers


def _sliding(cfg, layer: int) -> bool:
    return cfg.layer_types[layer] == SLIDING


def _held(cfg) -> Tuple[int, int]:
    return cfg.held_experts or (0, cfg.num_experts)


# -- the parameters

def globals_table(cfg) -> Table:
    d = cfg.hidden_size
    out = {"embed": ((cfg.vocab_size, d), d, cfg.dtype),
           "final_norm": ((d,), 0, cfg.dtype)}
    if not cfg.tie_embeddings:
        out["lm_head"] = ((d, cfg.vocab_size), d, cfg.dtype)
    return out


def layer_table(cfg, layer: int) -> Table:
    """Attention with its norms and gate in every layer; a SwiGLU of
    ``intermediate_size`` in a dense layer, else the router (float32),
    the held experts and the shared expert."""
    d, dt = cfg.hidden_size, cfg.dtype
    out = {
        "attn_norm": ((d,), 0, dt),
        "wq": ((d, cfg.q_dim), d, dt),
        "wk": ((d, cfg.kv_dim), d, dt),
        "wv": ((d, cfg.kv_dim), d, dt),
        "q_norm": ((cfg.head_dim,), 0, dt),
        "k_norm": ((cfg.head_dim,), 0, dt),
        "w_attn_gate": ((d, cfg.q_dim), d, dt),
        "wo": ((cfg.q_dim, d), cfg.q_dim, dt),
        "post_attn_norm": ((d,), 0, dt),
        "mlp_norm": ((d,), 0, dt),
        "post_mlp_norm": ((d,), 0, dt),
    }
    if _dense(cfg, layer):
        f = cfg.intermediate_size
        out.update(w_gate=((d, f), d, dt), w_up=((d, f), d, dt),
                   w_down=((f, d), f, dt))
        return out
    first, stop = _held(cfg)
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


def program_slice(params, name: str, layer: int):
    if layer < 0:
        return params[name], None
    nd = len(next(iter(params["dense_layers"].values())))
    if layer < nd:
        return params["dense_layers"][name], layer
    return params["moe_layers"][name], layer - nd


# -- the program

def train_program(cfg, params, opt, compile_cache=None):
    """The port's afmoe train state over ``params`` (the expert bias at
    zero) and its step at its defaults (selective remat, AdamW)."""
    from dstack_tpu_torch.models import afmoe

    state = afmoe.state_from_params(params, cfg, opt)
    if compile_cache is not None:
        for name in ("flash_fwd", "flash_bwd"):
            compile_cache.ensure(name)
    return state, afmoe.make_train_step(cfg, opt)


def engine(cfg, params, settings, device, compile_cache=None):
    raise NotImplementedError("serving Trinity (a windowed paged decode) is "
                              "not ported")


SERVE_RANGES = ()


# -- the routing the reference follows

class RouteTap:
    """The router logits, the capacity and the expert bias of every
    ``moe._route`` call while :attr:`enabled`; the reference's own bias,
    a routed layer, moved step by step as the follower hands it out."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.enabled = False
        self.calls: List[Tuple[Any, int, Optional[Any]]] = []
        self.own: List[Optional[torch.Tensor]] = []

    def install(self, patches) -> bool:
        from dstack_tpu_torch.models import moe

        def make(route):
            def tap(logits, k, capacity, *args, **kwargs):
                if self.enabled:
                    bias = kwargs.get("bias")
                    self.calls.append((logits.detach(), int(capacity),
                                       None if bias is None
                                       else bias.detach().clone()))
                return route(logits, k, capacity, *args, **kwargs)
            return tap
        return patches.wrap(moe, "_route", make)

    def by_layer(self, calls) -> List[Optional[tuple]]:
        """A training step's calls from its first, a layer: None for a
        dense layer, else the forward's (logits, capacity, the program's
        bias, the reference's bias) (remat's second pass comes after).
        Called once a step, in order: each routed layer's own bias then
        moves by the rule on the choices this step's logits give with
        it."""
        cfg = self.cfg
        nd = cfg.num_dense_layers
        out: List[Optional[tuple]] = [None] * nd
        for i, (logits, capacity, bias) in enumerate(
                calls[:cfg.num_layers - nd]):
            if i == len(self.own):
                self.own.append(torch.zeros(cfg.num_experts,
                                            device=logits.device))
            own = self.own[i]
            out.append((logits, capacity, bias, own))
            experts = model.top_k(torch.sigmoid(logits) + own,
                                  cfg.experts_per_token)
            self.own[i] = moved_bias(cfg, own, experts)
        return out


def route_tap(cfg) -> RouteTap:
    return RouteTap(cfg)


def served_routes(cfg, calls, device):
    return False


def replayed_routes(cfg, routes):
    return False


# -- the plain reference

def ref_embed(cfg, g, ids):
    return g["embed"][ids] * cfg.embed_scale


def ref_embed_grads(cfg, g, ids, dout) -> Dict[str, torch.Tensor]:
    g_embed = torch.zeros_like(g["embed"])
    g_embed.index_add_(0, ids.reshape(-1),
                       dout.reshape(ids.numel(), -1) * cfg.embed_scale)
    return {"embed": g_embed}


def ref_head(cfg, g, x, mm):
    h = model.rms_norm(x, g["final_norm"], cfg.rms_eps)
    h = h.reshape(-1, h.shape[-1])
    return mm(h, g["lm_head"] if "lm_head" in g else g["embed"].T)


def _attention_block(q, k, v, first: int, window: Optional[int]):
    """Queries ``first ..`` of one row's kv head group, q [n, g, D], over
    keys k, v [m, D] that start at position ``first + n - m``."""
    n, m, d = q.shape[0], k.shape[0], q.shape[-1]
    scores = torch.einsum("sgd,td->gst", q, k) * d ** -0.5
    qpos = torch.arange(first, first + n, device=q.device)[:, None]
    kpos = torch.arange(first + n - m, first + n, device=q.device)[None, :]
    keep = kpos <= qpos
    if window is not None:
        keep = keep & (qpos - kpos < window)
    scores = scores.masked_fill(~keep, float("-inf"))
    return torch.einsum("gst,td->sgd", torch.softmax(scores, -1), v)


def attention(q, k, v, window: Optional[int]):
    """Causal GQA on [B, S, H, D], keys ``window`` or more positions
    behind a query masked; ``ATTN_BLOCK`` queries of one (row, kv head) at
    a time over the keys they can see, each block recomputed in the
    backward, so no [S, S] scores outlive their block."""
    from torch.utils.checkpoint import checkpoint

    b, s, hq, _ = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    rows = []
    for r in range(b):
        heads = []
        for h in range(hkv):
            parts = []
            for first in range(0, s, ATTN_BLOCK):
                stop = min(first + ATTN_BLOCK, s)
                lo = 0 if window is None else max(0, first - window + 1)
                parts.append(checkpoint(
                    _attention_block, q[r, first:stop, h * g:(h + 1) * g],
                    k[r, lo:stop, h], v[r, lo:stop, h], first, window,
                    use_reentrant=False))
            heads.append(torch.cat(parts))
        rows.append(torch.cat(heads, dim=1))
    return torch.stack(rows)


def _swiglu(x, w, prefix: str, mm, expert: Optional[int] = None):
    def m(name):
        t = w[prefix + name]
        return t if expert is None else t[expert]
    return mm(F.silu(mm(x, m("gate"))) * mm(x, m("up")), m("down"))


def moved_bias(cfg, bias, experts):
    """``bias`` [E] after a step whose choices were ``experts`` [T, k]:
    each expert's moves by ``bias_update_rate`` times the sign of its
    count against the mean count, less the moves' mean."""
    n = torch.bincount(experts.reshape(-1), minlength=cfg.num_experts)
    n = n.float()
    delta = cfg.bias_update_rate * torch.sign(n.mean() - n)
    return bias + (delta - delta.mean())


def _kept(experts, num_experts: int, capacity: int, first: int, stop: int):
    """[T, k]: the choices of experts ``[first, stop)`` within their
    capacity, slots taken choice-major, token-minor."""
    t, k = experts.shape
    chosen = (experts[..., None] == torch.arange(
        first, stop, device=experts.device)).float()            # [T, k, Eh]
    flat = chosen.transpose(0, 1).reshape(k * t, -1)
    pos = (torch.cumsum(flat, 0) - flat).reshape(k, t, -1).transpose(0, 1)
    slot = (pos * chosen).sum(-1)
    return (chosen.sum(-1) > 0) & (slot < capacity)


def _moe(cfg, h, w, mm, follow=None):
    """[T, D] -> (out, router logits as the router gap reads them): the
    held experts' part and the shared expert, each multiplied by ``mm``.
    Where a follower is given, the choice takes its logits and capacity
    and, where it hands one, the reference's bias, and the logits shown
    carry the program's bias against that one in moves of the rule (the
    module's docstring)."""
    t = h.shape[0]
    e, k = cfg.num_experts, cfg.experts_per_token
    first, stop = _held(cfg)
    capacity = max(int(math.ceil(t * k / e * cfg.capacity_factor)), 1)
    logits = h @ w[ROUTER]
    scores = torch.sigmoid(logits)
    by, shown = scores.detach(), logits.detach()
    if follow is not None:
        by = torch.sigmoid(follow[0])
        if len(follow) > 3:
            program = (torch.zeros_like(follow[3]) if follow[2] is None
                       else follow[2])
            by = by + follow[3]
            shown = shown + (program - follow[3]) / cfg.bias_update_rate
        if follow[1] is not None:
            capacity = follow[1]
    experts = model.top_k(by, k)
    kept = _kept(experts, e, capacity, first, stop)
    gates = scores.gather(1, experts)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20) * cfg.route_scale
    out = torch.zeros_like(h)
    for j in range(first, stop):
        rows, slot = ((experts == j) & kept).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        y = _swiglu(h[rows], w, "w_", mm, j - first)
        out = out.index_add(0, rows, y * gates[rows, slot, None])
    out = out + _swiglu(h, w, "shared_", mm)
    return out, shown


def ref_layer(cfg, layer: int, x, w, mms, follow=None):
    """[B, S, D] -> (x, None, router logits or None); ``mms``: the matmul
    of every matrix but the experts', and the experts' (routed and
    shared)."""
    mm, mm_experts = mms
    b, s, _ = x.shape
    hd, eps = cfg.head_dim, cfg.rms_eps
    h = model.rms_norm(x, w["attn_norm"], eps)
    q = model.rms_norm(mm(h, w["wq"]).view(b, s, -1, hd), w["q_norm"], eps)
    kk = model.rms_norm(mm(h, w["wk"]).view(b, s, -1, hd), w["k_norm"], eps)
    v = mm(h, w["wv"]).view(b, s, -1, hd)
    sliding = _sliding(cfg, layer)
    if sliding:
        q = torch.stack([model.rope(q[r], cfg.rope_theta) for r in range(b)])
        kk = torch.stack([model.rope(kk[r], cfg.rope_theta)
                          for r in range(b)])
    a = attention(q, kk, v, cfg.sliding_window if sliding else None)
    a = a.reshape(b, s, -1) * torch.sigmoid(mm(h, w["w_attn_gate"]))
    x = x + model.rms_norm(mm(a, w["wo"]), w["post_attn_norm"], eps)
    h = model.rms_norm(x, w["mlp_norm"], eps)
    logits = None
    if ROUTER in w:
        y, logits = _moe(cfg, h.reshape(b * s, -1), w, mm_experts, follow)
        y = y.view(b, s, -1)
    else:
        y = _swiglu(h, w, "w_", mm)
    return x + model.rms_norm(y, w["post_mlp_norm"], eps), None, logits


def ref_aux_weight(cfg) -> float:
    return 0.0


def ref_serve_layer(cfg, layer: int, x, w, route=None):
    raise NotImplementedError("no served afmoe cell")


def int8_control(name: str, w):
    if w.dim() < 2 or name == ROUTER:
        return w
    if name == "embed":
        return model.int8_rounded(w.T).T
    return model.int8_rounded(w)


# -- the yardsticks

def window_pairs(seq: int, window: int) -> int:
    """(query, key) pairs one head of one sequence keeps under the window:
    the sum over queries of min(i + 1, window)."""
    w = min(window, seq)
    return w * (w + 1) // 2 + (seq - w) * w


def active_params(cfg) -> int:
    """Weights a token multiplies: attention with its gate in every layer,
    the dense MLP, the router, the shared expert and, of the held experts,
    what a token's k choices of the router's experts land on (k * held /
    routed experts a token), and the head."""
    d = cfg.hidden_size
    attn = 2 * d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    dense = 3 * d * cfg.intermediate_size
    first, stop = _held(cfg)
    expert = 3 * d * cfg.moe_intermediate_size
    routed = (d * cfg.num_experts + 3 * d * cfg.shared_intermediate_size
              + expert * cfg.experts_per_token * (stop - first)
              // cfg.num_experts)
    nd = cfg.num_dense_layers
    return (cfg.num_layers * attn + nd * dense
            + (cfg.num_layers - nd) * routed + d * cfg.vocab_size)


def train_flops(cfg, batch: int, seq: int) -> int:
    """6 operations a weight a token, and attention's 14 * head_dim a
    kept (query, key) pair, head and layer: causal pairs on full layers,
    windowed ones on sliding layers."""
    pairs = sum(batch * (window_pairs(seq, cfg.sliding_window)
                         if _sliding(cfg, l) else seq * (seq + 1) // 2)
                for l in range(cfg.num_layers))
    return (6 * active_params(cfg) * batch * seq
            + 14 * cfg.head_dim * cfg.num_heads * pairs)


def window_bounds(cfg, batch: int, seq: int) -> Dict[str, bounds.Bound]:
    """Least times (ms) of the windowed forward and backward at the cell's
    shape: the causal launch's bytes (frozen ``flash_bounds``), the
    operations over the windowed pairs."""
    shape = (batch, seq, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    causal = bounds.flash_bounds(shape)
    pairs = batch * cfg.num_heads * window_pairs(seq, cfg.sliding_window)
    return {part: bounds._least(causal[part][2], mul * cfg.head_dim * pairs)
            for part, mul in (("fwd", 4), ("bwd", 10))}


def flash_window_least_s(cfg, batch: int, seq: int, n_fwd: int,
                         n_bwd: int) -> float:
    """The least time of ``n_fwd`` windowed K1 and ``n_bwd`` windowed K2
    launches at the cell's shape."""
    least = window_bounds(cfg, batch, seq)
    return (n_fwd * least["fwd"][0] + n_bwd * least["bwd"][0]) / 1e3


def flash_least_s(cfg, batch: int, seq: int, n_fwd: int, n_bwd: int
                  ) -> float:
    """A step launches its layers' attention alike, so of ``n_fwd`` and
    ``n_bwd`` launches the full layers' share is causal and the sliding
    layers' windowed."""
    causal = bounds.flash_bounds((batch, seq, cfg.num_heads,
                                  cfg.num_kv_heads, cfg.head_dim))
    sliding = sum(_sliding(cfg, l) for l in range(cfg.num_layers))
    share = sliding / cfg.num_layers
    window = flash_window_least_s(cfg, batch, seq, n_fwd, n_bwd)
    full = (n_fwd * causal["fwd"][0] + n_bwd * causal["bwd"][0]) / 1e3
    return share * window + (1 - share) * full
