"""Llama-3 family: configuration, parameters, the training forward.

Parameters are a plain dictionary of tensors in the same tree and layout
as the JAX package's: stacked layer weights with a leading [L] dim (or,
after :func:`unstack_params`, a list of per-layer dicts) and matmul
weights in ``[in, out]`` layout (``x @ w``).  Keeping the layout means
:func:`params_from_jax` never transposes, and the port's math reads like
its reference line for line.  The serving engine walks the layers with a
Python loop over ``w[l]`` views; :func:`backbone` is the training forward,
whose attention is the fused causal kernel where
:func:`dstack_tpu_torch.ops.flash_attention.supports` says so.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dstack_tpu_torch.ops import flash_attention as flash
from dstack_tpu_torch.ops.attention import causal_attention
from dstack_tpu_torch.ops.loss import f32_logits
from dstack_tpu_torch.ops.rmsnorm import rms_norm
from dstack_tpu_torch.ops.rotary import RopeScaling, apply_rope, rope_frequencies

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    hidden_size: int = 4096
    intermediate_size: int = 14_336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500_000.0
    rope_scaling: Optional[RopeScaling] = None
    rms_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def llama3_70b(cls, **kw) -> "LlamaConfig":
        return cls(
            hidden_size=8192, intermediate_size=28_672, num_layers=80,
            num_heads=64, num_kv_heads=8, **kw,
        )

    @classmethod
    def llama3_8b_fit(cls, num_layers: int = 6, **kw) -> "LlamaConfig":
        """The Llama-3-8B layer geometry (hidden 4096, ffn 14336, GQA 32/8,
        head_dim 128) at a depth whose bf16 AdamW training state fits one
        card: full-depth 8B params, grads and moments alone are ~64 GB."""
        return cls(num_layers=num_layers, tie_embeddings=True, **kw)

    @classmethod
    def llama3_1b(cls, **kw) -> "LlamaConfig":
        """Llama-3.2-1B shape."""
        return cls(
            hidden_size=2048, intermediate_size=8192, num_layers=16,
            num_heads=32, num_kv_heads=8, head_dim=64, tie_embeddings=True,
            **kw,
        )

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test config: small but structurally faithful (GQA etc.)."""
        return cls(
            vocab_size=512, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=8, num_kv_heads=4, head_dim=16,
            max_seq_len=256, **kw,
        )

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def num_params(self) -> int:
        embed = self.vocab_size * self.hidden_size
        attn = self.hidden_size * self.q_dim + 2 * self.hidden_size * self.kv_dim \
            + self.q_dim * self.hidden_size
        mlp = 3 * self.hidden_size * self.intermediate_size
        norms = 2 * self.hidden_size
        head = 0 if self.tie_embeddings else embed
        return embed + head + self.num_layers * (attn + mlp + norms) + self.hidden_size


def init_params(cfg: LlamaConfig, device: Union[str, torch.device],
                generator: torch.Generator) -> Params:
    """Scaled-normal init, allocated on ``device`` from ``generator`` (which
    must live on the same device; None on the meta device, which only
    records shapes and dtypes).  Each [in, out] matrix is drawn in f32
    one layer at a time and cast into its stacked ``cfg.dtype`` buffer, so
    an 8B model never exists in f32 or on the host."""
    d, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def dense(shape, fan_in, stacked=True):
        out = torch.empty(((n,) if stacked else ()) + shape,
                          dtype=cfg.dtype, device=device)
        for part in (out if stacked else [out]):
            part.copy_(torch.randn(shape, generator=generator,
                                   dtype=torch.float32, device=device)
                       * fan_in ** -0.5)
        return out

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    params: Params = {
        "embed": dense((cfg.vocab_size, d), d, stacked=False),
        "layers": {
            "attn_norm": ones((n, d)),
            "wq": dense((d, cfg.q_dim), d),
            "wk": dense((d, cfg.kv_dim), d),
            "wv": dense((d, cfg.kv_dim), d),
            "wo": dense((cfg.q_dim, d), cfg.q_dim),
            "mlp_norm": ones((n, d)),
            "w_gate": dense((d, f), d),
            "w_up": dense((d, f), d),
            "w_down": dense((f, d), f),
        },
        "final_norm": ones((d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, cfg.vocab_size), d, stacked=False)
    return params


def output_head(params: Params, cfg: LlamaConfig):
    """[D, V] output projection.  An explicit "lm_head" entry always wins
    (untied models; also the int8 copy of a tied head that
    serving/quant.py makes); tied models use the embedding transpose."""
    if "lm_head" in params:
        return params["lm_head"]
    return params["embed"].T


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of same-shaped trees of dicts and lists."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *parts) for parts in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def unstack_params(params: Params) -> Params:
    """Stacked [L, ...] layer weights -> a list of per-layer dicts, each
    weight its own buffer (a copy).  Training takes unstacked trees: the
    backward of a ``w[l]`` view of a stacked weight allocates a whole
    [L, ...] gradient for every layer, while a per-layer weight gets its
    own gradient."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        return params
    num = tree_leaves(layers)[0].shape[0]
    out = dict(params)
    out["layers"] = [tree_map(lambda w: w[i].clone(), layers)
                     for i in range(num)]
    return out


def stack_params(params: Params) -> Params:
    """Inverse of :func:`unstack_params`."""
    layers = params["layers"]
    if not isinstance(layers, (list, tuple)):
        return params
    out = dict(params)
    out["layers"] = tree_map(lambda *ws: torch.stack(ws), *layers)
    return out


def params_from_jax(np_tree: Any, device: Union[str, torch.device],
                    dtype: torch.dtype) -> Any:
    """The JAX package's param tree, as numpy arrays, to the port's:
    stacked, or unstacked (``layers`` a list of per-layer dicts).

    The layout is kept as it is (``[L, in, out]`` matmul weights — no
    transpose).  Floating leaves become ``dtype``, with one exception: an
    MoE tree's ``"router"`` stays f32, as the reference keeps it (routing
    in ``dtype`` would pick other experts).  Integer leaves (the int8
    ``"q"`` of a quantized weight) keep their type, and the ``"s"`` scales
    of a quantized dict stay f32 (they are its dtype, not the model's)."""
    def leaf(a, key=None):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return torch.tensor(a, device=device)
        t = torch.tensor(np.asarray(a, dtype=np.float32), device=device)
        return t if key in ("s", "router") else t.to(dtype)

    def walk(node, key=None):
        if isinstance(node, dict):
            if "q" in node and "s" in node:
                return {"q": leaf(node["q"]), "s": leaf(node["s"], "s")}
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, key) for v in node]
        return leaf(node, key)

    return walk(np_tree)


# -- the training forward ----------------------------------------------------

#: remat modes: what each layer keeps for the backward.  "full" keeps only
#: the layer's input; "selective" (True) also keeps the q/k/v projections
#: and the two residual-branch outputs (the JAX package's checkpoint names
#: "qkv" and "proj"); "wide" adds the attention output and the gated MLP
#: product ("attn_out", "mlp_mid").  Everything else is recomputed.
REMAT_MODES = ("none", "full", "selective", "wide")


def remat_mode(remat) -> str:
    """The remat mode ``remat`` names (one of :data:`REMAT_MODES`)."""
    if remat is None or remat is False:
        return "none"
    if remat is True:
        return "selective"
    if isinstance(remat, str) and remat in REMAT_MODES:
        return remat
    if isinstance(remat, (tuple, list)):
        raise NotImplementedError(
            "remat as a tuple of checkpoint names is not yet ported; use "
            f"one of {REMAT_MODES}")
    raise ValueError(f"remat must be one of False/'none', True/'selective', "
                     f"'wide', 'full'; got {remat!r}")


_ckpt = functools.partial(checkpoint, use_reentrant=False,
                          preserve_rng_state=False)


def _layer_fn(cfg: LlamaConfig, positions, inv_freqs, use_flash: bool,
              remat: str):
    """One transformer layer ``(x, lp) -> x`` under the remat mode.  The
    partial modes checkpoint the pieces between the kept tensors, so the
    backward recomputes exactly what the JAX policy recomputes."""

    def qkv(x, lp):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        bb, s = h.shape[:2]
        return ((h @ lp["wq"]).reshape(bb, s, cfg.num_heads, cfg.head_dim),
                (h @ lp["wk"]).reshape(bb, s, cfg.num_kv_heads, cfg.head_dim),
                (h @ lp["wv"]).reshape(bb, s, cfg.num_kv_heads, cfg.head_dim))

    def attend(q, k, v):
        q = apply_rope(q, positions, inv_freqs)
        k = apply_rope(k, positions, inv_freqs)
        if use_flash:
            out = flash.flash_attention(q, k, v)
        else:
            out = causal_attention(q, k, v, q_positions=positions,
                                   kv_positions=positions)
        return out.reshape(*out.shape[:2], cfg.q_dim)

    def mlp_mid(x, lp):
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        return F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])

    def plain(x, lp):
        x = x + attend(*qkv(x, lp)) @ lp["wo"]
        return x + mlp_mid(x, lp) @ lp["w_down"]

    if remat == "none":
        return plain
    if remat == "full":
        return lambda x, lp: _ckpt(plain, x, lp)
    if remat == "selective":
        def selective(x, lp):
            q, k, v = _ckpt(qkv, x, lp)
            x = x + _ckpt(lambda *a: attend(*a) @ lp["wo"], q, k, v)
            return x + _ckpt(lambda y: mlp_mid(y, lp) @ lp["w_down"], x)
        return selective

    def wide(x, lp):
        q, k, v = _ckpt(qkv, x, lp)
        x = x + _ckpt(attend, q, k, v) @ lp["wo"]
        return x + _ckpt(mlp_mid, x, lp) @ lp["w_down"]
    return wide


def backbone(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, *,
             mesh: Any = None, policy: Any = None,
             positions: Optional[torch.Tensor] = None,
             remat: Union[bool, str] = False) -> torch.Tensor:
    """Transformer stack up to and including the final norm: [B, S, D]
    hidden states in ``cfg.dtype``.

    Single device only: a ``mesh`` or sharding ``policy`` raises "not yet
    ported".  Attention is :func:`flash_attention` exactly when the JAX
    package takes its fused kernel (default positions and ``supports``),
    else :func:`causal_attention` over ``positions``.  ``remat`` is one of
    False/"none", True/"selective", "wide", "full" (see
    :data:`REMAT_MODES`).  Layers may be stacked (walked as ``w[l]``
    views) or unstacked (a list, see :func:`unstack_params`)."""
    if mesh is not None or policy is not None:
        raise NotImplementedError(
            "sharded training (mesh, ShardingPolicy: FSDP, tensor, sequence "
            "and pipeline parallelism) is not yet ported")
    mode = remat_mode(remat)
    s = tokens.shape[1]
    dev = tokens.device
    inv_freqs = torch.from_numpy(rope_frequencies(
        cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)).to(dev)
    default_positions = positions is None
    if default_positions:
        positions = torch.arange(s, device=dev)[None, :]
    use_flash = default_positions and flash.supports(
        s, cfg.head_dim, cfg.dtype, group=cfg.num_heads // cfg.num_kv_heads)
    layer = _layer_fn(cfg, positions, inv_freqs, use_flash, mode)

    x = F.embedding(tokens, params["embed"].to(cfg.dtype))
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        for lp in layers:
            x = layer(x, lp)
    else:
        for l in range(cfg.num_layers):
            x = layer(x, {k: w[l] for k, w in layers.items()})
    return rms_norm(x, params["final_norm"], cfg.rms_eps)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, *,
            mesh: Any = None, policy: Any = None,
            positions: Optional[torch.Tensor] = None,
            remat: Union[bool, str] = False) -> torch.Tensor:
    """Full-sequence forward: f32 logits [B, S, V].  Training prefers
    :func:`backbone` + :func:`dstack_tpu_torch.ops.loss.
    chunked_cross_entropy`, which never builds this tensor."""
    x = backbone(params, tokens, cfg, mesh=mesh, policy=policy,
                 positions=positions, remat=remat)
    return f32_logits(x, output_head(params, cfg))
