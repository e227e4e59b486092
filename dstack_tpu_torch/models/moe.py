"""Sparse mixture-of-experts transformer (Mixtral-style), single device.

The JAX package's ``models/moe.py`` in PyTorch: the dense stack is the
Llama one (RMSNorm, GQA attention through the fused causal kernels where
:func:`dstack_tpu_torch.ops.flash_attention.supports` says so, RoPE), and
every MLP is a top-k routed expert layer in the GShard "einsum dispatch"
form:

- routing gives a static-capacity dispatch tensor [T, E, C], so every
  shape is known before the data is;
- experts are stacked ``[L, E, ...]`` (``w_gate``/``w_up`` ``[L, E, D, F]``,
  ``w_down`` ``[L, E, F, D]``) and the router is float32 ``[L, D, E]``;
- tokens over capacity are dropped (their residual stream passes through);
  ``capacity_factor`` sets the slack.

Routing, dispatch and the expert products are plain torch, as they are
plain ``jnp`` in the reference.  Expert parallelism (an ``expert`` mesh
axis) is not ported: a ``mesh`` or ``policy`` raises "not yet ported".
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dstack_tpu_torch.models import llama, train
from dstack_tpu_torch.models.llama import LlamaConfig, Params, output_head
from dstack_tpu_torch.ops import flash_attention as flash
from dstack_tpu_torch.ops.attention import causal_attention
from dstack_tpu_torch.ops.loss import chunked_cross_entropy, f32_logits
from dstack_tpu_torch.ops.rmsnorm import rms_norm
from dstack_tpu_torch.ops.rotary import apply_rope, rope_frequencies


@dataclasses.dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    num_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balancing loss weight

    @classmethod
    def mixtral_8x7b(cls, **kw) -> "MoEConfig":
        return cls(
            hidden_size=4096, intermediate_size=14_336, num_layers=32,
            num_heads=32, num_kv_heads=8, head_dim=128,
            num_experts=8, experts_per_token=2, vocab_size=32_000,
            rope_theta=1e6, **kw,
        )

    @classmethod
    def tiny_moe(cls, **kw) -> "MoEConfig":
        """Test config: small but structurally faithful."""
        return cls(
            vocab_size=512, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=8, num_kv_heads=4, head_dim=16,
            num_experts=4, experts_per_token=2, max_seq_len=256,
            tie_embeddings=True, **kw,
        )

    def num_params(self) -> int:
        embed = self.vocab_size * self.hidden_size
        attn = self.hidden_size * self.q_dim + 2 * self.hidden_size * self.kv_dim \
            + self.q_dim * self.hidden_size
        mlp = 3 * self.hidden_size * self.intermediate_size * self.num_experts
        router = self.hidden_size * self.num_experts
        norms = 2 * self.hidden_size
        head = 0 if self.tie_embeddings else embed
        return embed + head + self.num_layers * (attn + mlp + router + norms) \
            + self.hidden_size


def init_params(cfg: MoEConfig, device: Union[str, torch.device],
                generator: Optional[torch.Generator]) -> Params:
    """Scaled-normal init on ``device`` from ``generator`` (on the same
    device; None on the meta device), in the JAX package's tree and
    layout.  Each matrix is drawn in f32 one (layer, expert) at a time and
    cast into its stacked ``cfg.dtype`` buffer; the router stays f32 (tiny,
    and routing decisions are precision-sensitive)."""
    d, f, n, e = (cfg.hidden_size, cfg.intermediate_size, cfg.num_layers,
                  cfg.num_experts)

    def dense(lead, shape, fan_in, dtype=cfg.dtype):
        out = torch.empty(lead + shape, dtype=dtype, device=device)
        for part in out.view((-1,) + shape):
            part.copy_(torch.randn(shape, generator=generator,
                                   dtype=torch.float32, device=device)
                       * fan_in ** -0.5)
        return out

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    params: Params = {
        "embed": dense((), (cfg.vocab_size, d), d),
        "layers": {
            "attn_norm": ones((n, d)),
            "wq": dense((n,), (d, cfg.q_dim), d),
            "wk": dense((n,), (d, cfg.kv_dim), d),
            "wv": dense((n,), (d, cfg.kv_dim), d),
            "wo": dense((n,), (cfg.q_dim, d), cfg.q_dim),
            "mlp_norm": ones((n, d)),
            "router": dense((n,), (d, e), d, torch.float32),
            "w_gate": dense((n, e), (d, f), d),
            "w_up": dense((n, e), (d, f), d),
            "w_down": dense((n, e), (f, d), f),
        },
        "final_norm": ones((d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((), (d, cfg.vocab_size), d)
    return params


def _route(logits: torch.Tensor, k: int, capacity: int,
           token_mask: Optional[torch.Tensor] = None):
    """GShard top-k routing with static capacity.

    logits: [T, E] float32.  Returns (dispatch [T, E, C] of 0/1 floats,
    combine [T, E, C] float32, aux_loss scalar).  ``token_mask`` [T] (1 =
    real token) keeps tokens out of routing entirely: they claim no
    capacity slot and get zero output (the serving engine masks bucket
    padding so that pads cannot take real tokens' slots).

    The top k are taken by a stable descending sort, so that equal logits
    go to the lower expert first, as ``lax.top_k`` orders them."""
    t, e = logits.shape
    probs = torch.softmax(logits, dim=-1)                       # [T, E]
    topi = torch.sort(logits, dim=-1, descending=True,
                      stable=True).indices[:, :k]               # [T, k]

    chosen = F.one_hot(topi, e).float()                         # [T, k, E]
    if token_mask is not None:
        # zero BEFORE the capacity cumsum: masked tokens must not occupy
        # expert slots, not merely have their output dropped
        chosen = chosen * token_mask.float()[:, None, None]
    gates = torch.einsum("tke,te->tk", chosen, probs)           # [T, k]
    # renormalize the k gates per token (Mixtral convention)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # each (token, choice)'s place in its expert's buffer: the assignments
    # before it, counted in (choice-major, token-minor) order so that
    # choice 0 wins slots before choice 1
    flat = chosen.transpose(0, 1).reshape(k * t, e)             # [k*T, E]
    pos = torch.cumsum(flat, dim=0) - flat
    pos = pos.reshape(k, t, e).transpose(0, 1)                  # [T, k, E]
    slot = (pos * chosen).sum(-1)                               # [T, k]
    fits = (slot < capacity).float()

    # one_hot of a slot past the capacity is all zeros in the reference;
    # clamped here, it is zeroed by ``fits`` in both products below
    slot_oh = F.one_hot(slot.long().clamp_max(capacity - 1),
                        capacity).float()                       # [T, k, C]
    # [T, E, C]: for each kept choice, a 1 at (its expert, its slot)
    dispatch = torch.einsum("tke,tkc->tec", chosen * fits[..., None],
                            slot_oh)
    combine = torch.einsum("tke,tkc->tec",
                           chosen * (gates * fits)[..., None], slot_oh)

    # Switch-style load-balancing loss: E * sum_e(frac_tokens_e * mean_prob_e)
    if token_mask is None:
        frac = chosen[:, 0, :].mean(0)  # fraction routed (first choice)
        mean_prob = probs.mean(0)
    else:
        # masked means: padding must not dilute the balance statistics
        # (chosen is already zeroed for it, probs is not)
        mask = token_mask.float()
        denom = mask.sum().clamp_min(1.0)
        frac = chosen[:, 0, :].sum(0) / denom
        mean_prob = (probs * mask[:, None]).sum(0) / denom
    aux = e * torch.sum(frac * mean_prob)
    return dispatch, combine, aux


def _expert_matmul(a: torch.Tensor, w: Any, dtype: torch.dtype):
    """[E, C, in] @ [E, in, out] per expert.  Serving-quantized weights
    ({"q": int8 [E, in, out], "s": f32 [E, out]}, serving/quant.py) take the
    product with the converted q, then the per-channel scale, as the
    reference's ``qeinsum`` does."""
    if isinstance(w, dict) and "q" in w:
        y = torch.matmul(a, w["q"].to(dtype))
        return y * w["s"][:, None, :].to(y.dtype)
    return torch.matmul(a, w)


def _moe_mlp(h: torch.Tensor, lp: Params, cfg: MoEConfig,
             capacity: Optional[int] = None,
             token_mask: Optional[torch.Tensor] = None):
    """h: [B, S, D] normed hidden -> (out [B, S, D], aux loss scalar).

    ``capacity`` overrides the config-derived expert capacity; ``t`` (= B*S)
    makes routing dropless (the serving engine's decode passes it).
    ``token_mask`` [B, S] keeps padding out of routing (see _route)."""
    b, s, d = h.shape
    t = b * s
    x = h.reshape(t, d)
    if capacity is None:
        # the reference's expression, in its order: another order can
        # round to another integer
        capacity = max(
            int(math.ceil(t * cfg.experts_per_token / cfg.num_experts
                          * cfg.capacity_factor)), 1)
    logits = x.float() @ lp["router"]
    dispatch, combine, aux = _route(
        logits, cfg.experts_per_token, capacity,
        token_mask=None if token_mask is None else token_mask.reshape(t))

    expert_in = torch.einsum("tec,td->ecd", dispatch.to(cfg.dtype), x)
    gated = F.silu(_expert_matmul(expert_in, lp["w_gate"], cfg.dtype))
    up = _expert_matmul(expert_in, lp["w_up"], cfg.dtype)
    expert_out = _expert_matmul(gated * up, lp["w_down"], cfg.dtype)
    out = torch.einsum("tec,ecd->td", combine.to(cfg.dtype), expert_out)
    return out.reshape(b, s, d), aux


_ckpt = functools.partial(checkpoint, use_reentrant=False,
                          preserve_rng_state=False)


def backbone(params: Params, tokens: torch.Tensor, cfg: MoEConfig, *,
             mesh: Any = None, policy: Any = None,
             expert_axis: Optional[str] = "expert",
             remat: Union[bool, str] = False):
    """Returns (hidden [B, S, D] in ``cfg.dtype``, router aux loss: the
    layers' sum over ``num_layers``).

    Attention is :func:`flash_attention` exactly when ``supports`` holds,
    else :func:`causal_attention`.  ``remat`` is one of
    :data:`llama.REMAT_MODES` or a tuple of checkpoint names; the MoE
    layer names no tensor for a checkpoint policy to keep, so every mode
    but "none" keeps only the layer's input and recomputes the whole layer
    in the backward, as the reference's named policies do on this layer.  ``expert_axis`` acts
    only under a mesh, which is not yet ported."""
    if mesh is not None or policy is not None:
        raise NotImplementedError(
            "sharded MoE (mesh, ShardingPolicy, expert parallelism) is not "
            "yet ported")
    keep = llama.remat_names(remat)
    b, s = tokens.shape
    dev = tokens.device
    inv_freqs = torch.from_numpy(rope_frequencies(
        cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)).to(dev)
    positions = torch.arange(s, device=dev)[None, :]
    use_flash = flash.supports(
        s, cfg.head_dim, cfg.dtype, group=cfg.num_heads // cfg.num_kv_heads)

    def layer(x, lp):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q = (h @ lp["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = (h @ lp["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = (h @ lp["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        q = apply_rope(q, positions, inv_freqs)
        k = apply_rope(k, positions, inv_freqs)
        if use_flash:
            attn = flash.flash_attention(q, k, v)
        else:
            attn = causal_attention(q, k, v, q_positions=positions,
                                    kv_positions=positions)
        x = x + attn.reshape(b, s, cfg.q_dim) @ lp["wo"]
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        moe_out, layer_aux = _moe_mlp(h, lp, cfg)
        return x + moe_out, layer_aux

    layer_fn = layer if keep is None else (
        lambda x, lp: _ckpt(layer, x, lp))
    x = F.embedding(tokens, params["embed"].to(cfg.dtype))
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    layers = params["layers"]
    if not isinstance(layers, (list, tuple)):
        # views of the stacked weights; a serving-quantized expert stack
        # ({"q", "s"}) is viewed leaf by leaf
        layers = [llama.tree_map(lambda w: w[l], layers)
                  for l in range(cfg.num_layers)]
    for lp in layers:
        x, layer_aux = layer_fn(x, lp)
        aux = aux + layer_aux
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x, aux / cfg.num_layers


def forward(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
            **kw) -> torch.Tensor:
    """Float32 logits [B, S, V] (the serving reference; training uses
    backbone + chunked CE + the aux loss)."""
    x, _aux = backbone(params, tokens, cfg, **kw)
    return f32_logits(x, output_head(params, cfg))


def make_train_step(cfg: MoEConfig, optimizer: train.AdamW, mesh: Any = None,
                    policy: Any = None, expert_axis: Optional[str] = "expert",
                    remat: Any = True) -> Callable[[train.TrainState, dict],
                                                   tuple]:
    """The train step with the router's load-balancing loss: the loss
    minimised is ``ce + router_aux_weight * aux``.  Returns ``(state,
    metrics)`` as :func:`train.make_train_step` does, the state updated in
    place; metrics {"loss": the cross entropy, "aux_loss", "step",
    "grad_norm"}."""
    train._not_ported(mesh=mesh, policy=policy)
    llama.remat_names(remat)  # reject a bad mode before the first step

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        x, aux = backbone(params, tokens[:, :-1], cfg, remat=remat)
        ce = chunked_cross_entropy(x, output_head(params, cfg),
                                   tokens[:, 1:], batch.get("mask"))
        return (ce + cfg.router_aux_weight * aux,
                {"loss": ce.detach(), "aux_loss": aux.detach()})

    return train._step_from_loss(loss_fn, optimizer)


def create_state(generator: Union[int, torch.Generator], cfg: MoEConfig,
                 optimizer: train.AdamW, mesh: Any = None, policy: Any = None,
                 expert_axis: Optional[str] = "expert",
                 unstacked: bool = False,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> train.TrainState:
    """Fresh state on ``device`` (CUDA by default, raising without a card;
    the CPU only when named), drawn from ``generator``: an int seed, or a
    ``torch.Generator`` on that device.  ``unstacked`` stores each layer's
    weights as separate buffers (see :func:`llama.unstack_params`)."""
    train._not_ported(mesh=mesh, policy=policy)
    gen = train._generator_on(generator, device)
    return train._fresh_state(init_params(cfg, gen.device, gen), optimizer,
                             unstacked)
