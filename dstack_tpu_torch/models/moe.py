"""Sparse mixture-of-experts transformer (Mixtral-style).

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
plain ``jnp`` in the reference.

Under a device mesh (:mod:`dstack_tpu_torch.parallel.mesh`) the experts
shard over the ``expert`` axis and, within an expert, the ffn shards as
the dense model's does (:func:`param_specs`).  The batch stays over the
policy's batch axes, so activations are replicated over ``expert``: each
rank routes its own rows, runs only its experts (and its ``tensor``
columns) on them, and the combine sums over ``expert`` and ``tensor``.
Routing is the global batch's, as the reference's is under ``jit``:
capacity counts every stripe's tokens, capacity slots are taken in the
global (choice, stripe, token) order, and the load-balancing statistics
are global means.

With ``expert`` among the policy's batch axes the tokens are striped over
it too, and they move to the experts instead of the experts' weights to
them: each rank forms its stripe's dispatch in the global slots, a
reduce-scatter over ``expert`` leaves each rank its experts' slots of the
whole ``expert`` group, and an all-gather brings every expert's outputs
back for the stripe's own combine (what GSPMD makes of the reference's
``P(expert, None, None)`` constraints).  The expert stacks stay sharded
over ``expert`` and their gradients are summed over the other token axes
only.

``seq`` and ``stage`` in the mesh and the policy are replicas, as in the
reference, whose MoE backbone ignores both (:func:`token_policy`): each
rank computes the whole step of its batch stripe.
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
from dstack_tpu_torch.models.llama import (LlamaConfig, Layout, Params,
                                           ShardingPolicy, output_head)
from dstack_tpu_torch.ops import flash_attention as flash
from dstack_tpu_torch.ops.attention import causal_attention
from dstack_tpu_torch.ops.loss import (chunked_cross_entropy, chunked_nll_sum,
                                       f32_logits)
from dstack_tpu_torch.ops.rmsnorm import rms_norm
from dstack_tpu_torch.ops.rotary import apply_rope, rope_frequencies
from dstack_tpu_torch.parallel import mesh as mesh_lib
from dstack_tpu_torch.parallel.collectives import (all_reduce_sum, gather,
                                                    psum, reduce_scatter,
                                                    sum_grad)
from dstack_tpu_torch.telemetry import spans


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
                generator: Optional[torch.Generator],
                block: Optional[Callable[[str, tuple], tuple]] = None
                ) -> Params:
    """Scaled-normal init on ``device`` from ``generator`` (on the same
    device; None on the meta device), in the JAX package's tree and
    layout.  Each matrix is drawn in f32 one (layer, expert) at a time and
    cast into its stacked ``cfg.dtype`` buffer; the router stays f32 (tiny,
    and routing decisions are precision-sensitive).

    ``block(name, shape)``, when given, returns the slices of leaf
    ``name`` (its stacked shape: the layer dim first, then E for an
    expert stack) that are kept, every layer among them: every matrix is
    still drawn whole, in the same order, so the kept blocks are exactly
    the unsharded init's (a rank's shards under a mesh)."""
    d, f, n, e = (cfg.hidden_size, cfg.intermediate_size, cfg.num_layers,
                  cfg.num_experts)

    def kept(name, shape, lead):
        full = tuple(slice(0, s) for s in lead + shape)
        sl = full if block is None else block(name, lead + shape)
        if sl[:len(lead)] != full[:len(lead)]:
            # param_specs shard no layer dim: stage ranks are replicas
            raise ValueError(
                f"block({name!r}) splits the layer dim; MoE keeps every "
                "layer on every rank")
        sl = sl[len(lead):]
        return sl, tuple(s.stop - s.start for s in sl)

    def dense(name, lead, shape, fan_in, dtype=cfg.dtype, experts=False):
        sl, local = kept(name, ((e,) if experts else ()) + shape, lead)
        out = torch.empty(lead + local, dtype=dtype, device=device)
        for part in (out if lead else out[None]):
            for j in range(e if experts else 1):
                m = torch.randn(shape, generator=generator,
                                dtype=torch.float32, device=device)
                if not experts:
                    part.copy_(m[sl] * fan_in ** -0.5)
                elif sl[0].start <= j < sl[0].stop:
                    part[j - sl[0].start].copy_(m[sl[1:]] * fan_in ** -0.5)
        return out

    def ones(name, lead, shape):
        return torch.ones(lead + kept(name, shape, lead)[1], dtype=cfg.dtype,
                          device=device)

    params: Params = {
        "embed": dense("embed", (), (cfg.vocab_size, d), d),
        "layers": {
            "attn_norm": ones("attn_norm", (n,), (d,)),
            "wq": dense("wq", (n,), (d, cfg.q_dim), d),
            "wk": dense("wk", (n,), (d, cfg.kv_dim), d),
            "wv": dense("wv", (n,), (d, cfg.kv_dim), d),
            "wo": dense("wo", (n,), (cfg.q_dim, d), cfg.q_dim),
            "mlp_norm": ones("mlp_norm", (n,), (d,)),
            "router": dense("router", (n,), (d, e), d, torch.float32),
            "w_gate": dense("w_gate", (n,), (d, f), d, experts=True),
            "w_up": dense("w_up", (n,), (d, f), d, experts=True),
            "w_down": dense("w_down", (n,), (f, d), f, experts=True),
        },
        "final_norm": ones("final_norm", (), (d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense("lm_head", (), (d, cfg.vocab_size), d)
    return params


def param_specs(cfg: MoEConfig, policy: ShardingPolicy = ShardingPolicy(),
                expert_axis: Optional[str] = "expert") -> Params:
    """The sharding spec of every leaf of :func:`init_params`'s tree (the
    JAX package's ``param_specs``, entry for entry): experts over
    ``expert_axis``; within an expert the ffn shards like the dense
    model's (fsdp over the contraction dim, tensor over f); the router is
    replicated over ``expert``."""
    t, fs = policy.tensor_axis, policy.fsdp_axis
    specs: Params = {
        "embed": (t, fs),
        "layers": {
            "attn_norm": (None, None),
            "wq": (None, fs, t),
            "wk": (None, fs, t),
            "wv": (None, fs, t),
            "wo": (None, t, fs),
            "mlp_norm": (None, None),
            "router": (None, fs, None),
            "w_gate": (None, expert_axis, fs, t),
            "w_up": (None, expert_axis, fs, t),
            "w_down": (None, expert_axis, t, fs),
        },
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = (fs, t)
    return specs


def specs_for(params: Params, cfg: MoEConfig, policy: ShardingPolicy,
              expert_axis: Optional[str]) -> Params:
    """:func:`param_specs` shaped as ``params`` (stacked or unstacked)."""
    specs = param_specs(cfg, policy, expert_axis)
    if isinstance(params["layers"], (list, tuple)):
        specs = llama.unstack_specs(specs, len(params["layers"]))
    return specs


def token_policy(policy: ShardingPolicy) -> ShardingPolicy:
    """``policy`` as the MoE step computes and is fed under it: without
    ``seq_axis`` and ``stage_axis``.  The reference's MoE backbone keeps
    its activations whole over both axes and shards no layer dim, so
    their ranks are replicas: each computes the whole step of its batch
    stripe, whole sequences at positions 0..S-1, and none of its
    gradients is summed over them.  A sharded MoE step's batch is
    ``rank_tokens(tokens, mesh, token_policy(policy))`` (or
    ``DataLoader.on_mesh(..., policy=token_policy(policy))``): its rows,
    every position."""
    return dataclasses.replace(policy, seq_axis=None, stage_axis=None)


class ExpertLayout(Layout):
    """:class:`Layout` of an MoE model: the expert stacks also stay
    sharded over ``expert_axis``, and the ``seq`` and ``stage`` axes are
    replicas (:func:`token_policy`).  Routing stays the global batch's
    (:meth:`slot_offsets`, :meth:`batch_total`).

    With ``expert_axis`` outside the batch axes the activations are
    replicated over it as over ``tensor``: each rank runs its own experts
    on every token routed to them, and :meth:`combine` sums the experts'
    outputs.  With it among the batch axes (:attr:`exchange`) the tokens
    move instead: each rank forms its stripe's dispatch in the global
    slots, :meth:`dispatch` sums the stripes of its ``expert`` group into
    its experts' slots, and :meth:`collect` gathers every expert's
    outputs back for the stripe's own combine; the expert stacks are
    never gathered over ``expert`` and their gradients never summed over
    it.  ``serving``: as :class:`Layout`'s (every rank routes all the
    rows, so routing is the rows' own)."""

    def __init__(self, mesh: Any, policy: ShardingPolicy, cfg: MoEConfig,
                 expert_axis: Optional[str] = None, serving: bool = False):
        super().__init__(mesh, token_policy(policy), cfg, serving)
        self.expert, self.exchange = None, False
        if mesh is None or not expert_axis or self.sizes.get(
                expert_axis, 1) == 1:
            return
        self.expert = expert_axis
        self.exchange = expert_axis in self.batch
        self.kept = (*self.kept, expert_axis)

    def _model_axes(self) -> list:
        """The axes whose ranks each compute part of the experts' output
        for the same tokens: ``tensor``, and ``expert`` unless the tokens
        move to the experts."""
        expert = None if self.exchange else self.expert
        return [a for a in (expert, self.tensor) if a is not None]

    def experts(self, num_experts: int) -> tuple:
        """``(first, stop)``: the experts this rank holds."""
        if self.expert is None:
            return 0, num_experts
        n = self.sizes[self.expert]
        if num_experts % n:
            raise ValueError(f"num_experts ({num_experts}) must divide by "
                             f"the expert mesh degree ({n})")
        per = num_experts // n
        first = self.mesh.get_local_rank(self.expert) * per
        return first, first + per

    def spread(self, x: torch.Tensor) -> torch.Tensor:
        """The identity, whose backward sums over the model axes
        (:meth:`_model_axes`): an input read by this rank's experts (and
        ffn columns) alone."""
        return sum_grad(x, self.mesh, self._model_axes())

    def combine(self, y: torch.Tensor) -> torch.Tensor:
        """The experts' outputs summed over the model axes."""
        for axis in self._model_axes():
            y = psum(y, self.mesh, axis)
        return y

    def dispatch(self, expert_in: torch.Tensor) -> torch.Tensor:
        """[E, C, D] -> [E / n, C, D]: the experts' inputs in the global
        slots of this rank's experts, summed over the stripes of its
        ``expert`` group (a token's slots are its own, so the sum fills
        each slot from the one stripe that holds its token).  The
        identity unless :attr:`exchange`."""
        if not self.exchange:
            return expert_in
        return reduce_scatter(expert_in, 0, self.mesh, self.expert)

    def collect(self, expert_out: torch.Tensor) -> torch.Tensor:
        """[E / n, C, D] -> [E, C, D]: every expert's outputs, gathered
        over ``expert`` (backward: summed over the group's stripes, each
        rank its experts'); the identity unless :attr:`exchange`."""
        if not self.exchange:
            return expert_out
        return gather(expert_out, 0, self.mesh, self.expert, reduce=True)

    def batch_total(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the batch axes (the backward passes each
        rank's gradient on: the sum is read whole by every rank)."""
        for axis in self.batch:
            x = psum(x, self.mesh, axis)
        return x

    def slot_offsets(self, counts: torch.Tensor) -> torch.Tensor:
        """[k, E] offsets that turn a stripe's own capacity slots (its
        tokens' assignments counted choice-major, token-minor) into the
        global batch's: for choice j, the earlier choices' assignments
        over the other stripes plus choice j's over the stripes before
        this one.  ``counts`` [k, E] are this stripe's assignments."""
        if not self.batch:
            return torch.zeros_like(counts)
        every = counts[None]
        for axis in reversed(self.batch):  # minor first: stripe order
            every = gather(every[None], 0, self.mesh, axis,
                           reduce=False).flatten(0, 1)
        index, _ = mesh_lib.batch_stripe(self.sizes,
                                         mesh_lib.mesh_coordinate(self.mesh),
                                         self.policy.batch_axes)
        others = every.sum(0) - counts
        earlier = torch.cumsum(others, dim=0) - others
        return earlier + every[:index].sum(0)


def _layout(mesh: Any, policy: Optional[ShardingPolicy], cfg: MoEConfig,
            expert_axis: Optional[str]) -> ExpertLayout:
    """The layout of a sharded MoE forward; the expert degree must divide
    the experts."""
    layout = ExpertLayout(mesh, policy or ShardingPolicy(), cfg, expert_axis)
    layout.experts(cfg.num_experts)  # the expert degree must divide E
    return layout


def _route(logits: torch.Tensor, k: int, capacity: int,
           token_mask: Optional[torch.Tensor] = None,
           layout: Optional[ExpertLayout] = None):
    """GShard top-k routing with static capacity.

    logits: [T, E] float32.  Returns (dispatch [T, E, C] of 0/1 floats,
    combine [T, E, C] float32, aux_loss scalar).  ``token_mask`` [T] (1 =
    real token) keeps tokens out of routing entirely: they claim no
    capacity slot and get zero output (the serving engine masks bucket
    padding so that pads cannot take real tokens' slots).

    The top k are taken by a stable descending sort, so that equal logits
    go to the lower expert first, as ``lax.top_k`` orders them.

    Under a mesh ``layout`` makes the routing the global batch's: the
    slots and the load-balancing means count every stripe (``logits``
    are this stripe's tokens), and the gates' gradient is summed over the
    ranks whose experts read them (:meth:`ExpertLayout.spread`)."""
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
    if layout is not None:
        gates = layout.spread(gates)

    # each (token, choice)'s place in its expert's buffer: the assignments
    # before it, counted in (choice-major, token-minor) order so that
    # choice 0 wins slots before choice 1; under a mesh the other stripes'
    # assignments come first where the global order puts them
    flat = chosen.transpose(0, 1).reshape(k * t, e)             # [k*T, E]
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(k, t, e)
    if layout is not None:
        pos = pos + layout.slot_offsets(chosen.sum(0))[:, None, :]
    pos = pos.transpose(0, 1)                                   # [T, k, E]
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
    if token_mask is None and layout is None:
        frac = chosen[:, 0, :].mean(0)  # fraction routed (first choice)
        mean_prob = probs.mean(0)
    else:
        # masked means: padding must not dilute the balance statistics
        # (chosen is already zeroed for it, probs is not); under a mesh,
        # sums over the whole batch before the product
        mask = (torch.ones(t, device=logits.device) if token_mask is None
                else token_mask.float())
        total = layout.batch_total if layout is not None else (lambda x: x)
        denom = total(mask.sum()).clamp_min(1.0)
        frac = total(chosen[:, 0, :].sum(0)) / denom
        mean_prob = total((probs * mask[:, None]).sum(0)) / denom
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
             token_mask: Optional[torch.Tensor] = None,
             layout: Optional[ExpertLayout] = None):
    """h: [B, S, D] normed hidden -> (out [B, S, D], aux loss scalar).

    ``capacity`` overrides the config-derived expert capacity; ``t`` (= B*S)
    makes routing dropless (the serving engine's decode passes it).
    ``token_mask`` [B, S] keeps padding out of routing (see _route).

    Under a mesh (``layout``) ``lp``'s expert stacks are this rank's
    experts (and ffn columns); the router is whole.  Routing is the
    global batch's.  With ``expert`` outside the batch axes each rank
    dispatches its rows to its own experts and the output is summed over
    ``expert`` and ``tensor``; with it among them the stripe's dispatch
    travels to the experts' ranks and their outputs back
    (:meth:`ExpertLayout.dispatch`, :meth:`ExpertLayout.collect`), and
    the output is summed over ``tensor``."""
    b, s, d = h.shape
    t = b * s
    x = h.reshape(t, d)
    sharded = layout is not None and layout.mesh is not None
    if capacity is None:
        # the reference's expression, in its order: another order can
        # round to another integer
        t_all = t * (layout.batch_count if sharded else 1)
        capacity = max(
            int(math.ceil(t_all * cfg.experts_per_token / cfg.num_experts
                          * cfg.capacity_factor)), 1)
    with spans.region("model.moe.route") as r:
        x, router = r.inputs((x, lp["router"]))
        logits = x.float() @ router
        dispatch, combine, aux = r.outputs(_route(
            logits, cfg.experts_per_token, capacity,
            token_mask=None if token_mask is None else token_mask.reshape(t),
            layout=layout if sharded else None))
    if sharded and not layout.exchange:
        first, stop = layout.experts(cfg.num_experts)
        dispatch = dispatch[:, first:stop]
        combine = combine[:, first:stop]

    with spans.region("model.moe.dispatch") as r:
        x, dispatch = r.inputs((x, dispatch))
        if sharded:
            x = layout.spread(x)
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(cfg.dtype), x)
        if sharded:
            expert_in = layout.dispatch(expert_in)
        expert_in = r.outputs(expert_in)
    with spans.region("model.moe.experts") as r:
        expert_in, w = r.inputs((expert_in, {name: lp[name] for name in (
            "w_gate", "w_up", "w_down")}))
        gated = F.silu(_expert_matmul(expert_in, w["w_gate"], cfg.dtype))
        up = _expert_matmul(expert_in, w["w_up"], cfg.dtype)
        expert_out = r.outputs(
            _expert_matmul(gated * up, w["w_down"], cfg.dtype))
    with spans.region("model.moe.combine") as r:
        combine, expert_out = r.inputs((combine, expert_out))
        if sharded:
            expert_out = layout.collect(expert_out)
        out = torch.einsum("tec,ecd->td", combine.to(cfg.dtype), expert_out)
        if sharded:
            out = layout.combine(out)
        out = r.outputs(out)
    return out.reshape(b, s, d), aux


_ckpt = functools.partial(checkpoint, use_reentrant=False,
                          preserve_rng_state=False)


def backbone(params: Params, tokens: torch.Tensor, cfg: MoEConfig, *,
             mesh: Any = None, policy: Optional[ShardingPolicy] = None,
             expert_axis: Optional[str] = "expert",
             remat: Union[bool, str] = False):
    """Returns (hidden [B, S, D] in ``cfg.dtype``, router aux loss: the
    layers' sum over ``num_layers``).

    Attention is :func:`flash_attention` exactly when ``supports`` holds,
    else :func:`causal_attention`.  ``remat`` is one of
    :data:`llama.REMAT_MODES` or a tuple of checkpoint names; the MoE
    layer names no tensor for a checkpoint policy to keep, so every mode
    but "none" keeps only the layer's input and recomputes the whole layer
    in the backward, as the reference's named policies do on this layer.

    Under a ``mesh`` the parameters are DTensors placed by
    :func:`param_specs` (or this rank's local shards), ``tokens`` are this
    rank's stripe of the global batch (its rows over the policy's batch
    axes, ``expert`` among them or not; whole sequences: see
    :func:`token_policy`), and the result is the stripe's hidden states
    and the global aux loss.  Attention runs through
    :meth:`Layout.attention` (the fused kernels on this rank's rows and
    heads, over the whole sequence) where ``supports`` holds."""
    keep = llama.remat_names(remat)
    if mesh is not None:
        layout = _layout(mesh, policy, cfg, expert_axis)
        specs = specs_for(params, cfg, layout.policy, expert_axis)
        params = llama.map_with_specs(
            lambda sp, p: llama._local(p, sp, mesh), specs, params)
    else:
        layout = Layout(None, ShardingPolicy(), cfg)
        specs = specs_for(params, cfg, ShardingPolicy(), expert_axis)
    b, s = tokens.shape
    dev = tokens.device
    inv_freqs = torch.from_numpy(rope_frequencies(
        cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)).to(dev)
    positions = torch.arange(s, device=dev)[None, :]
    use_flash = flash.supports(
        s, cfg.head_dim, cfg.dtype, group=cfg.num_heads // cfg.num_kv_heads)
    layers = params["layers"]
    stacked = not isinstance(layers, (list, tuple))
    lspecs = ({k: tuple(v[1:]) for k, v in specs["layers"].items()}
              if stacked else specs["layers"][0])

    def layer(x, lp):
        def w(name):
            return layout.weight(ws[name], lspecs[name])

        with spans.region("model.attention") as r:
            x, ws = r.inputs((x, lp))
            h = layout.enter(rms_norm(x, w("attn_norm"), cfg.rms_eps))
            q, k, v = ((h @ w(name)).reshape(b, s, -1, cfg.head_dim)
                       for name in ("wq", "wk", "wv"))
            q = apply_rope(q, positions, inv_freqs)
            k = apply_rope(k, positions, inv_freqs)
            if use_flash:
                attn = layout.attention(q, k, v)
            else:
                attn = causal_attention(q, k, v, q_positions=positions,
                                        kv_positions=positions)
            x = r.outputs(x + layout.leave(attn.reshape(b, s, -1) @ w("wo")))
        with spans.region("model.mlp") as r:
            x, ws = r.inputs((x, lp))
            h = rms_norm(x, w("mlp_norm"), cfg.rms_eps)
            experts = {name: w(name)
                       for name in ("router", "w_gate", "w_up", "w_down")}
            moe_out, layer_aux = _moe_mlp(h, experts, cfg, layout=layout)
            return r.outputs((x + moe_out, layer_aux))

    layer_fn = layer if keep is None else (
        lambda x, lp: _ckpt(layer, x, lp))
    with spans.region("model.embed") as r:
        x = r.outputs(llama._embed_lookup(
            r.inputs(params["embed"]).to(cfg.dtype), tokens, layout,
            specs["embed"]))
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    if stacked:
        layers = llama.layer_views(layers, cfg.num_layers)
    for lp in layers:
        x, layer_aux = layer_fn(x, lp)
        aux = aux + layer_aux
    with spans.region("model.head_loss") as r:
        x, norm = r.inputs((x, params["final_norm"]))
        x = r.outputs(rms_norm(x, layout.weight(norm, specs["final_norm"]),
                               cfg.rms_eps))
    return x, aux / cfg.num_layers


def forward(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
            **kw) -> torch.Tensor:
    """Float32 logits [B, S, V] (the serving reference; training uses
    backbone + chunked CE + the aux loss)."""
    x, _aux = backbone(params, tokens, cfg, **kw)
    return f32_logits(x, output_head(params, cfg))


def make_train_step(cfg: MoEConfig, optimizer: train.AdamW, mesh: Any = None,
                    policy: Optional[ShardingPolicy] = None,
                    expert_axis: Optional[str] = "expert",
                    remat: Any = True) -> Callable[[train.TrainState, dict],
                                                   tuple]:
    """The train step with the router's load-balancing loss: the loss
    minimised is ``ce + router_aux_weight * aux``.  Returns ``(state,
    metrics)`` as :func:`train.make_train_step` does, the state updated in
    place; metrics {"loss": the cross entropy, "aux_loss", "step",
    "grad_norm"}.

    Under a ``mesh`` the state is :func:`create_state`'s sharded one and
    the batch this rank's stripe of the global batch, whole sequences
    under ``seq`` too (``rank_tokens(tokens, mesh, token_policy(
    policy))``); the cross entropy is the global batch's mean, the aux
    loss the global routing's, and the gradients and their norm the
    global ones."""
    llama.remat_names(remat)  # reject a bad mode before the first step
    if mesh is not None:
        policy = token_policy(policy or ShardingPolicy())
        _layout(mesh, policy, cfg, expert_axis)

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        x, aux = backbone(params, tokens[:, :-1], cfg, mesh=mesh,
                          policy=policy, expert_axis=expert_axis, remat=remat)
        with spans.region("model.head_loss") as r:
            x, aux, outer = r.inputs((x, aux, {
                k: v for k, v in params.items() if k != "layers"}))
            head = output_head(outer, cfg, mesh, policy)
            if mesh is None:
                ce = chunked_cross_entropy(x, head, tokens[:, 1:],
                                           batch.get("mask"))
                return (r.outputs(ce + cfg.router_aux_weight * aux),
                        {"loss": ce.detach(), "aux_loss": aux.detach()})
            # this rank's share of the global mean (see
            # train.make_train_step); the aux loss is whole on every rank,
            # and its sums over the batch pass each rank's gradient on, so
            # the shares still add up
            total, count = chunked_nll_sum(x, head, tokens[:, 1:],
                                           batch.get("mask"))
            count = all_reduce_sum(count, mesh,
                                   policy.batch_axes).clamp_min(1.0)
            return r.outputs(total / count + cfg.router_aux_weight * aux), {
                "loss": all_reduce_sum(total, mesh, policy.batch_axes)
                / count,
                "aux_loss": aux.detach()}

    return train._step_from_loss(loss_fn, optimizer, sharded=mesh is not None)


def create_state(generator: Union[int, torch.Generator], cfg: MoEConfig,
                 optimizer: train.AdamW, mesh: Any = None,
                 policy: Optional[ShardingPolicy] = None,
                 expert_axis: Optional[str] = "expert",
                 unstacked: bool = False,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> train.TrainState:
    """Fresh state on ``device`` (CUDA by default, raising without a card;
    the CPU only when named), drawn from ``generator``: an int seed, or a
    ``torch.Generator`` on that device.  ``unstacked`` stores each layer's
    weights as separate buffers (see :func:`llama.unstack_params`).

    Under a ``mesh`` the state goes on the mesh's device as DTensors
    placed by :func:`param_specs`: each rank draws every matrix in turn
    and keeps its block, so it holds exactly its slice of the unsharded
    state (its experts' slice of the expert stacks, ``expert`` among the
    batch axes or not; everything, whole, over ``seq`` and ``stage``)."""
    if mesh is None:
        gen = train._generator_on(generator, device)
        return train._fresh_state(init_params(cfg, gen.device, gen),
                                  optimizer, unstacked)
    policy = policy or ShardingPolicy()
    _layout(mesh, policy, cfg, expert_axis)
    gen = train._generator_on(generator, train._mesh_device(mesh, device))
    specs = param_specs(cfg, policy, expert_axis)
    sizes, coord = mesh_lib.mesh_sizes(mesh), mesh_lib.mesh_coordinate(mesh)

    def block(name, shape):
        spec = specs[name] if name in specs else specs["layers"][name]
        return tuple(slice(a, b) for a, b in
                     mesh_lib.shard_index(spec, shape, sizes, coord))

    params = init_params(cfg, gen.device, gen, block=block)
    return train._fresh_state(params, optimizer, unstacked, sharded=(
        specs, init_params(cfg, "meta", None), mesh))
