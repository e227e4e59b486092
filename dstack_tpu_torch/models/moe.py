"""Sparse mixture-of-experts transformer (Mixtral-style).

The JAX package's ``models/moe.py`` in PyTorch: the dense stack is the
Llama one (RMSNorm, GQA attention through the fused causal kernels where
:func:`dstack_tpu_torch.ops.flash_attention.supports` says so, RoPE), and
every MLP is a top-k routed expert layer with GShard's static capacity:

- routing gives each (token, choice) its expert and its slot in that
  expert's buffer of ``C`` rows, so every shape is known before the data
  is; dispatch gathers the kept rows into the ``[E, C, D]`` buffers by
  those indices, and combine adds the gated outputs back by them (the
  reference's one-hot ``[T, E, C]`` einsums, without the tensor);
- experts are stacked ``[L, E, ...]`` (``w_gate``/``w_up`` ``[L, E, D, F]``,
  ``w_down`` ``[L, E, F, D]``) and the router is float32 ``[L, D, E]``;
- tokens over capacity are dropped (their residual stream passes through);
  ``capacity_factor`` sets the slack.

The configuration may also say (Trinity's ``afmoe``, models/afmoe.py):
the router scores by a sigmoid and chooses by the scores plus an expert
bias that the step moves by the token counts (no aux loss); a shared
expert runs on every token; and the layer holds only a range of the
routed experts (one card's share under expert parallelism): it routes
over all of them, with the capacity of the routed width, and computes
the held experts' part of the output.

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
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from dstack_tpu_torch.models import llama, train
from dstack_tpu_torch.models.llama import (LlamaConfig, Layout, Params,
                                           ShardingPolicy, output_head)
from dstack_tpu_torch.ops.loss import f32_logits
from dstack_tpu_torch.parallel import mesh as mesh_lib
from dstack_tpu_torch.parallel.collectives import (gather, psum,
                                                    reduce_scatter, sum_grad)
from dstack_tpu_torch.telemetry import spans


@dataclasses.dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    num_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balancing loss weight
    #: "softmax" (the top k of the logits, their probabilities renormalised
    #: over the k) or "sigmoid" (scores s = sigmoid(logits) in f32, the top
    #: k of s plus the expert bias, gates the chosen s over their sum
    #: + 1e-20, times ``route_scale``; no aux loss)
    score_func: str = "softmax"
    route_scale: float = 1.0
    #: ``[first, stop)``: the routed experts this card holds (None: all
    #: ``num_experts``, the router's width)
    held_experts: Optional[Tuple[int, int]] = None
    #: width of the shared SwiGLU expert every token passes (0: none)
    shared_intermediate_size: int = 0
    #: the expert bias's step a train step (0: no bias), torchtitan's
    #: aux-loss-free balancing: b += r * sign(mean(n) - n), less its mean
    bias_update_rate: float = 0.0

    def __post_init__(self):
        if self.score_func not in ("softmax", "sigmoid"):
            raise ValueError(f"score_func must be 'softmax' or 'sigmoid', "
                             f"got {self.score_func!r}")

    @property
    def held(self) -> Tuple[int, int]:
        """``[first, stop)`` of the routed experts held here."""
        return self.held_experts or (0, self.num_experts)

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


class Routing(NamedTuple):
    """What :func:`_route` decides for each of T tokens' k choices."""

    #: [T, k] long: the experts chosen, best first
    expert: torch.Tensor
    #: [T, k] long: each choice's place in its expert's buffer (counted
    #: among the choices of the experts in ``cols``; 0 elsewhere)
    slot: torch.Tensor
    #: [T, k] float32: each choice's gate, before the capacity's drops
    gate: torch.Tensor
    #: [T, k] bool: the choice is a real token's, its expert is in
    #: ``cols``, and its slot is within the capacity
    kept: torch.Tensor
    #: the load-balancing loss (0 for sigmoid scores)
    aux: torch.Tensor
    #: [E] float32: the real tokens' choices of each expert, before the
    #: capacity (the expert bias's rule reads them)
    counts: torch.Tensor


def _route(logits: torch.Tensor, k: int, capacity: int,
           token_mask: Optional[torch.Tensor] = None,
           layout: Optional[ExpertLayout] = None, *,
           score: str = "softmax", bias: Optional[torch.Tensor] = None,
           scale: float = 1.0,
           cols: Optional[Tuple[int, int]] = None) -> Routing:
    """GShard top-k routing with static capacity.

    logits: [T, E] float32.  Returns a :class:`Routing`.  ``token_mask``
    [T] (1 = real token) keeps tokens out of routing entirely: they claim
    no capacity slot and get zero output (the serving engine masks bucket
    padding so that pads cannot take real tokens' slots).

    ``score`` "softmax": the top k of the logits, gates their softmax
    probabilities renormalised over the k (Mixtral).  "sigmoid": scores
    s = sigmoid(logits), the top k of s + ``bias`` [E] (the expert bias,
    no gradient), gates the chosen s over their sum + 1e-20, times
    ``scale`` (Trinity); no aux loss.  The top k are taken
    by a stable descending sort, so that equal values go to the lower
    expert first, as ``lax.top_k`` orders them.

    Slots are counted for the experts ``cols`` = ``[first, stop)`` (None:
    all): a choice's slot depends only on the choices of its own expert,
    so a layer that holds some of the experts counts theirs alone.

    Under a mesh ``layout`` makes the routing the global batch's: the
    slots and the load-balancing means count every stripe (``logits``
    are this stripe's tokens), and the gates' gradient is summed over the
    ranks whose experts read them (:meth:`ExpertLayout.spread`)."""
    t, e = logits.shape
    if score == "softmax":
        probs = torch.softmax(logits, dim=-1)                   # [T, E]
        ranked = logits
    elif score == "sigmoid":
        probs = torch.sigmoid(logits)
        ranked = probs if bias is None else probs + bias
    else:
        raise ValueError(f"unknown score {score!r}")
    topi = torch.sort(ranked, dim=-1, descending=True,
                      stable=True).indices[:, :k]               # [T, k]
    real = None if token_mask is None else token_mask.float()

    gates = probs.gather(1, topi)                               # [T, k]
    if real is not None:
        gates = gates * real[:, None]
    if score == "softmax":
        # renormalize the k gates per token (Mixtral convention)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    else:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    if scale != 1.0:
        gates = gates * scale
    if layout is not None:
        gates = layout.spread(gates)

    # each (token, choice)'s place in its expert's buffer: the assignments
    # to its expert before it, counted in (choice-major, token-minor)
    # order so that choice 0 wins slots before choice 1 (a stable sort by
    # expert keeps that order within each expert); under a mesh the other
    # stripes' assignments come first where the global order puts them
    first, stop = (0, e) if cols is None else cols
    order_e = topi.t().reshape(-1)                              # [k*T]
    counted = (order_e >= first) & (order_e < stop)
    if real is not None:
        # masked tokens must not occupy expert slots, not merely have
        # their output dropped
        counted = counted & (real.repeat(k) > 0)
    key = torch.where(counted, order_e, e)                      # e: none
    by_key = torch.sort(key, stable=True).indices
    n_key = torch.bincount(key, minlength=e + 1)
    rank = torch.empty_like(by_key).scatter_(
        0, by_key, torch.arange(k * t, device=logits.device))
    slot = rank - (torch.cumsum(n_key, 0) - n_key)[key]         # [k*T]
    if layout is not None:
        choice = torch.arange(k, device=logits.device).repeat_interleave(t)
        per_choice = torch.bincount(choice * (e + 1) + key,
                                    minlength=k * (e + 1)).view(k, e + 1)
        offsets = layout.slot_offsets(per_choice[:, :e].float())
        slot = slot + F.pad(offsets, (0, 1)).long()[choice, key]
    slot = slot.view(k, t).t()                                  # [T, k]
    kept = counted.view(k, t).t() & (slot < capacity)

    flat_choices = topi.reshape(-1)
    counts = (torch.bincount(flat_choices, minlength=e).float()
              if real is None else torch.bincount(
                  flat_choices, weights=real.repeat_interleave(k),
                  minlength=e).float())

    if score != "softmax":
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    else:
        # Switch-style load-balancing loss:
        # E * sum_e(frac_tokens_e * mean_prob_e)
        top1 = F.one_hot(topi[:, 0], e).float()                 # [T, E]
        if real is not None:
            top1 = top1 * real[:, None]
        if token_mask is None and layout is None:
            frac = top1.mean(0)  # fraction routed (first choice)
            mean_prob = probs.mean(0)
        else:
            # masked means: padding must not dilute the balance statistics
            # (top1 is already zeroed for it, probs is not); under a mesh,
            # sums over the whole batch before the product
            mask = (torch.ones(t, device=logits.device) if real is None
                    else real)
            total = layout.batch_total if layout is not None else (
                lambda x: x)
            denom = total(mask.sum()).clamp_min(1.0)
            frac = total(top1.sum(0)) / denom
            mean_prob = total((probs * mask[:, None]).sum(0)) / denom
        aux = e * torch.sum(frac * mean_prob)
    return Routing(expert=topi, slot=slot, gate=gates, kept=kept, aux=aux,
                   counts=counts)


def _route_options(cfg: MoEConfig, lp: Params,
                   cols: Optional[Tuple[int, int]]) -> dict:
    """The keywords of :func:`_route` that the configuration sets beyond
    Mixtral's defaults (none for Mixtral)."""
    kw = {} if cols is None else {"cols": cols}
    if cfg.score_func != "softmax":
        kw.update(score=cfg.score_func, bias=lp.get("expert_bias"),
                  scale=cfg.route_scale)
    return kw


class _GatherRows(torch.autograd.Function):
    """``x[index]`` with rows where ``valid`` is False read as zeros; the
    backward adds each row's gradients in float32 and rounds once, as a
    one-hot product accumulates them."""

    @staticmethod
    def forward(ctx, x, index, valid):
        ctx.save_for_backward(index, valid)
        ctx.rows = x.shape[0]
        return torch.where(valid[:, None], x.index_select(0, index),
                           x.new_zeros(()))

    @staticmethod
    def backward(ctx, g):
        index, valid = ctx.saved_tensors
        gx = torch.zeros((ctx.rows, g.shape[1]), dtype=torch.float32,
                         device=g.device)
        gx.index_add_(0, index, torch.where(valid[:, None], g, 0).float())
        return gx.to(g.dtype), None, None


class _Combine(torch.autograd.Function):
    """``out [rows, D]``: each valid slot's output row ``y`` [n, D] times
    its gate ``w`` [n] (both in the model's dtype) added into its token's
    row in float32, rounded once to the dtype: the one-hot combine product
    by index.  The backward's gate gradient, each slot's row of the output
    gradient dotted with its output row, is taken as the diagonal of
    block products of :data:`_DOT_BLOCK` slots, so each dot is summed as
    a matrix product sums it (as the one-hot product's backward did)."""

    @staticmethod
    def forward(ctx, y, w, token, valid, rows):
        ctx.save_for_backward(y, w, token, valid)
        weighted = y.float() * w.float()[:, None]
        into = torch.where(valid, token, rows)  # an empty slot: a spare row
        out = torch.zeros((rows + 1, y.shape[1]), dtype=torch.float32,
                          device=y.device).index_add_(0, into, weighted)
        return out[:rows].to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        y, w, token, valid = ctx.saved_tensors
        g_rows = torch.where(valid[:, None], g.index_select(0, token),
                             g.new_zeros(()))
        dy = (g_rows.float() * w.float()[:, None]).to(y.dtype)
        n, d = y.shape
        pad = -n % _DOT_BLOCK
        a, b = (F.pad(t, (0, 0, 0, pad)).view(-1, _DOT_BLOCK, d)
                for t in (g_rows, y))
        dw = torch.bmm(a, b.transpose(1, 2)).diagonal(
            dim1=1, dim2=2).reshape(-1)[:n]
        return dy, dw.to(w.dtype), None, None, None


#: slots a block product of :class:`_Combine`'s backward takes
_DOT_BLOCK = 64


def _slots(route: Routing, first: int, stop: int, capacity: int):
    """``(token, valid, gate)`` of each slot of the held experts' buffers
    ``[(stop - first) * capacity]``: the token whose kept choice fills it,
    whether any does, and that choice's gate (0 where none)."""
    t, k = route.expert.shape
    n = (stop - first) * capacity
    held = route.kept & (route.expert >= first) & (route.expert < stop)
    index = torch.where(held, (route.expert - first) * capacity
                        + route.slot, n).reshape(-1)            # n: no slot
    dev = index.device
    owner = torch.arange(t, device=dev).repeat_interleave(k)
    token = torch.zeros(n + 1, dtype=torch.long, device=dev).scatter_(
        0, index, owner)[:n]
    valid = torch.zeros(n + 1, dtype=torch.bool, device=dev).scatter_(
        0, index, torch.ones_like(index, dtype=torch.bool))[:n]
    gate = torch.zeros(n + 1, dtype=route.gate.dtype, device=dev).scatter(
        0, index, route.gate.reshape(-1))[:n]
    return token, valid, gate


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
             layout: Optional[ExpertLayout] = None,
             stats: Optional[list] = None):
    """h: [B, S, D] normed hidden -> (out [B, S, D], aux loss scalar).

    ``capacity`` overrides the config-derived expert capacity; ``t`` (= B*S)
    makes routing dropless (the serving engine's decode passes it).
    ``token_mask`` [B, S] keeps padding out of routing (see _route).

    Dispatch gathers each kept (token, choice)'s row into its slot of the
    held experts' ``[E, C, D]`` buffers by index, and combine adds each
    slot's output, times its gate cast to ``cfg.dtype``, back into its
    token's row in float32, rounded once.  The held experts are
    ``cfg.held`` (``lp``'s expert stacks are theirs); capacity is counted
    over the routed width, ``cfg.num_experts``.  With
    ``cfg.shared_intermediate_size`` a shared SwiGLU expert (``lp``'s
    ``shared_gate``, ``shared_up``, ``shared_down``) runs on every token
    and is added to the routed output.  ``stats``, when given, gets one
    ``(counts [E], dropped)`` entry a call: the tokens' choices of each
    expert before the capacity, and the kept-out choices of the held
    experts.

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
    if not sharded:
        first, stop = cfg.held
        cols = cfg.held_experts
    elif cfg.held_experts is not None or cfg.shared_intermediate_size:
        raise NotImplementedError(
            "held experts and a shared expert are not sharded yet")
    else:
        # slots over every expert: the mesh's offsets count them all
        first, stop = ((0, cfg.num_experts) if layout.exchange
                       else layout.experts(cfg.num_experts))
        cols = None
    with spans.region("model.moe.route") as r:
        x, router = r.inputs((x, lp["router"]))
        logits = x.float() @ router
        route = r.outputs(_route(
            logits, cfg.experts_per_token, capacity,
            token_mask=None if token_mask is None else token_mask.reshape(t),
            layout=layout if sharded else None,
            **_route_options(cfg, lp, cols)))
        if stats is not None:
            stats.append((route.counts, (route.counts[first:stop]
                                         - capacity).clamp_min(0).sum()))
        token, valid, gate = _slots(route, first, stop, capacity)

    with spans.region("model.moe.dispatch") as r:
        x = r.inputs(x)
        if sharded:
            x = layout.spread(x)
        expert_in = _GatherRows.apply(x, token, valid).view(
            stop - first, capacity, d)
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
        gate, expert_out = r.inputs((gate, expert_out))
        if sharded:
            expert_out = layout.collect(expert_out)
        out = _Combine.apply(expert_out.reshape(-1, d), gate.to(cfg.dtype),
                             token, valid, t)
        if sharded:
            out = layout.combine(out)
        out = r.outputs(out)
    if cfg.shared_intermediate_size:
        with spans.region("model.moe.shared") as r:
            x, w = r.inputs((h.reshape(t, d), {name: lp[name] for name in (
                "shared_gate", "shared_up", "shared_down")}))
            shared = (F.silu(x @ w["shared_gate"]) * (x @ w["shared_up"])
                      ) @ w["shared_down"]
            out = r.outputs(out + shared)
    return out.reshape(b, s, d), route.aux


def routed_mlp(cfg: MoEConfig, layout: Layout, sides: list,
               stats: bool = False,
               bias: Optional[torch.Tensor] = None) -> Callable:
    """A routed layer's ``LayerKind.mlp``: :func:`_moe_mlp` on weights
    read through the layer's ``weight``, ``bias`` the layer's expert bias.
    Each call appends its side results to ``sides`` in layer order,
    ``(aux, counts, dropped)``, the last two None unless ``stats``; remat's
    recompute appends again, so read ``sides`` right after the forward."""
    names = ("router", "w_gate", "w_up", "w_down") + ((
        "shared_gate", "shared_up", "shared_down")
        if cfg.shared_intermediate_size else ())

    def mlp(h, weight):
        lp = {name: weight(name) for name in names}
        lp["expert_bias"] = bias
        counted = [] if stats else None
        out, aux = _moe_mlp(h, lp, cfg, layout=layout, stats=counted)
        sides.append((aux, *(counted[0] if stats else (None, None))))
        return out

    return mlp


def backbone(params: Params, tokens: torch.Tensor, cfg: MoEConfig, *,
             mesh: Any = None, policy: Optional[ShardingPolicy] = None,
             expert_axis: Optional[str] = "expert",
             remat: Union[bool, str] = False):
    """Returns (hidden [B, S, D] in ``cfg.dtype``, router aux loss: the
    layers' sum over ``num_layers``).

    The stack is :func:`llama._walk`'s, every layer
    :func:`llama._layer_fn` with the routed MLP (:func:`routed_mlp`):
    attention is :func:`flash_attention` exactly when ``supports`` holds,
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
    keep = None if llama.remat_names(remat) is None else ()
    layout, specs = Layout(None, ShardingPolicy(), cfg), None
    if mesh is not None:
        layout = _layout(mesh, policy, cfg, expert_axis)
        specs = specs_for(params, cfg, layout.policy, expert_axis)
        params = llama.map_with_specs(
            lambda sp, p: llama._local(p, sp, mesh), specs, params)
    sides: list = []
    x = llama._walk(params, tokens, cfg, layout, specs,
                    llama.LayerKind(mlp=routed_mlp(cfg, layout, sides)), keep)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for layer_aux, _, _ in sides:
        aux = aux + layer_aux
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
    layout = None
    if mesh is not None:
        policy = token_policy(policy or ShardingPolicy())
        layout = _layout(mesh, policy, cfg, expert_axis)

    def loss_fn(params, batch):
        x, aux = backbone(params, batch["tokens"][:, :-1], cfg, mesh=mesh,
                          policy=policy, expert_axis=expert_axis, remat=remat)
        loss, ce = train._head_loss(params, x, batch, cfg, layout, aux=aux,
                                    aux_weight=cfg.router_aux_weight)
        return loss, {"loss": ce, "aux_loss": aux.detach()}

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
