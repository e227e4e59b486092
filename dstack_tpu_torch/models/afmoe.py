"""Trinity (Arcee's ``afmoe``): windowed and full attention in one stack, a
dense lead, then sigmoid-routed experts beside a shared expert.

Each layer's kind comes from ``layer_types``: a sliding-window layer
attends over the last ``sliding_window`` positions with RoPE, a full one
causally with no positional encoding.  Every layer RMS-norms q and k over
each head, gates the attention's output by sigmoid(h @ ``w_attn_gate``)
before ``wo``, and norms each residual branch before and after it
(sandwich norms).  The first ``num_dense_layers`` layers have a SwiGLU MLP
of ``intermediate_size``; the others the routed MLP of
:func:`dstack_tpu_torch.models.moe._moe_mlp`: sigmoid scores over
``num_experts`` experts of ``moe_intermediate_size``, the top k of the
scores plus an expert bias, the chosen scores renormalised times
``route_scale``, and a shared expert of ``shared_intermediate_size`` on
every token.  The embedding is scaled by ``embed_scale`` (sqrt of the
hidden size under muP).

What a new architecture supplies, this module shows (what each family
passes is listed on :class:`~dstack_tpu_torch.models.llama.LayerKind`):
its config, its parameter tree (two stacks, ``dense_layers``
``[num_dense_layers, ...]`` and ``moe_layers`` ``[num_layers -
num_dense_layers, ...]``), each layer's ``LayerKind`` (the routed MLP
:func:`~dstack_tpu_torch.models.moe.routed_mlp` with the layer's expert
bias) given to the one stack walk, ``llama._walk``, and the step: the
loss through ``train._head_loss``, AdamW through
``train._step_from_loss``, and what moves without a gradient.  Here that
is the expert bias (``TrainState.buffers`` ``{"expert_bias": f32 [L_moe,
E]}``), moved after AdamW by the step's token counts
(:func:`update_expert_bias`).

The layer may hold a range of the routed experts (``held_experts``: one
card's share under expert parallelism): it routes over all of them and
adds the held experts' part.  Not ported: a mesh, serving.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from dstack_tpu_torch.models import llama, moe, train
from dstack_tpu_torch.models.llama import Params, output_head
from dstack_tpu_torch.models.moe import MoEConfig

SLIDING, FULL = "sliding_attention", "full_attention"
#: the tree's layer stacks
STACKS = ("dense_layers", "moe_layers")


@dataclasses.dataclass(frozen=True)
class AfmoeConfig(MoEConfig):
    #: each layer's attention: "sliding_attention" or "full_attention"
    layer_types: Tuple[str, ...] = ()
    sliding_window: int = 2048
    num_dense_layers: int = 2
    #: the width of each routed expert (``intermediate_size`` is the dense
    #: layers')
    moe_intermediate_size: int = 1024
    #: the embedding's scale
    embed_scale: float = 1.0
    score_func: str = "sigmoid"
    router_aux_weight: float = 0.0

    def __post_init__(self):
        super().__post_init__()
        if len(self.layer_types) != self.num_layers or any(
                t not in (SLIDING, FULL) for t in self.layer_types):
            raise ValueError(f"layer_types must give one of {SLIDING!r}, "
                             f"{FULL!r} for each of {self.num_layers} "
                             f"layers, got {self.layer_types}")
        if not 0 <= self.num_dense_layers <= self.num_layers:
            raise ValueError("num_dense_layers must be within num_layers")

    @classmethod
    def tiny(cls, **kw) -> "AfmoeConfig":
        """Test config: one dense layer, then three routed ones; a full
        layer last."""
        return cls(**{**dict(
            vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=4, num_heads=4, num_kv_heads=2, head_dim=16,
            max_seq_len=256, num_experts=8, experts_per_token=2,
            moe_intermediate_size=32, shared_intermediate_size=32,
            num_dense_layers=1, sliding_window=32, route_scale=2.826,
            bias_update_rate=0.001, embed_scale=8.0, rope_theta=10_000.0,
            layer_types=(SLIDING, SLIDING, SLIDING, FULL)), **kw})

    @classmethod
    def trinity_mini(cls, num_layers: int = 32, **kw) -> "AfmoeConfig":
        """Arcee's Trinity-Mini as its ``config.json`` publishes it: every
        fourth layer full from layer 3, the others windowed (the first
        ``num_layers`` of that pattern), 128 experts with one shared;
        capacity factor 1.25 (the published model is dropless, the port's
        MoE has GShard's static capacity)."""
        return cls(**{**dict(
            vocab_size=200_192, hidden_size=2048, intermediate_size=6144,
            num_layers=num_layers, num_heads=32, num_kv_heads=4,
            head_dim=128, rope_theta=10_000.0, rms_eps=1e-5,
            max_seq_len=131_072, tie_embeddings=False, num_experts=128,
            experts_per_token=8, capacity_factor=1.25,
            moe_intermediate_size=1024, shared_intermediate_size=1024,
            route_scale=2.826, bias_update_rate=0.001, sliding_window=2048,
            num_dense_layers=2, embed_scale=2048 ** 0.5,
            layer_types=tuple(FULL if i % 4 == 3 else SLIDING
                              for i in range(num_layers))), **kw})

    @property
    def num_moe_layers(self) -> int:
        return self.num_layers - self.num_dense_layers

    def sliding(self, layer: int) -> bool:
        return self.layer_types[layer] == SLIDING


def leaf_shapes(cfg: AfmoeConfig, dense: bool
                ) -> Dict[str, Tuple[tuple, int, torch.dtype]]:
    """One layer's leaves: ``(shape, fan_in, dtype)`` (fan-in 0: a norm
    weight, drawn as ones)."""
    d, hd = cfg.hidden_size, cfg.head_dim
    out = {
        "attn_norm": ((d,), 0, cfg.dtype),
        "wq": ((d, cfg.q_dim), d, cfg.dtype),
        "wk": ((d, cfg.kv_dim), d, cfg.dtype),
        "wv": ((d, cfg.kv_dim), d, cfg.dtype),
        "q_norm": ((hd,), 0, cfg.dtype),
        "k_norm": ((hd,), 0, cfg.dtype),
        "w_attn_gate": ((d, cfg.q_dim), d, cfg.dtype),
        "wo": ((cfg.q_dim, d), cfg.q_dim, cfg.dtype),
        "post_attn_norm": ((d,), 0, cfg.dtype),
        "mlp_norm": ((d,), 0, cfg.dtype),
        "post_mlp_norm": ((d,), 0, cfg.dtype),
    }
    if dense:
        f = cfg.intermediate_size
        out.update(w_gate=((d, f), d, cfg.dtype), w_up=((d, f), d, cfg.dtype),
                   w_down=((f, d), f, cfg.dtype))
        return out
    first, stop = cfg.held
    e, f, fs = stop - first, cfg.moe_intermediate_size, \
        cfg.shared_intermediate_size
    out.update(router=((d, cfg.num_experts), d, torch.float32),
               w_gate=((e, d, f), d, cfg.dtype),
               w_up=((e, d, f), d, cfg.dtype),
               w_down=((e, f, d), f, cfg.dtype),
               shared_gate=((d, fs), d, cfg.dtype),
               shared_up=((d, fs), d, cfg.dtype),
               shared_down=((fs, d), fs, cfg.dtype))
    return out


def init_params(cfg: AfmoeConfig, device: Union[str, torch.device],
                generator: Optional[torch.Generator],
                shapes: Callable = leaf_shapes) -> Params:
    """Scaled-normal init on ``device`` from ``generator`` (None on the
    meta device): each matrix (an expert's one at a time) drawn in f32 ~
    N(0, 1 / fan_in) and cast into its stacked buffer, norm weights ones;
    the router stays f32.  ``shapes(cfg, dense)``: a layer's leaves (a
    family with the same two stacks gives its own)."""

    def leaf(shape, fan_in, dtype, lead=()):
        if fan_in == 0:
            return torch.ones(lead + shape, dtype=dtype, device=device)
        out = torch.empty(lead + shape, dtype=dtype, device=device)
        if generator is None:
            return out
        for part in out.view((-1,) + shape[-2:]):
            part.copy_(torch.randn(shape[-2:], generator=generator,
                                   dtype=torch.float32, device=device)
                       * fan_in ** -0.5)
        return out

    d, v = cfg.hidden_size, cfg.vocab_size
    params: Params = {"embed": leaf((v, d), d, cfg.dtype)}
    for stack, dense, n in (("dense_layers", True, cfg.num_dense_layers),
                            ("moe_layers", False, cfg.num_moe_layers)):
        params[stack] = {name: leaf(*spec, lead=(n,)) for name, spec
                         in shapes(cfg, dense).items()}
    params["final_norm"] = leaf((d,), 0, cfg.dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = leaf((d, v), d, cfg.dtype)
    return params


def init_buffers(cfg: AfmoeConfig, device: Union[str, torch.device]
                 ) -> Params:
    """The expert bias, zeros: f32 ``[L_moe, num_experts]``."""
    return {"expert_bias": torch.zeros(
        (cfg.num_moe_layers, cfg.num_experts), dtype=torch.float32,
        device=device)}


@torch.no_grad()
def update_expert_bias(bias: torch.Tensor, counts: torch.Tensor,
                       rate: float) -> None:
    """torchtitan's aux-loss-free balancing, in place: each layer's bias
    ``[E]`` moves by ``rate * sign(mean(n) - n)`` less that move's mean,
    ``n`` the step's tokens routed to each expert (``counts`` ``[L, E]``):
    an expert chosen less than the mean is raised, one chosen more is
    lowered."""
    delta = rate * torch.sign(counts.mean(-1, keepdim=True) - counts)
    bias.add_(delta - delta.mean(-1, keepdim=True))


def backbone(params: Params, tokens: torch.Tensor, cfg: AfmoeConfig, *,
             buffers: Optional[Params] = None,
             remat: Union[bool, str, tuple] = False,
             stats: Optional[list] = None) -> torch.Tensor:
    """The stack up to and including the final norm: [B, S, D] hidden
    states in ``cfg.dtype``.  ``buffers``: the expert bias (None: zero).
    ``remat`` as :func:`llama.backbone`'s (a routed MLP recomputes whole
    inside its region, as Mixtral's layer does).  ``stats``: each routed
    layer's ``(counts, dropped)`` is appended to it, in order
    (:func:`moe._moe_mlp`)."""
    keep = llama.remat_names(remat)
    layout = llama.Layout(None, llama.ShardingPolicy(), cfg)
    bias = None if buffers is None else buffers["expert_bias"].unbind(0)
    nd = cfg.num_dense_layers
    sides: list = []

    def kind(l: int) -> llama.LayerKind:
        sliding = cfg.sliding(l)
        return llama.LayerKind(
            window=cfg.sliding_window if sliding else None, rope=sliding,
            qk_norm=True, gate=True, sandwich=True,
            mlp=None if l < nd else moe.routed_mlp(
                cfg, layout, sides, stats=stats is not None,
                bias=None if bias is None else bias[l - nd]))

    x = llama._walk(params, tokens, cfg, layout, None, kind, keep,
                    stacks=STACKS, embed_scale=cfg.embed_scale)
    if stats is not None:
        stats.extend((counts, dropped) for _, counts, dropped in sides)
    return x


def forward(params: Params, tokens: torch.Tensor, cfg: AfmoeConfig,
            **kw) -> torch.Tensor:
    """Float32 logits [B, S, V]."""
    from dstack_tpu_torch.ops.loss import f32_logits

    return f32_logits(backbone(params, tokens, cfg, **kw),
                      output_head(params, cfg))


def make_train_step(cfg: AfmoeConfig, optimizer: train.AdamW,
                    remat: Union[bool, str, tuple] = True,
                    backbone_fn: Optional[Callable] = None
                    ) -> Callable[[train.TrainState, dict], tuple]:
    """The train step on :func:`create_state`'s state (batch as
    :func:`train.make_train_step`'s): the chunked cross entropy's
    gradients, AdamW in place, then the expert bias's move.  Returns
    ``(state, metrics)``: {"loss", "step", "grad_norm", "expert_tokens":
    f32 [L_moe, E] the step's choices of each expert, "dropped_tokens":
    f32 [L_moe] the held experts' choices over their capacity}.
    ``backbone_fn``: the stack (None: :func:`backbone`; a family with the
    same expert bias gives its own)."""
    llama.remat_names(remat)  # reject a bad mode before the first step
    stack = backbone if backbone_fn is None else backbone_fn

    def loss_fn(params, batch, buffers):
        stats: list = []
        x = stack(params, batch["tokens"][:, :-1], cfg, buffers=buffers,
                  remat=remat, stats=stats)
        metrics = {"expert_tokens": torch.stack([c for c, _ in stats]),
                   "dropped_tokens": torch.stack([d for _, d in stats])}
        loss, ce = train._head_loss(params, x, batch, cfg)
        return loss, {"loss": ce, **metrics}

    def after(state, metrics):
        update_expert_bias(state.buffers["expert_bias"],
                           metrics["expert_tokens"], cfg.bias_update_rate)

    return train._step_from_loss(loss_fn, optimizer, after=after)


def state_from_params(params: Params, cfg: AfmoeConfig,
                      optimizer: train.AdamW,
                      buffers: Optional[Params] = None) -> train.TrainState:
    """Step 0 of training ``params`` (on their device), the expert bias
    ``buffers`` (zeros when None)."""
    state = train._fresh_state(params, optimizer, unstacked=False)
    state.buffers = (init_buffers(cfg, params["embed"].device)
                     if buffers is None else buffers)
    return state


def create_state(generator: Union[int, torch.Generator], cfg: AfmoeConfig,
                 optimizer: train.AdamW,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> train.TrainState:
    """Fresh state on ``device`` (CUDA unless the CPU is named) from
    ``generator`` (an int seed or a generator there)."""
    gen = train._generator_on(generator, device)
    return state_from_params(init_params(cfg, gen.device, gen), cfg,
                             optimizer)


def state_template(cfg: AfmoeConfig, optimizer: train.AdamW
                   ) -> train.TrainState:
    """The restore target of :func:`checkpoint.restore_train_state` (as
    :func:`train.state_template`): params and the expert bias as meta
    tensors, ``optimizer`` as ``opt_state``, step 0."""
    return train.TrainState(params=init_params(cfg, "meta", None),
                            opt_state=optimizer, step=0,
                            buffers=init_buffers(cfg, "meta"))
