"""DeepSeek-V3's block (``model_type`` ``deepseek_v3``), as Kanana-2
publishes it: multi-head latent attention with a full-rank query, a dense
lead, then sigmoid-routed experts beside a shared expert.

Attention (:class:`~dstack_tpu_torch.models.llama.Latent`): q = h Wq, each
head [``qk_nope_head_dim`` + ``qk_rope_head_dim``]; [c, k_pe] = h W_kv_a,
c [``kv_lora_rank``] RMS-normed (``kv_norm``) and expanded by W_kv_b into
each head's k_nope and v [``v_head_dim``]; k_pe, one for all heads, and
q's last ``qk_rope_head_dim`` dimensions turned by RoPE in interleaved
pairs (``rope_interleave``); attention at QK width nope + rope and V width
``v_head_dim``, scale (nope + rope)^-0.5, through the fused kernels'
latent instantiation (``mla_fwd_kernel`` / ``mla_bwd_kernel``) wherever
they take the shape.  ``head_dim`` is the rope width, as the published
config gives it (the rotary table's).

The first ``num_dense_layers`` layers (``first_k_dense_replace``) have a
SwiGLU MLP of ``intermediate_size``; the others route as Trinity's do
(:func:`dstack_tpu_torch.models.moe._moe_mlp`, ``noaux_tc`` with one
group): sigmoid scores, the top k of the scores plus an expert bias, the
chosen scores over their sum times ``route_scale``
(``routed_scaling_factor``), and a shared SwiGLU of
``shared_intermediate_size`` (``n_shared_experts`` x
``moe_intermediate_size``) on every token.  The expert bias
(``TrainState.buffers``) moves after AdamW by
:func:`dstack_tpu_torch.models.afmoe.update_expert_bias`.

The parameter tree is two stacks, ``dense_layers`` and ``moe_layers``, as
Trinity's; each layer is ``llama._layer_fn`` of its ``LayerKind`` through
the one stack walk, ``llama._walk``, and the step's loss is
``train._head_loss``.  Not ported: a mesh, serving (a latent paged
cache), a low-rank query (``q_lora_rank``), YaRN, multi-token prediction.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from dstack_tpu_torch.models import afmoe, llama, moe, train
from dstack_tpu_torch.models.llama import Params, output_head
from dstack_tpu_torch.models.moe import MoEConfig

#: the tree's layer stacks
STACKS = afmoe.STACKS


@dataclasses.dataclass(frozen=True)
class DeepseekV3Config(MoEConfig):
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    num_dense_layers: int = 1
    #: the width of each routed expert (``intermediate_size`` is the dense
    #: layers')
    moe_intermediate_size: int = 768
    score_func: str = "sigmoid"
    router_aux_weight: float = 0.0

    def __post_init__(self):
        super().__post_init__()
        if self.head_dim != self.qk_rope_head_dim:
            raise ValueError(f"head_dim ({self.head_dim}) is the rotary "
                             f"width, qk_rope_head_dim "
                             f"({self.qk_rope_head_dim})")
        if self.num_kv_heads != self.num_heads:
            raise ValueError("latent attention expands k and v for every "
                             "head: num_kv_heads must equal num_heads")
        if not 0 <= self.num_dense_layers <= self.num_layers:
            raise ValueError("num_dense_layers must be within num_layers")

    @classmethod
    def tiny(cls, **kw) -> "DeepseekV3Config":
        """Test config: one dense layer, then three routed ones; QK width
        24 (16 + 8 rotated), V width 16."""
        return cls(**{**dict(
            vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=4, num_heads=4, num_kv_heads=4, head_dim=8,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, max_seq_len=256, num_experts=8,
            experts_per_token=2, moe_intermediate_size=32,
            shared_intermediate_size=64, num_dense_layers=1,
            route_scale=2.448, bias_update_rate=0.001, rope_theta=10_000.0,
            rms_eps=1e-6), **kw})

    @classmethod
    def kanana2_30b_a3b(cls, num_layers: int = 48, **kw
                        ) -> "DeepseekV3Config":
        """kakaocorp's Kanana-2-30B-A3B as its ``config.json`` publishes it
        (the first ``num_layers`` layers): 32 heads of MLA at rank 512, one
        dense layer, 128 experts of 768 (top 6) and two shared; capacity
        factor 1.25 (the published model is dropless, the port's MoE has
        GShard's static capacity)."""
        return cls(**{**dict(
            vocab_size=128_256, hidden_size=2048, intermediate_size=6144,
            num_layers=num_layers, num_heads=32, num_kv_heads=32,
            head_dim=64, kv_lora_rank=512, qk_nope_head_dim=128,
            qk_rope_head_dim=64, v_head_dim=128, rope_theta=1e6,
            rms_eps=1e-6, max_seq_len=32_768, tie_embeddings=False,
            num_experts=128, experts_per_token=6, capacity_factor=1.25,
            moe_intermediate_size=768, shared_intermediate_size=2 * 768,
            route_scale=2.448, bias_update_rate=0.001,
            num_dense_layers=1), **kw})

    @property
    def latent(self) -> llama.Latent:
        return llama.Latent(self.kv_lora_rank, self.qk_nope_head_dim,
                            self.qk_rope_head_dim, self.v_head_dim)

    @property
    def attn_widths(self) -> tuple:
        return self.qk_nope_head_dim + self.qk_rope_head_dim, self.v_head_dim

    @property
    def num_moe_layers(self) -> int:
        return self.num_layers - self.num_dense_layers


def leaf_shapes(cfg: DeepseekV3Config, dense: bool
                ) -> Dict[str, Tuple[tuple, int, torch.dtype]]:
    """One layer's leaves: ``(shape, fan_in, dtype)`` (fan-in 0: a norm
    weight, drawn as ones)."""
    d, h, dt = cfg.hidden_size, cfg.num_heads, cfg.dtype
    qk, rank = cfg.attn_widths[0], cfg.kv_lora_rank
    out = {
        "attn_norm": ((d,), 0, dt),
        "wq": ((d, h * qk), d, dt),
        "w_kv_a": ((d, rank + cfg.qk_rope_head_dim), d, dt),
        "kv_norm": ((rank,), 0, dt),
        "w_kv_b": ((rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                   rank, dt),
        "wo": ((h * cfg.v_head_dim, d), h * cfg.v_head_dim, dt),
        "mlp_norm": ((d,), 0, dt),
    }
    if dense:
        f = cfg.intermediate_size
        out.update(w_gate=((d, f), d, dt), w_up=((d, f), d, dt),
                   w_down=((f, d), f, dt))
        return out
    first, stop = cfg.held
    e, f, fs = stop - first, cfg.moe_intermediate_size, \
        cfg.shared_intermediate_size
    out.update(router=((d, cfg.num_experts), d, torch.float32),
               w_gate=((e, d, f), d, dt), w_up=((e, d, f), d, dt),
               w_down=((e, f, d), f, dt),
               shared_gate=((d, fs), d, dt), shared_up=((d, fs), d, dt),
               shared_down=((fs, d), fs, dt))
    return out


def init_params(cfg: DeepseekV3Config, device: Union[str, torch.device],
                generator: Optional[torch.Generator]) -> Params:
    """Scaled-normal init on ``device`` from ``generator`` (None on the
    meta device), as :func:`afmoe.init_params` draws it: each matrix (an
    expert's one at a time) in f32 ~ N(0, 1 / fan_in) cast into its
    stacked buffer, norm weights ones, the router f32."""
    return afmoe.init_params(cfg, device, generator, shapes=leaf_shapes)


def backbone(params: Params, tokens: torch.Tensor, cfg: DeepseekV3Config, *,
             buffers: Optional[Params] = None,
             remat: Union[bool, str, tuple] = False,
             stats: Optional[list] = None) -> torch.Tensor:
    """The stack up to and including the final norm: [B, S, D] hidden
    states in ``cfg.dtype`` (arguments as :func:`afmoe.backbone`'s)."""
    keep = llama.remat_names(remat)
    layout = llama.Layout(None, llama.ShardingPolicy(), cfg)
    bias = None if buffers is None else buffers["expert_bias"].unbind(0)
    nd, latent = cfg.num_dense_layers, cfg.latent
    sides: list = []

    def kind(l: int) -> llama.LayerKind:
        return llama.LayerKind(latent=latent, mlp=None if l < nd else
                               moe.routed_mlp(
                                   cfg, layout, sides,
                                   stats=stats is not None,
                                   bias=None if bias is None
                                   else bias[l - nd]))

    x = llama._walk(params, tokens, cfg, layout, None, kind, keep,
                    stacks=STACKS)
    if stats is not None:
        stats.extend((counts, dropped) for _, counts, dropped in sides)
    return x


def forward(params: Params, tokens: torch.Tensor, cfg: DeepseekV3Config,
            **kw) -> torch.Tensor:
    """Float32 logits [B, S, V]."""
    from dstack_tpu_torch.ops.loss import f32_logits

    return f32_logits(backbone(params, tokens, cfg, **kw),
                      output_head(params, cfg))


def make_train_step(cfg: DeepseekV3Config, optimizer: train.AdamW,
                    remat: Union[bool, str, tuple] = True
                    ) -> Callable[[train.TrainState, dict], tuple]:
    """The train step on :func:`create_state`'s state, as
    :func:`afmoe.make_train_step`'s: the chunked cross entropy's
    gradients, AdamW in place, then the expert bias's move by
    :func:`afmoe.update_expert_bias`."""
    return afmoe.make_train_step(cfg, optimizer, remat, backbone_fn=backbone)


def state_from_params(params: Params, cfg: DeepseekV3Config,
                      optimizer: train.AdamW,
                      buffers: Optional[Params] = None) -> train.TrainState:
    """Step 0 of training ``params`` (on their device), the expert bias
    ``buffers`` (zeros when None)."""
    return afmoe.state_from_params(params, cfg, optimizer, buffers)


def create_state(generator: Union[int, torch.Generator],
                 cfg: DeepseekV3Config, optimizer: train.AdamW,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> train.TrainState:
    """Fresh state on ``device`` (CUDA unless the CPU is named) from
    ``generator`` (an int seed or a generator there)."""
    gen = train._generator_on(generator, device)
    return state_from_params(init_params(cfg, gen.device, gen), cfg,
                             optimizer)


def state_template(cfg: DeepseekV3Config, optimizer: train.AdamW
                   ) -> train.TrainState:
    """The restore target of :func:`checkpoint.restore_train_state`:
    params and the expert bias as meta tensors, ``optimizer`` as
    ``opt_state``, step 0."""
    return train.TrainState(params=init_params(cfg, "meta", None),
                            opt_state=optimizer, step=0,
                            buffers=afmoe.init_buffers(cfg, "meta"))
