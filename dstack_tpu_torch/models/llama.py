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

Under a device mesh the parameters are DTensors placed by
:func:`param_specs` (FSDP over the contraction dim, tensor parallelism
over heads and ffn, the batch over ``dcn`` x ``data`` x ``fsdp``), and
the forward runs on each rank's shards with explicit collectives
(:mod:`dstack_tpu_torch.parallel.collectives`).  Over ``seq`` each rank
holds a stripe of the sequence and attention is ring or Ulysses
(:mod:`dstack_tpu_torch.ops.ring_attention`,
:mod:`dstack_tpu_torch.ops.ulysses`); over ``stage`` the stacked layers
run as a GPipe pipeline (:mod:`dstack_tpu_torch.parallel.pipeline`).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import _pytree
from torch.utils.checkpoint import checkpoint

from dstack_tpu_torch.ops import flash_attention as flash
from dstack_tpu_torch.ops import ulysses
from dstack_tpu_torch.ops.attention import (KVCache, causal_attention,
                                            decode_step_attention)
from dstack_tpu_torch.ops.ring_attention import ring_attention_sharded
from dstack_tpu_torch.ops.loss import f32_logits
from dstack_tpu_torch.ops.rmsnorm import rms_norm
from dstack_tpu_torch.ops.rotary import (RopeScaling, apply_rope, qk_prologue,
                                         rope_frequencies, rope_table,
                                         rotate_pairs)
from dstack_tpu_torch.parallel import collectives
from dstack_tpu_torch.parallel.pipeline import pipeline_layers
from dstack_tpu_torch.parallel.mesh import (distribute, entry_axes,
                                            mesh_sizes, placements)
from dstack_tpu_torch.telemetry import spans
from dstack_tpu_torch.utils.device import resolve_device

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

    @property
    def attn_widths(self) -> tuple:
        """(QK width, V width) of one head's attention."""
        return self.head_dim, self.head_dim

    def num_params(self) -> int:
        embed = self.vocab_size * self.hidden_size
        attn = self.hidden_size * self.q_dim + 2 * self.hidden_size * self.kv_dim \
            + self.q_dim * self.hidden_size
        mlp = 3 * self.hidden_size * self.intermediate_size
        norms = 2 * self.hidden_size
        head = 0 if self.tie_embeddings else embed
        return embed + head + self.num_layers * (attn + mlp + norms) + self.hidden_size


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """How this model maps onto the mesh axes of
    :data:`dstack_tpu_torch.parallel.mesh.AXIS_ORDER` (the JAX package's
    policy, field for field): ``seq_axis`` shards the sequence (attention
    by ``seq_scheme``), ``stage_axis`` pipelines the stacked layers in
    ``num_microbatches`` microbatches (default: the stage count)."""

    batch_axes: tuple[str, ...] = ("dcn", "data", "fsdp")
    tensor_axis: Optional[str] = "tensor"
    fsdp_axis: Optional[str] = "fsdp"
    seq_axis: Optional[str] = None
    #: context-parallel attention scheme: "ring" or "ulysses"
    seq_scheme: str = "ring"
    stage_axis: Optional[str] = None
    num_microbatches: Optional[int] = None

    def __post_init__(self):
        if self.seq_scheme not in ("ring", "ulysses"):
            raise ValueError(
                f"seq_scheme must be 'ring' or 'ulysses', got "
                f"{self.seq_scheme!r}")


def param_specs(cfg: LlamaConfig,
                policy: ShardingPolicy = ShardingPolicy()) -> Params:
    """The sharding spec of every leaf of :func:`init_params`'s tree (the
    JAX package's ``param_specs``, entry for entry): FSDP shards the
    contraction (hidden) dim, tensor parallelism the heads and the ffn,
    and the stacked layer dim goes over ``stage_axis``."""
    t, fs, st = policy.tensor_axis, policy.fsdp_axis, policy.stage_axis
    specs: Params = {
        "embed": (t, fs),
        "layers": {
            "attn_norm": (st, None),
            "wq": (st, fs, t),
            "wk": (st, fs, t),
            "wv": (st, fs, t),
            "wo": (st, t, fs),
            "mlp_norm": (st, None),
            "w_gate": (st, fs, t),
            "w_up": (st, fs, t),
            "w_down": (st, t, fs),
        },
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = (fs, t)
    return specs


def unstack_specs(specs: Params, num_layers: int) -> Params:
    """:func:`param_specs` for an unstacked tree: each layer spec without
    its leading [L] entry, once per layer."""
    per_layer = {k: tuple(v[1:]) for k, v in specs["layers"].items()}
    out = dict(specs)
    out["layers"] = [dict(per_layer) for _ in range(num_layers)]
    return out


def specs_for(params: Params, cfg: LlamaConfig,
              policy: ShardingPolicy = ShardingPolicy()) -> Params:
    """:func:`param_specs` shaped as ``params`` (stacked or unstacked)."""
    specs = param_specs(cfg, policy)
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        specs = unstack_specs(specs, len(layers))
    return specs


def map_with_specs(fn: Callable, specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree (whose leaves are spec
    tuples) and same-shaped trees of dicts and lists, in the first tree's
    structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: map_with_specs(fn, specs[k], *(t[k] for t in trees))
                for k in first}
    if isinstance(first, (list, tuple)):
        return [map_with_specs(fn, sp, *parts)
                for sp, *parts in zip(specs, *trees)]
    return fn(specs, *trees)


def init_params(cfg: LlamaConfig, device: Union[str, torch.device],
                generator: torch.Generator,
                block: Optional[Callable[[str, tuple], tuple]] = None
                ) -> Params:
    """Scaled-normal init, allocated on ``device`` from ``generator`` (which
    must live on the same device; None on the meta device, which only
    records shapes and dtypes).  Each [in, out] matrix is drawn in f32
    one layer at a time and cast into its stacked ``cfg.dtype`` buffer, so
    an 8B model never exists in f32 or on the host.

    ``block(name, shape)``, when given, returns the slices of leaf
    ``name`` (its stacked shape, the layer dim first) that are kept:
    every matrix is still drawn whole, in the same order, so the kept
    blocks are exactly the unsharded init's (a rank's shards under a
    mesh, the layers of its pipeline stage among them; see
    :func:`param_specs`)."""
    d, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def kept(name, shape):
        full = tuple(slice(0, s) for s in shape)
        sl = full if block is None else block(name, shape)
        return sl, tuple(s.stop - s.start for s in sl)

    def dense(name, shape, fan_in, stacked=True):
        sl, local = kept(name, ((n,) if stacked else ()) + shape)
        out = torch.empty(local, dtype=cfg.dtype, device=device)
        if not stacked:
            sl, out = (slice(0, 1),) + sl, out[None]
        for layer in range(n if stacked else 1):
            m = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device)
            if sl[0].start <= layer < sl[0].stop:
                out[layer - sl[0].start].copy_(m[sl[1:]] * fan_in ** -0.5)
        return out if stacked else out[0]

    def ones(name, shape, stacked=True):
        local = kept(name, ((n,) if stacked else ()) + shape)[1]
        return torch.ones(local, dtype=cfg.dtype, device=device)

    params: Params = {
        "embed": dense("embed", (cfg.vocab_size, d), d, stacked=False),
        "layers": {
            "attn_norm": ones("attn_norm", (d,)),
            "wq": dense("wq", (d, cfg.q_dim), d),
            "wk": dense("wk", (d, cfg.kv_dim), d),
            "wv": dense("wv", (d, cfg.kv_dim), d),
            "wo": dense("wo", (cfg.q_dim, d), cfg.q_dim),
            "mlp_norm": ones("mlp_norm", (d,)),
            "w_gate": dense("w_gate", (d, f), d),
            "w_up": dense("w_up", (d, f), d),
            "w_down": dense("w_down", (f, d), f),
        },
        "final_norm": ones("final_norm", (d,), stacked=False),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense("lm_head", (d, cfg.vocab_size), d,
                                  stacked=False)
    return params


def output_head(params: Params, cfg: LlamaConfig, mesh: Any = None,
                policy: Optional[ShardingPolicy] = None):
    """[D, V] output projection.  An explicit "lm_head" entry always wins
    (untied models; also the int8 copy of a tied head that
    serving/quant.py makes); tied models use the embedding transpose.

    Under a ``mesh`` the head is gathered whole on every rank (leaves may
    be DTensors or this rank's shards): the loss then runs on the rank's
    rows with the whole vocabulary, the same function as the JAX
    package's vocab-sharded logits."""
    if mesh is None:
        if "lm_head" in params:
            return params["lm_head"]
        return params["embed"].T
    layout = Layout(mesh, policy or ShardingPolicy(), cfg)
    specs = param_specs(cfg, layout.policy)
    name = "lm_head" if "lm_head" in params else "embed"
    head = layout.weight(_local(params[name], specs[name], mesh), specs[name],
                         whole=True)
    return head if name == "lm_head" else head.T


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
    weight its own buffer (a copy) and, in training, its own gradient
    (stacked weights get one stacked gradient, see :func:`layer_views`)."""
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

#: the tensors a layer can keep for its backward (the JAX package's
#: checkpoint names), in the order the layer makes them: the q/k/v
#: projections, the attention output, the two residual-branch outputs
#: (attention and MLP: both "proj"), the gated MLP product
REMAT_NAMES = ("qkv", "attn_out", "proj", "mlp_mid")
#: the named remat modes and the tensors each keeps: "full" keeps only the
#: layer's input; "selective" (True) the projections; "wide" all four
_MODE_NAMES = {"full": (), "selective": ("qkv", "proj"),
               "wide": ("qkv", "proj", "attn_out", "mlp_mid")}
REMAT_MODES = ("none",) + tuple(_MODE_NAMES)


def remat_names(remat) -> Optional[tuple]:
    """What ``remat`` keeps for the backward: None for no remat (every
    tensor autograd saves), else a tuple of :data:`REMAT_NAMES` (empty for
    "full").  ``remat`` is False/"none", True/"selective", "wide", "full"
    or a tuple of checkpoint names."""
    if remat is None or remat is False or remat == "none":
        return None
    if remat is True:
        remat = "selective"
    if isinstance(remat, str) and remat in _MODE_NAMES:
        return _MODE_NAMES[remat]
    if isinstance(remat, (tuple, list)):
        unknown = [n for n in remat if n not in REMAT_NAMES]
        if not unknown:
            return tuple(remat)
    raise ValueError(f"remat must be one of False/'none', True/'selective', "
                     f"'wide', 'full', or a tuple of {REMAT_NAMES}; "
                     f"got {remat!r}")


_ckpt = functools.partial(checkpoint, use_reentrant=False,
                          preserve_rng_state=False)


def _local(leaf, spec, mesh):
    """This rank's shard of a parameter: a DTensor's local tensor (its
    placements checked against ``spec``), or a plain tensor as given."""
    from torch.distributed.tensor import DTensor

    if not isinstance(leaf, DTensor):
        return leaf
    want = placements(spec, mesh)
    if tuple(leaf.placements) != want:
        raise ValueError(f"a parameter placed {tuple(leaf.placements)} where "
                         f"its spec {spec} places {want}")
    return leaf.to_local()


class Layout:
    """How the forward reads its weights and crosses the tensor axis.

    Without a mesh everything is the identity.  Under one, each weight is
    this rank's shard: :meth:`weight` gathers it over the batch axes it is
    sharded on (backward: a reduce-scatter) and sums its gradient over the
    batch axes it is not (the rank's rows give part of it); the tensor
    axis stays sharded (heads, ffn) and is crossed by :meth:`enter`
    (identity; backward sums over ``tensor``: a column-parallel product
    reads a replicated input) and :meth:`leave` (sum of a row-parallel
    product).  Activations are the rank's batch rows, replicated over
    ``tensor``, and under ``seq`` its stripe of the sequence: weights are
    replicated over ``seq``, so their gradients are summed over it as
    over a batch axis (:attr:`token_axes`).  Under ``stage`` the stacked
    layer dim stays sharded (each stage runs its own layers,
    :mod:`dstack_tpu_torch.parallel.pipeline`) and everything else is
    replicated.  :attr:`kept` lists the axes a weight may stay sharded
    on (a subclass adds its own).

    ``serving``: the serving engine's layout, as the JAX engine's
    unconstrained activations are placed.  Every rank holds all the rows
    (the batch axes stripe nothing), and each weight is gathered at use
    over every axis of its spec that is not kept (``fsdp``), so a rank
    keeps its shard and holds one layer's gathered weights at a time."""

    def __init__(self, mesh: Any, policy: ShardingPolicy, cfg: LlamaConfig,
                 serving: bool = False):
        self.mesh, self.policy, self.serving = mesh, policy, serving
        self.seq = self.stage = None
        if mesh is None:
            return
        self.sizes = sizes = mesh_sizes(mesh)
        self.seq, self.stage = (
            axis if axis is not None and sizes.get(axis, 1) > 1 else None
            for axis in (policy.seq_axis, policy.stage_axis))
        if self.seq and self.stage:
            # the JAX package's refusal: neither context-parallel scheme
            # has run nested in the pipeline's region
            raise NotImplementedError(
                "pipeline (stage) and context (seq) parallelism can't be "
                "combined yet; drop one of the two axes from the mesh/policy")
        self.batch = [a for a in policy.batch_axes
                      if sizes.get(a, 1) > 1 and not serving]
        t = policy.tensor_axis
        self.tensor = t if t and sizes.get(t, 1) > 1 else None
        tsize = sizes[t] if self.tensor else 1
        if cfg.num_heads % tsize or cfg.num_kv_heads % tsize:
            # the JAX package falls back to GSPMD's attention here; a
            # rank-local head split has no such fallback
            raise NotImplementedError(
                f"tensor={tsize} must divide num_heads ({cfg.num_heads}) and "
                f"num_kv_heads ({cfg.num_kv_heads})")
        if (self.seq and policy.seq_scheme == "ulysses"
                and not ulysses.supports(cfg, sizes[self.seq], tsize)):
            raise ValueError(
                f"seq_scheme='ulysses' needs num_heads ({cfg.num_heads}) "
                f"and num_kv_heads ({cfg.num_kv_heads}) divisible by seq x "
                f"tensor degree; use seq_scheme='ring' instead")
        self.batch_count = 1 if serving else math.prod(
            sizes.get(a, 1) for a in policy.batch_axes)
        self.seq_count = sizes[self.seq] if self.seq else 1
        self.stage_count = sizes[self.stage] if self.stage else 1
        self.tsize = tsize
        #: the axes the global batch's tokens are spread over: the
        #: gradient of a weight replicated over them and the loss's sums
        #: cross them
        self.token_axes = self.batch + ([self.seq] if self.seq else [])
        self.kept = (self.tensor,)

    def check_stacked(self, stacked: bool) -> None:
        """Unstacked layers under ``stage`` raise (the JAX package's
        refusal): the pipeline shards the stacked layer dim."""
        if self.stage and not stacked:
            raise NotImplementedError(
                "pipeline parallelism needs stacked [L, ...] layer weights "
                "(the stage axis shards the layer dim); don't unstack")

    def positions(self, s: int, device) -> torch.Tensor:
        """[1, s] global positions of this rank's ``s`` tokens: under
        ``seq`` rank r's stripe starts at r * s, else at 0."""
        positions = torch.arange(s, device=device)[None, :]
        if self.seq:
            positions = positions + self.mesh.get_local_rank(self.seq) * s
        return positions

    def weight(self, w: torch.Tensor, spec, whole: bool = False):
        """The weight a rank computes with: gathered over the batch axes
        (under ``serving``, over every axis not kept; and over ``tensor``
        too when ``whole``: the head before the loss, whose gradient every
        tensor rank computes whole).  A kept axis that also stripes the
        batch (an MoE's ``expert`` axis, whose tokens travel to the
        experts' ranks) stays sharded, and the gradient is not summed over
        it: each rank's block already has every stripe's share."""
        if self.mesh is None:
            return w
        gathered, held = set(), set()
        for dim, entry in enumerate(spec):
            axes = [a for a in entry_axes(entry) if self.sizes[a] > 1]
            kept = [a for a in axes
                    if (a in self.kept if self.serving else
                        a not in self.batch or a in self.kept)
                    and not (whole and a == self.tensor)]
            if axes[:len(kept)] != kept:
                raise NotImplementedError(
                    f"spec {spec}: a gathered axis is major to a kept one")
            if any(a not in self.kept for a in kept):
                raise NotImplementedError(
                    f"spec {spec}: weights sharded over {kept} are not yet "
                    "ported")
            held.update(kept)
            for a in reversed(axes[len(kept):]):
                w = collectives.gather(w, dim, self.mesh, a,
                                       reduce=a in self.batch)
                gathered.add(a)
        return collectives.sum_grad(
            w, self.mesh, [a for a in self.token_axes
                           if a not in gathered and a not in held])

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        if self.mesh is None or self.tensor is None:
            return h
        return collectives.sum_grad(h, self.mesh, [self.tensor])

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        if self.mesh is None or self.tensor is None:
            return y
        return collectives.psum(y, self.mesh, self.tensor)

    def attention(self, q, k, v, window: Optional[int] = None):
        """Causal attention of this rank's rows, heads and (under ``seq``)
        stripe: the fused kernels, whole or through
        :func:`flash.flash_attention_sharded`; under ``seq``, Ulysses or
        ring attention as the policy's ``seq_scheme`` says.  ``window``:
        a sliding window (see :func:`flash.flash_attention`), not ported
        under a mesh."""
        if self.mesh is None:
            return flash.flash_attention(q, k, v, window=window)
        if window is not None:
            raise NotImplementedError(
                "a sliding window under a device mesh is not ported")
        p = self.policy
        spec = (tuple(p.batch_axes), self.seq, p.tensor_axis, None)

        def dt(x):
            b, s, h, d = x.shape
            return distribute(x, spec, self.mesh,
                              (b * self.batch_count, s * self.seq_count,
                               h * self.tsize, d))

        kw = dict(batch_axes=p.batch_axes, head_axis=p.tensor_axis)
        if self.seq is None:
            fn = flash.flash_attention_sharded
        else:
            kw["seq_axis"] = self.seq
            fn = (ulysses.ulysses_attention_sharded
                  if p.seq_scheme == "ulysses" else ring_attention_sharded)
        return fn(self.mesh, dt(q), dt(k), dt(v), **kw).to_local()


def _embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                  layout: Layout, spec) -> torch.Tensor:
    """The token embedding.  Under a mesh with ``tensor`` > 1 the table
    keeps its vocab shard: each rank gathers the rows it holds (masked)
    and a sum over ``tensor`` fills in the rest, so only activations
    travel, never the table (the JAX package's ``_embed_lookup``)."""
    table = layout.weight(embed, spec)
    if layout.mesh is None or layout.tensor is None:
        return F.embedding(tokens, table)
    vlocal = table.shape[0]
    ids = tokens - layout.mesh.get_local_rank(layout.tensor) * vlocal
    valid = (ids >= 0) & (ids < vlocal)
    x = F.embedding(ids.clamp(0, vlocal - 1), table)
    return layout.leave(torch.where(valid[..., None], x, 0))


@dataclasses.dataclass(frozen=True)
class Latent:
    """Multi-head latent attention's widths (DeepSeek-V2/V3's MLA with a
    full-rank query): q = h Wq per head [nope + rope]; [c, k_pe] = h
    W_kv_a, c [``kv_lora_rank``] RMS-normed by ``kv_norm`` and expanded by
    W_kv_b into each head's k_nope [nope] and v [``v_head_dim``]; k_pe
    [rope] one for all heads.  RoPE turns q's and k's last ``rope``
    dimensions in interleaved pairs; attention runs at QK width nope +
    rope and V width ``v_head_dim``."""

    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def _latent_qkv(h: torch.Tensor, weight: Callable, lat: Latent,
                eps: float) -> tuple:
    """``(q, k_nope, k_pe, v)`` of the normed rows h [B, S, D]: q [B, S, H,
    nope + rope], k_nope [B, S, H, nope], k_pe [B, S, rope], v [B, S, H,
    v_head_dim]; the latent's product, norm and expansion in the
    ``model.mla.latent`` span."""
    q = (h @ weight("wq")).unflatten(-1, (-1, lat.qk_head_dim))
    with spans.region("model.mla.latent") as r:
        h, w_a, norm, w_b = r.inputs((h, weight("w_kv_a"), weight("kv_norm"),
                                      weight("w_kv_b")))
        c, k_pe = (h @ w_a).split([lat.kv_lora_rank, lat.qk_rope_head_dim],
                                  dim=-1)
        kv = (rms_norm(c, norm, eps) @ w_b).unflatten(
            -1, (-1, lat.qk_nope_head_dim + lat.v_head_dim))
        k_nope, v = kv.split([lat.qk_nope_head_dim, lat.v_head_dim], dim=-1)
        k_nope, k_pe, v = r.outputs((k_nope, k_pe, v))
    return q, k_nope, k_pe, v


def _latent_qk(q: torch.Tensor, k_nope: torch.Tensor, k_pe: torch.Tensor,
               rope: torch.Tensor, lat: Latent) -> tuple:
    """``(q, k)`` [B, S, H, nope + rope] for attention: q's last ``rope``
    dimensions and the shared k_pe turned by :func:`rotate_pairs`, k_pe
    repeated over the heads after each head's k_nope; in the
    ``model.mla.rope`` span."""
    with spans.region("model.mla.rope") as r:
        q, k_nope, k_pe = r.inputs((q, k_nope, k_pe))
        nope = lat.qk_nope_head_dim
        q = torch.cat([q[..., :nope], rotate_pairs(q[..., nope:], rope)],
                      dim=-1)
        k_pe = rotate_pairs(k_pe[:, :, None, :], rope)
        k = torch.cat([k_nope, k_pe.expand(*k_nope.shape[:3], -1)], dim=-1)
        return r.outputs((q, k))


@dataclasses.dataclass(frozen=True)
class LayerKind:
    """What one transformer layer computes beyond Llama's, each at its
    default leaving the Llama layer's operations and their order.

    - ``window``: a sliding window W (query i sees keys i - W < j <= i);
    - ``rope``: RoPE on q and k (False: no positional encoding);
    - ``qk_norm``: an RMSNorm over each head of q and of k (weights
      ``q_norm``, ``k_norm`` [head_dim]) before RoPE;
    - ``gate``: the attention's output times sigmoid(h @ ``w_attn_gate``)
      ([D, Hq * head_dim], h the normed input) before ``wo``;
    - ``sandwich``: an RMSNorm on the attention's and the MLP's outputs
      (``post_attn_norm``, ``post_mlp_norm``) before their residual adds;
    - ``mlp``: ``(h, weight) -> out``, the MLP branch's output from the
      normed rows h, ``weight(name)`` the layer's weight ``name`` as this
      rank computes with it (:meth:`Layout.weight`), in place of the
      SwiGLU through ``w_gate``, ``w_up``, ``w_down`` (None).  Such a
      routed MLP crosses the model axes itself: h comes to it without
      :meth:`Layout.enter`;
    - ``latent``: multi-head latent attention of these widths
      (:class:`Latent`; weights ``wq``, ``w_kv_a``, ``kv_norm``,
      ``w_kv_b``) in place of ``wq``, ``wk``, ``wv``: the ``qkv`` step
      makes q, k_nope, k_pe and v, the ``attn_out`` step turns and
      assembles q and k (``rope`` and ``qk_norm`` do not apply).

    What each family passes to :func:`_walk`, the one stack walk (a new
    architecture adds its config, parameter tree and specs): Llama and
    Mistral ``LayerKind()``; Mixtral ``LayerKind(mlp=moe.routed_mlp(...))``,
    its aux loss read from the routed MLP's side results; Trinity, by
    ``layer_types``, ``window`` and ``rope`` on sliding layers and neither
    on full ones, ``qk_norm``, ``gate`` and ``sandwich`` on all, and past
    the dense lead the routed MLP with the layer's expert bias; DeepSeek-V3
    (Kanana-2) ``latent`` on all, and past the dense lead the routed MLP
    with the layer's expert bias."""

    window: Optional[int] = None
    rope: bool = True
    qk_norm: bool = False
    gate: bool = False
    sandwich: bool = False
    mlp: Optional[Callable] = None
    latent: Optional[Latent] = None


def _layer_fn(cfg: LlamaConfig, positions, rope, fused: bool,
              keep: Optional[tuple], layout: Layout, specs: dict,
              kind: LayerKind = LayerKind()):
    """One transformer layer ``(x, lp) -> x``; its attention is
    :meth:`Layout.attention` when ``fused`` (the fused kernels, or ring
    or Ulysses under ``seq``), else :func:`causal_attention` over
    ``positions``.  ``rope`` is the :func:`rope_table` of ``positions``;
    q and k go through :func:`qk_prologue` (their norms and rotation).
    ``kind`` says what the layer adds to Llama's
    (:class:`LayerKind`).  The layer is five steps,
    each making one named tensor (:data:`REMAT_NAMES`); under remat the
    steps between two kept tensors run as one checkpointed region, so the
    backward recomputes exactly what the JAX policy recomputes.  The
    attention always sits in a region (its logsumexp is not a kept
    tensor); a lone product whose input is kept runs outside one, except
    under a mesh: there every region gathers its own weights, so remat
    gathers them again rather than keeping them.  The output gate's
    projection is made with q, k and v and kept with them."""

    def w(lp, name):
        return layout.weight(lp[name], specs[name])

    def qkv(st, lp):
        h = layout.enter(rms_norm(st["x"], w(lp, "attn_norm"), cfg.rms_eps))
        if kind.latent is not None:
            st["qkv"] = _latent_qkv(h, lambda name: w(lp, name), kind.latent,
                                    cfg.rms_eps)
            return
        b, s = h.shape[:2]
        st["qkv"] = tuple((h @ w(lp, name)).reshape(b, s, -1, cfg.head_dim)
                          for name in ("wq", "wk", "wv"))
        if kind.gate:
            st["gate"] = h @ w(lp, "w_attn_gate")

    def attn_out(st, lp):
        if kind.latent is not None:
            q, k_nope, k_pe, v = st.pop("qkv")
            q, k = _latent_qk(q, k_nope, k_pe, rope, kind.latent)
        else:
            q, k, v = st.pop("qkv")
            norms = ((w(lp, "q_norm"), w(lp, "k_norm")) if kind.qk_norm
                     else (None, None))
            q, k = qk_prologue(q, k, *norms, rope if kind.rope else None,
                               cfg.rms_eps)
        if fused:
            out = layout.attention(q, k, v, window=kind.window)
        else:
            out = causal_attention(q, k, v, q_positions=positions,
                                   kv_positions=positions,
                                   window=kind.window)
        st["attn"] = out.reshape(*out.shape[:2], -1)
        if kind.gate:
            st["attn"] = st["attn"] * torch.sigmoid(st.pop("gate"))

    def proj_attn(st, lp):
        y = layout.leave(st.pop("attn") @ w(lp, "wo"))
        if kind.sandwich:
            y = rms_norm(y, w(lp, "post_attn_norm"), cfg.rms_eps)
        st["x"] = st["x"] + y

    def mlp_mid(st, lp):
        h = rms_norm(st["x"], w(lp, "mlp_norm"), cfg.rms_eps)
        if kind.mlp is not None:
            st["mid"] = kind.mlp(h, lambda name: w(lp, name))
            return
        h = layout.enter(h)
        st["mid"] = F.silu(h @ w(lp, "w_gate")) * (h @ w(lp, "w_up"))

    def proj_mlp(st, lp):
        y = (st.pop("mid") if kind.mlp is not None
             else layout.leave(st.pop("mid") @ w(lp, "w_down")))
        if kind.sandwich:
            y = rms_norm(y, w(lp, "post_mlp_norm"), cfg.rms_eps)
        st["x"] = st["x"] + y

    steps = ((qkv, "qkv"), (attn_out, "attn_out"), (proj_attn, "proj"),
             (mlp_mid, "mlp_mid"), (proj_mlp, "proj"))
    span_of = {qkv: "model.attention", attn_out: "model.attention",
               proj_attn: "model.attention", mlp_mid: "model.mlp",
               proj_mlp: "model.mlp"}
    groups, cur = [], []
    for fn, name in steps:
        cur.append(fn)
        if keep is not None and name in keep:
            groups.append(tuple(cur))
            cur = []
    if cur:
        groups.append(tuple(cur))

    def run(group, st, lp):
        st = dict(st)
        for fn in group:
            # each step spans its own region: a remat region's recompute
            # reruns the spans of the steps it holds
            with spans.region(span_of[fn]) as r:
                st, lp_ = r.inputs((st, lp))
                fn(st, lp_)
                st = r.outputs(st)
        return st

    def layer(x, lp):
        st = {"x": x}
        for group in groups:
            plain = keep is None or (layout.mesh is None and group in (
                (proj_attn,), (proj_mlp,)))
            st = run(group, st, lp) if plain else _ckpt(run, group, st, lp)
        return st["x"]

    return layer


def backbone(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, *,
             mesh: Any = None, policy: Optional[ShardingPolicy] = None,
             positions: Optional[torch.Tensor] = None,
             remat: Union[bool, str, tuple] = False) -> torch.Tensor:
    """Transformer stack up to and including the final norm: [B, S, D]
    hidden states in ``cfg.dtype``; :func:`_walk` with ``LayerKind()`` in
    every layer.  ``remat`` is one of False/"none", True/"selective",
    "wide", "full" or a tuple of checkpoint names (see
    :func:`remat_names`).  Layers may be stacked or unstacked (a list, see
    :func:`unstack_params`).

    Under a ``mesh`` (a DeviceMesh over :data:`dstack_tpu_torch.parallel.
    mesh.AXIS_ORDER`; always the sharded path, even when every axis is 1)
    the parameters are DTensors placed by :func:`param_specs` under
    ``policy`` (or this rank's local shards), and ``tokens`` and
    ``positions`` are this rank's stripe of the global batch (see
    :func:`dstack_tpu_torch.parallel.mesh.batch_stripe`; so the batch
    always divides the batch axes, the JAX package's other condition for
    its fused kernel).  Returns the stripe's hidden states.  FSDP gathers
    each weight inside its layer, tensor parallelism splits heads and ffn
    (``tensor`` must divide both head counts).

    Under ``seq`` the tokens are the stripe of the sequence too (rank r
    holds positions r * s onwards, RoPE and the mask global), and
    attention is Ulysses or ring by ``policy.seq_scheme`` (Ulysses runs
    the fused kernels on the whole sequence of its heads).  Under
    ``stage`` the stacked layers run through
    :func:`~dstack_tpu_torch.parallel.pipeline.pipeline_layers` in
    ``policy.num_microbatches`` microbatches of the rank's rows, and the
    output is every stage's.  The JAX package's refusals hold: both axes
    at once, custom ``positions`` under either, unstacked layers under
    ``stage``, Ulysses with heads that do not split over seq x tensor."""
    keep = remat_names(remat)
    layout = Layout(mesh, policy or ShardingPolicy(), cfg)
    for axis, what in ((layout.stage, "the pipeline path"),
                       (layout.seq, "the context-parallel (seq) path")):
        if axis and positions is not None:
            # the layer body reads whole-batch, global 0..S-1 positions
            raise NotImplementedError(
                f"custom `positions` are not supported on {what} yet; pass "
                f"positions=None with {axis} parallelism")
    specs = None
    if mesh is not None:
        specs = specs_for(params, cfg, layout.policy)
        params = map_with_specs(lambda sp, p: _local(p, sp, mesh), specs,
                                params)
    return _walk(params, tokens, cfg, layout, specs, LayerKind(), keep,
                 positions=positions)


def _walk(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
          layout: Layout, specs: Optional[Params],
          kind: Union[LayerKind, Callable[[int], LayerKind]],
          keep: Optional[tuple], *, positions: Optional[torch.Tensor] = None,
          stacks: tuple = ("layers",), embed_scale: float = 1.0
          ) -> torch.Tensor:
    """The stack of every family, from ``tokens`` to the final norm's
    output: RoPE's table of ``positions`` (None: :meth:`Layout.positions`)
    and the attention (the fused kernels under ``seq`` or where the JAX
    package takes them: default positions and ``flash.supports``; else
    :func:`causal_attention`) chosen once, the embedding times
    ``embed_scale`` in ``model.embed``, the layers of each of ``stacks``
    in turn (stacked: :func:`layer_views`; under ``stage``
    :func:`pipeline_layers`), layer l :func:`_layer_fn` of ``kind`` or
    ``kind(l)`` under ``keep``, and the final norm in ``model.head_loss``.
    ``specs``: the tree's specs under a mesh (``params`` this rank's
    local shards), else None.  Fused where the JAX package fuses, and also
    where the card's kernels take the shape (:func:`flash.kernel_takes` at
    ``cfg.attn_widths``: the TPU's budget does not bind them), so a long
    sequence at the built widths never builds [S, S] scores."""
    s, dev = tokens.shape[1], tokens.device
    default_positions = positions is None
    inv_freqs = torch.from_numpy(rope_frequencies(
        cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)).to(dev)
    if default_positions:
        positions = layout.positions(s, dev)
    rope = rope_table(positions, inv_freqs)
    d_qk, d_v = cfg.attn_widths
    fused = layout.seq is not None or (default_positions and (flash.supports(
        s, d_qk, cfg.dtype, group=cfg.num_heads // cfg.num_kv_heads)
        or flash.kernel_takes(s, d_qk, d_v)))
    layers = [params[name] for name in stacks]
    stacked = not isinstance(layers[0], (list, tuple))
    layout.check_stacked(stacked)
    if specs is None:  # no mesh: nothing is sharded
        specs = layer_specs = collections.defaultdict(lambda: None)
    elif stacked:
        layer_specs = {k: tuple(v[1:]) for k, v in specs["layers"].items()}
    else:
        layer_specs = specs["layers"][0] if layers[0] else {}
    layer_of = functools.cache(lambda k: _layer_fn(
        cfg, positions, rope, fused, keep, layout, layer_specs, k))

    with spans.region("model.embed") as r:
        x = _embed_lookup(r.inputs(params["embed"]).to(cfg.dtype), tokens,
                          layout, specs["embed"])
        if embed_scale != 1.0:
            x = x * embed_scale
        x = r.outputs(x)
    if layout.stage:
        # only the dense model keeps a stage axis (an MoE's strips it)
        shapes = init_params(cfg, "meta", None)["layers"]
        x = pipeline_layers(
            layer_of(kind), {k: distribute(w, specs["layers"][k], layout.mesh,
                                        shapes[k].shape)
                          for k, w in layers[0].items()}, x,
            mesh=layout.mesh, stage_axis=layout.stage,
            num_microbatches=layout.policy.num_microbatches)
    else:
        views = []
        for stack in layers:
            views += (layer_views(stack, tree_leaves(stack)[0].shape[0])
                      if stacked else stack)
        for l, lp in enumerate(views):
            x = layer_of(kind(l) if callable(kind) else kind)(x, lp)
    with spans.region("model.head_loss") as r:
        x, norm = r.inputs((x, params["final_norm"]))
        return r.outputs(rms_norm(x, layout.weight(norm, specs["final_norm"]),
                                  cfg.rms_eps))


def layer_views(layers: Params, num_layers: int) -> list:
    """Each layer's views of the stacked weights (a tree of dicts: a
    serving-quantized expert stack's leaves are viewed one by one), made
    by one ``unbind(0)`` per stacked leaf and regrouped into per-layer
    trees.  Their backward waits for every layer's gradient of a leaf and
    writes the leaf's stacked gradient once, one ``stack`` per leaf,
    inside the ``model.views`` span.  Nothing may write into a view in
    place (it is one output of several)."""
    with spans.region("model.views") as r:
        stacks, tree = _pytree.tree_flatten(r.inputs(layers))
        rows = [w.unbind(0) for w in stacks]
        return r.outputs([
            _pytree.tree_unflatten([row[l] for row in rows], tree)
            for l in range(num_layers)])


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, *,
            mesh: Any = None, policy: Optional[ShardingPolicy] = None,
            positions: Optional[torch.Tensor] = None,
            remat: Union[bool, str, tuple] = False) -> torch.Tensor:
    """Full-sequence forward: f32 logits [B, S, V] (under a mesh, of this
    rank's rows).  Training prefers :func:`backbone` +
    :func:`dstack_tpu_torch.ops.loss.chunked_cross_entropy`, which never
    builds this tensor."""
    if mesh is not None:
        # one local view per parameter: a tied embedding read twice
        # through DTensors would add two DTensor gradients
        params = map_with_specs(
            lambda sp, p: _local(p, sp, mesh),
            specs_for(params, cfg, policy or ShardingPolicy()), params)
    x = backbone(params, tokens, cfg, mesh=mesh, policy=policy,
                 positions=positions, remat=remat)
    return f32_logits(x, output_head(params, cfg, mesh, policy))


# -- the plain-cache decode ----------------------------------------------------


def init_kv_caches(cfg: LlamaConfig, batch: int, max_len: int,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> KVCache:
    """Zeroed [L, B, S, Hkv, D] caches in ``cfg.dtype`` for
    :func:`decode_step`, on ``device`` (CUDA unless the CPU is named)."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   length=torch.zeros((), dtype=torch.int32, device=dev))


def decode_step(params: Params, token: torch.Tensor, cache: KVCache,
                cfg: LlamaConfig) -> tuple:
    """One autoregressive step of every row at position ``cache.length``
    (token [B]); returns (f32 logits [B, V], the cache one longer).  The
    plain-cache decode of the JAX package: plain attention over a dense
    cache, no kernel (the serving engine's paged decode is the kernel's
    path)."""
    b = token.shape[0]
    dev = token.device
    pos = cache.length
    positions = torch.as_tensor(pos, device=dev).long().reshape(1, 1).expand(
        b, 1)
    inv_freqs = torch.from_numpy(rope_frequencies(
        cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)).to(dev)
    x = params["embed"].to(cfg.dtype)[token][:, None, :]      # [B, 1, D]
    layers = params["layers"]
    new_k, new_v = [], []
    for l in range(cfg.num_layers):
        lp = (layers[l] if isinstance(layers, (list, tuple))
              else {k: w[l] for k, w in layers.items()})
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = ((h @ lp[name]).reshape(b, 1, -1, cfg.head_dim)
                   for name in ("wq", "wk", "wv"))
        q = apply_rope(q, positions, inv_freqs)
        k = apply_rope(k, positions, inv_freqs)
        attn, layer = decode_step_attention(
            q, KVCache(k=cache.k[l], v=cache.v[l], length=pos), k, v)
        x = x + attn.reshape(b, 1, cfg.q_dim) @ lp["wo"]
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]
        new_k.append(layer.k)
        new_v.append(layer.v)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = f32_logits(x, output_head(params, cfg))
    return logits[:, 0], KVCache(k=torch.stack(new_k), v=torch.stack(new_v),
                                 length=pos + 1)
