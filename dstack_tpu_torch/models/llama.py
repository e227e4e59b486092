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
(:mod:`dstack_tpu_torch.parallel.collectives`).  Sequence and pipeline
parallelism are not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
import math
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
from dstack_tpu_torch.parallel import collectives
from dstack_tpu_torch.parallel.mesh import (distribute, entry_axes,
                                            mesh_sizes, placements)

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


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """How this model maps onto the mesh axes of
    :data:`dstack_tpu_torch.parallel.mesh.AXIS_ORDER` (the JAX package's
    policy, field for field).  ``seq_axis`` and ``stage_axis`` over an
    axis of size above 1 raise "not yet ported"."""

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

    ``block(name, shape)``, when given, returns the slices of one (layer's)
    matrix ``name`` that are kept: every matrix is still drawn whole, in
    the same order, so the kept blocks are exactly the unsharded init's
    (a rank's shards under a mesh, see :func:`param_specs`)."""
    d, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def kept(name, shape):
        full = tuple(slice(0, s) for s in shape)
        sl = full if block is None else block(name, shape)
        return sl, tuple(s.stop - s.start for s in sl)

    def dense(name, shape, fan_in, stacked=True):
        sl, local = kept(name, shape)
        out = torch.empty(((n,) if stacked else ()) + local,
                          dtype=cfg.dtype, device=device)
        for part in (out if stacked else [out]):
            part.copy_(torch.randn(shape, generator=generator,
                                   dtype=torch.float32, device=device)[sl]
                       * fan_in ** -0.5)
        return out

    def ones(name, shape, stacked=True):
        local = kept(name, shape)[1]
        return torch.ones(((n,) if stacked else ()) + local,
                          dtype=cfg.dtype, device=device)

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
    ``tensor``.  :attr:`kept` lists the axes a weight may stay sharded
    on (a subclass adds its own)."""

    def __init__(self, mesh: Any, policy: ShardingPolicy, cfg: LlamaConfig):
        self.mesh, self.policy = mesh, policy
        if mesh is None:
            return
        self.sizes = sizes = mesh_sizes(mesh)
        for what, axis in (("sequence (seq_axis)", policy.seq_axis),
                           ("pipeline (stage_axis)", policy.stage_axis)):
            if axis is not None and sizes.get(axis, 1) > 1:
                raise NotImplementedError(
                    f"{what} parallelism is not yet ported to "
                    "dstack_tpu_torch")
        self.batch = [a for a in policy.batch_axes if sizes.get(a, 1) > 1]
        t = policy.tensor_axis
        self.tensor = t if t and sizes.get(t, 1) > 1 else None
        tsize = sizes[t] if self.tensor else 1
        if cfg.num_heads % tsize or cfg.num_kv_heads % tsize:
            # the JAX package falls back to GSPMD's attention here; a
            # rank-local head split has no such fallback
            raise NotImplementedError(
                f"tensor={tsize} must divide num_heads ({cfg.num_heads}) and "
                f"num_kv_heads ({cfg.num_kv_heads})")
        self.batch_count = math.prod(sizes.get(a, 1)
                                     for a in policy.batch_axes)
        self.tsize = tsize
        self.kept = (self.tensor,)

    def weight(self, w: torch.Tensor, spec, whole: bool = False):
        """The weight a rank computes with: gathered over the batch axes
        (and over ``tensor`` too when ``whole``: the head before the loss,
        whose gradient every tensor rank computes whole)."""
        if self.mesh is None:
            return w
        gathered = set()
        for dim, entry in enumerate(spec):
            axes = [a for a in entry_axes(entry) if self.sizes[a] > 1]
            kept = [a for a in axes
                    if a not in self.batch and not (whole and a == self.tensor)]
            if axes[:len(kept)] != kept:
                raise NotImplementedError(
                    f"spec {spec}: a gathered axis is major to a kept one")
            if any(a not in self.kept for a in kept):
                raise NotImplementedError(
                    f"spec {spec}: weights sharded over {kept} are not yet "
                    "ported")
            for a in reversed(axes[len(kept):]):
                w = collectives.gather(w, dim, self.mesh, a,
                                       reduce=a in self.batch)
                gathered.add(a)
        return collectives.sum_grad(
            w, self.mesh, [a for a in self.batch if a not in gathered])

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        if self.mesh is None or self.tensor is None:
            return h
        return collectives.sum_grad(h, self.mesh, [self.tensor])

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        if self.mesh is None or self.tensor is None:
            return y
        return collectives.psum(y, self.mesh, self.tensor)

    def attention(self, q, k, v):
        """The fused kernels: whole, or on this rank's rows and heads
        through :func:`flash.flash_attention_sharded`."""
        if self.mesh is None:
            return flash.flash_attention(q, k, v)
        p = self.policy
        spec = (tuple(p.batch_axes), None, p.tensor_axis, None)

        def dt(x):
            b, s, h, d = x.shape
            return distribute(x, spec, self.mesh,
                              (b * self.batch_count, s, h * self.tsize, d))

        out = flash.flash_attention_sharded(
            self.mesh, dt(q), dt(k), dt(v), batch_axes=p.batch_axes,
            head_axis=p.tensor_axis)
        return out.to_local()


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


def _layer_fn(cfg: LlamaConfig, positions, inv_freqs, use_flash: bool,
              keep: Optional[tuple], layout: Layout, specs: dict):
    """One transformer layer ``(x, lp) -> x``.  The layer is five steps,
    each making one named tensor (:data:`REMAT_NAMES`); under remat the
    steps between two kept tensors run as one checkpointed region, so the
    backward recomputes exactly what the JAX policy recomputes.  The
    attention always sits in a region (its logsumexp is not a kept
    tensor); a lone product whose input is kept runs outside one, except
    under a mesh: there every region gathers its own weights, so remat
    gathers them again rather than keeping them."""

    def w(lp, name):
        return layout.weight(lp[name], specs[name])

    def qkv(st, lp):
        h = layout.enter(rms_norm(st["x"], w(lp, "attn_norm"), cfg.rms_eps))
        b, s = h.shape[:2]
        st["qkv"] = tuple((h @ w(lp, name)).reshape(b, s, -1, cfg.head_dim)
                          for name in ("wq", "wk", "wv"))

    def attn_out(st, lp):
        q, k, v = st.pop("qkv")
        q = apply_rope(q, positions, inv_freqs)
        k = apply_rope(k, positions, inv_freqs)
        if use_flash:
            out = layout.attention(q, k, v)
        else:
            out = causal_attention(q, k, v, q_positions=positions,
                                   kv_positions=positions)
        st["attn"] = out.reshape(*out.shape[:2], -1)

    def proj_attn(st, lp):
        st["x"] = st["x"] + layout.leave(st.pop("attn") @ w(lp, "wo"))

    def mlp_mid(st, lp):
        h = layout.enter(rms_norm(st["x"], w(lp, "mlp_norm"), cfg.rms_eps))
        st["mid"] = F.silu(h @ w(lp, "w_gate")) * (h @ w(lp, "w_up"))

    def proj_mlp(st, lp):
        st["x"] = st["x"] + layout.leave(st.pop("mid") @ w(lp, "w_down"))

    steps = ((qkv, "qkv"), (attn_out, "attn_out"), (proj_attn, "proj"),
             (mlp_mid, "mlp_mid"), (proj_mlp, "proj"))
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
            fn(st, lp)
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
    hidden states in ``cfg.dtype``.

    Attention is :func:`flash_attention` exactly when the JAX package takes
    its fused kernel (default positions and ``supports``), else
    :func:`causal_attention` over ``positions``.  ``remat`` is one of
    False/"none", True/"selective", "wide", "full" or a tuple of
    checkpoint names (see :func:`remat_names`).  Layers may be stacked
    (walked as ``w[l]`` views) or unstacked (a list, see
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
    (``tensor`` must divide both head counts).  ``seq_axis`` or
    ``stage_axis`` above 1 raise "not yet ported"."""
    keep = remat_names(remat)
    layout = Layout(mesh, policy or ShardingPolicy(), cfg)
    if mesh is not None:
        params = map_with_specs(lambda sp, p: _local(p, sp, mesh),
                                specs_for(params, cfg, layout.policy), params)
    specs = specs_for(params, cfg, layout.policy)
    s = tokens.shape[1]
    dev = tokens.device
    inv_freqs = torch.from_numpy(rope_frequencies(
        cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)).to(dev)
    default_positions = positions is None
    if default_positions:
        positions = torch.arange(s, device=dev)[None, :]
    use_flash = default_positions and flash.supports(
        s, cfg.head_dim, cfg.dtype, group=cfg.num_heads // cfg.num_kv_heads)
    layers = params["layers"]
    stacked = not isinstance(layers, (list, tuple))
    layer_specs = ({k: tuple(v[1:]) for k, v in specs["layers"].items()}
                   if stacked else specs["layers"][0] if layers else {})
    layer = _layer_fn(cfg, positions, inv_freqs, use_flash, keep, layout,
                      layer_specs)

    x = _embed_lookup(params["embed"].to(cfg.dtype), tokens, layout,
                      specs["embed"])
    if stacked:
        layers = [{k: w[l] for k, w in layers.items()}
                  for l in range(cfg.num_layers)]
    for lp in layers:
        x = layer(x, lp)
    return rms_norm(x, layout.weight(params["final_norm"],
                                     specs["final_norm"]), cfg.rms_eps)


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
