"""Continuous-batching inference engine on the Llama stack (PyTorch), dense
or with Mixtral-style routed experts (models/moe.py) in every MLP.

A fixed pool of decode *slots* shares one batched KV cache; prefill
computes a prompt's K/V with the full forward pass and inserts them into a
free slot; decode advances ALL active slots a window of tokens per
dispatch, one token per step, with per-slot positions.  Prompt lengths are
padded to buckets so the shapes a step sees come from a small set.

The KV cache is dense ([L, B, max_len, Hkv, D]) or paged
([L, NUM_BLOCKS, BS, Hkv, D] through per-slot block tables,
serving/paging.py), in the model's dtype, int8 or nibble-packed int4.
Paged decode reads its cache half through the Hopper paged-decode kernel
(ops/flash_attention.py paged_decode_attention) on every layer of every
step; int4 pages, which the kernel does not read, go through a gathered
view of the slots' blocks instead, as the JAX engine routes them.

PyTorch runs eagerly and asynchronously on the card: a decode window is a
Python loop (steps x layers) whose launches are queued on the current
stream, and its tokens are copied to the host only when the window is
drained — the one-window-in-flight pipelining of :meth:`_step` works
because the next window is queued before the current one's tokens are
read.  The caches are updated IN PLACE (where the JAX engine donated them
to each program and got new ones back); every write is queued on the same
stream after the reads it must follow.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import queue
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from dstack_tpu_torch.elastic.compile_cache import CompileCache
from dstack_tpu_torch.models import moe
from dstack_tpu_torch.models import llama
from dstack_tpu_torch.models.llama import (
    Layout,
    LlamaConfig,
    Params,
    ShardingPolicy,
    init_params,
    output_head,
)
from dstack_tpu_torch.ops.flash_attention import paged_decode_attention
from dstack_tpu_torch.ops.rmsnorm import rms_norm
from dstack_tpu_torch.ops.rotary import apply_rope, rope_frequencies
from dstack_tpu_torch.parallel import collectives
from dstack_tpu_torch.parallel import mesh as mesh_lib
from dstack_tpu_torch.serving import lockstep
from dstack_tpu_torch.serving.paging import (
    BlockAllocator,
    PrefixBlockAllocator,
)
from dstack_tpu_torch.serving.quant import (
    dequantize_kv,
    dequantize_kv4,
    qmatmul,
    quantize_kv,
    quantize_kv4,
    quantize_params,
)
from dstack_tpu_torch.utils.device import resolve_device

PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)
_NEG_INF = -1e30

logger = logging.getLogger(__name__)


class EngineDraining(RuntimeError):
    """Raised by :meth:`InferenceEngine.submit` once the engine is in
    drain mode: in-flight requests finish, new ones must go elsewhere."""


@dataclasses.dataclass
class Request:
    tokens: List[int]
    max_new_tokens: int = 128
    temperature: float = 0.0
    top_p: float = 1.0
    #: keep only the k highest-probability tokens before nucleus masking
    #: (0 = disabled)
    top_k: int = 0
    eos_id: Optional[int] = None
    #: called with each generated token id (streaming); None = collect only
    on_token: Optional[Callable[[int], None]] = None
    #: prefill/decode disaggregation: KV made by a prefill replica
    #: ({"ks", "vs": [L, n, Hkv, D], "logits": [V] or None, "first_token",
    #: "length"}); admission installs it instead of running a prefill
    prefill: Optional[dict] = None
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    finish_reason: str = ""
    submitted_at: float = dataclasses.field(default_factory=time.time)
    #: when the request claimed a slot (queue wait = admitted - submitted)
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    #: set via cancel(); the engine releases the slot at the next emit
    cancelled: bool = False
    #: absolute wall-clock deadline (``time.time()``); expired-in-queue
    #: requests are evicted at admission without a prefill, an expired
    #: decode is cancelled at the next emit
    deadline: Optional[float] = None
    #: distributed-tracing context (telemetry/tracing.py)
    trace_id: Optional[str] = None
    parent_span_id: Optional[str] = None

    def cancel(self, reason: str = "cancelled") -> None:
        """Stop generating for this request as soon as the engine next
        looks at it.  Safe to call from any thread."""
        if not self.finish_reason:
            self.finish_reason = reason
        self.cancelled = True


# -- model math ---------------------------------------------------------------


def _layer_params(params: Params, l: int) -> Dict[str, Any]:
    """Layer ``l``'s weights as views of the stacked [L, ...] tensors
    (int8 {"q","s"} dicts keep their dict form)."""
    return {name: ({k: t[l] for k, t in w.items()} if isinstance(w, dict)
                   else w[l])
            for name, w in params["layers"].items()}


def _all_layers(params: Params, cfg: LlamaConfig) -> List[Dict[str, Any]]:
    return [_layer_params(params, l) for l in range(cfg.num_layers)]


def _gathered(layout: Layout, w, spec: tuple):
    """A serving weight as a rank computes with it: its shard gathered
    whole over the axes the layout does not keep (``fsdp``); an int8
    ``{"q", "s"}`` weight's scales follow its output channels."""
    if isinstance(w, dict):
        return {"q": layout.weight(w["q"], spec),
                "s": layout.weight(w["s"], spec[:-2] + spec[-1:])}
    return layout.weight(w, spec)


class _GatheredLayers:
    """The layers of an engine whose weights are sharded over ``fsdp``, as
    the forward walks them: each layer's shards gathered at use
    (:func:`_gathered`), so a rank holds its shards and the gathered
    weights of the layer it runs (and, while the next is gathered, of the
    one before)."""

    def __init__(self, params: Params, cfg: LlamaConfig, layout: Layout,
                 specs: Dict[str, tuple]):
        self.params, self.layout, self.specs = params, layout, specs
        self.n = cfg.num_layers

    def __iter__(self):
        for l in range(self.n):
            yield {name: _gathered(self.layout, w, self.specs[name])
                   for name, w in _layer_params(self.params, l).items()}


def _inv_freqs(cfg: LlamaConfig, device) -> torch.Tensor:
    return torch.from_numpy(rope_frequencies(
        cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)).to(device)


def _embed(params: Params, cfg: LlamaConfig, tokens: torch.Tensor):
    return params["embed"][tokens].to(cfg.dtype)


def _leave(y, layout: Optional[Layout]):
    """The sum of a row-parallel product over ``tensor`` (identity off a
    mesh)."""
    return y if layout is None else layout.leave(y)


def _logits(rows, params: Params, cfg: LlamaConfig,
            layout: Optional[Layout] = None):
    """f32 logits of normed hiddens.  Under a mesh a head of its own
    ("lm_head": untied, or a tied model's int8 copy) holds this rank's
    vocab columns (gathered over ``fsdp`` first), and the logits are
    gathered whole on every rank; a tied head reads the replicated
    embedding whole."""
    head = output_head(params, cfg)
    if layout is not None and "lm_head" in params:
        head = _gathered(layout, head, (layout.policy.fsdp_axis,
                                        layout.policy.tensor_axis))
    y = qmatmul(rows, head, cfg.dtype, preferred=torch.float32)
    if layout is None or layout.tensor is None or "lm_head" not in params:
        return y
    return collectives.all_gather_list(y, y.dim() - 1, layout.mesh,
                                       layout.tensor)


def _mlp_block(h, lp, cfg: LlamaConfig, token_mask=None,
               layout: Optional[Layout] = None):
    """Dense SwiGLU or routed-expert MLP on [B, S, D] normed hiddens: the
    one point where the engine tells Llama-family from Mixtral-style MoE
    weights (a layer with a "router").

    MoE decode (one token a slot) routes with DROPLESS capacity (B * S):
    no generated token loses an expert to its batch neighbours.  Wider
    forwards (prefill, the speculative verify) take the config's capacity,
    and ``token_mask`` [B, S] keeps bucket padding out of routing, so pads
    never take a real token's slot.  Under a mesh the ffn columns (and
    the experts) are this rank's, and the output is summed over the
    ranks."""
    if "router" not in lp:
        gated = F.silu(qmatmul(h, lp["w_gate"], cfg.dtype))
        up = qmatmul(h, lp["w_up"], cfg.dtype)
        return _leave(qmatmul(gated * up, lp["w_down"], cfg.dtype), layout)
    b, s, _ = h.shape
    out, _aux = moe._moe_mlp(h, lp, cfg, capacity=b * s if s == 1 else None,
                             token_mask=token_mask, layout=layout)
    return out


def _masked_attention(q, k, v, q_pos, kv_pos):
    """Causal GQA attention with explicit position masks (prefill): masked
    scores are -1e30 and the softmax is taken in f32."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    q = q.reshape(b, s, hkv, group, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q, k) / (d ** 0.5)
    mask = (kv_pos[:, None, :] <= q_pos[:, :, None])[:, None, None, :, :]
    scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, s, hq, d)


def _qkv(x, lp, cfg: LlamaConfig, positions, inv_freqs):
    """Projections + RoPE for [B, S, D] hiddens (prefill and decode share
    it, so the two can never diverge numerically).  The heads are the
    weights' (a rank's heads under a mesh)."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    q, k, v = (qmatmul(h, lp[name], cfg.dtype).reshape(b, s, -1, cfg.head_dim)
               for name in ("wq", "wk", "wv"))
    return (apply_rope(q, positions, inv_freqs),
            apply_rope(k, positions, inv_freqs), v)


def _layer_tail(x, attn, lp, cfg: LlamaConfig, token_mask=None,
                layout: Optional[Layout] = None):
    """Post-attention half of a layer (wo + MLP), shared by every path;
    ``token_mask`` [B, S] marks the real tokens of a padded prefill."""
    b, s = x.shape[:2]
    x = x + _leave(qmatmul(attn.reshape(b, s, -1), lp["wo"], cfg.dtype),
                   layout)
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    return x + _mlp_block(h, lp, cfg, token_mask, layout)


def _layer_kv(layers, cfg: LlamaConfig, x, positions, inv_freqs,
              token_mask=None, layout: Optional[Layout] = None):
    """Full-sequence forward through every layer, keeping each layer's K/V
    (prefill).  Returns (x, ks, vs) with ks/vs [L, B, S, Hkv, D]."""
    ks, vs = [], []
    for lp in layers:
        q, k, v = _qkv(x, lp, cfg, positions, inv_freqs)
        attn = _masked_attention(q, k, v, positions, positions)
        x = _layer_tail(x, attn, lp, cfg, token_mask, layout)
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def _prompt_forward(params: Params, cfg: LlamaConfig, padded: torch.Tensor,
                    length: int, bucket: int, every_position: bool = False,
                    layout: Optional[Layout] = None, layers=None):
    """Forward over a padded prompt: (last-position f32 logits, ks, vs) —
    the one source of prefill math.  ``every_position``: logits [length,
    V] of each prompt position instead.  Under a mesh (``layout``) the
    weights are this rank's, the K/V its heads', the logits whole;
    ``layers`` (default: views of ``params``' layers) is how the engine
    reads them."""
    device = padded.device
    positions = torch.arange(bucket, device=device)[None, :]
    x = _embed(params, cfg, padded)[None, :, :]
    if layers is None:
        layers = _all_layers(params, cfg)
    x, ks, vs = _layer_kv(layers, cfg, x, positions,
                          _inv_freqs(cfg, device), positions < length,
                          layout)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    rows = x[0, :length] if every_position else x[0, length - 1, :]
    return _logits(rows, params, cfg, layout), ks, vs


# -- KV cache forms -----------------------------------------------------------


def _kv_layer(cache, l: int):
    """Layer ``l`` of a plain or int8 {"q","s"} cache, as views."""
    if isinstance(cache, dict):
        return {k: t[l] for k, t in cache.items()}
    return cache[l]


def _kv_mat(cache_leaf, dtype):
    """A KV tensor ready for attention: plain tensors pass through;
    quantized dicts dequantize — int8 {"q","s"} or nibble-packed int4
    {"q4","s"} (the dict key is the format's marker)."""
    if isinstance(cache_leaf, dict):
        if "q4" in cache_leaf:
            return dequantize_kv4(cache_leaf["q4"], cache_leaf["s"], dtype)
        return dequantize_kv(cache_leaf["q"], cache_leaf["s"], dtype)
    return cache_leaf


def _kv_map(cache, rows, fn):
    """Apply ``fn(cache_leaf, rows_leaf)`` over a cache that is a plain
    tensor or a quantized {"q"|"q4","s"} dict (rows quantized to match).
    ``fn`` must be generic over trailing dims: the int4 "q4" leaf has D/2
    packed bytes and the "s" leaf no D dim."""
    if isinstance(cache, dict):
        qk = "q4" if "q4" in cache else "q"
        q, s = (quantize_kv4 if qk == "q4" else quantize_kv)(rows)
        return {qk: fn(cache[qk], q), "s": fn(cache["s"], s)}
    return fn(cache, rows)


def _dense_window_insert(cache, win, widx, sel) -> None:
    """End-of-window insert into the DENSE cache, in place: cache row (b, s)
    takes window column ``widx[b, s]`` wherever ``sel[b, s]`` — the one
    write the plain and the speculative windows amortize their steps'
    cache updates into.  ``win`` is [L, cols, B, ...]."""
    def write(leaf, rows):  # leaf [L, B, S, ...], rows [L, cols, B, ...]
        extra = (1,) * (rows.dim() - 3)
        idx = widx.view(widx.shape + extra)
        mask = sel.view(sel.shape + extra)
        for l in range(leaf.shape[0]):
            rows_t = rows[l].transpose(0, 1)         # [B, cols, ...]
            picked = torch.gather(
                rows_t, 1, idx.expand(widx.shape + rows_t.shape[2:]))
            leaf[l] = torch.where(mask, picked, leaf[l])

    _kv_map(cache, win, write)


def _suffix_layer(x, lp, cfg: LlamaConfig, positions, inv_freqs, kv_pos,
                  token_mask, layer_k, layer_v, insert, gather,
                  layout: Optional[Layout] = None):
    """One layer of a chunk prefill: project the new tokens' K/V,
    ``insert`` them into the slot's cache (in place), then attend the new
    queries over the ``gather``-ed slot span (earlier rows + causal within
    the new ones, absolute RoPE positions).  The callbacks are the only
    difference between the paged chunk (block scatter/gather) and the
    dense chunk (row slice); ``token_mask`` [1, S] marks the chunk's real
    tokens for MoE routing."""
    q, k, v = _qkv(x, lp, cfg, positions, inv_freqs)
    _kv_map(layer_k, k, insert)
    _kv_map(layer_v, v, insert)
    kv_k = _kv_mat(gather(layer_k), cfg.dtype)
    kv_v = _kv_mat(gather(layer_v), cfg.dtype)
    attn = _masked_attention(q, kv_k, kv_v, positions, kv_pos)
    return _layer_tail(x, attn, lp, cfg, token_mask, layout)


def _tree_map(fn, cache):
    if isinstance(cache, dict):
        return {k: fn(t) for k, t in cache.items()}
    return fn(cache)


class InferenceEngine:
    """Slot-based continuous batching over one model replica.

    `step()` is one scheduling iteration: admit waiting prompts into free
    slots (prefill), then advance every active slot a WINDOW of tokens in
    one dispatch (:meth:`_decode_window`) with on-device sampling.
    Streaming callbacks arrive in bursts of up to ``DECODE_WINDOWS[-1]``
    tokens, and a queued prompt waits at most one window for a free slot.
    """

    #: chunk size the server enables by default, and the draft length of
    #: n-gram speculation (the JAX engine's sweep winners, kept so both
    #: engines schedule alike)
    TUNED_PREFILL_CHUNK = 512
    TUNED_SPECULATION_K = 2

    #: decode-window sizes: the largest is the steady-state path, the small
    #: ones avoid large overshoot on short tails
    DECODE_WINDOWS = (8, 32, 64)

    #: fixed per-window dispatch overhead expressed in decode steps;
    #: _pick_window weighs overshoot against it when splitting tails
    WINDOW_DISPATCH_COST_STEPS = 8

    #: a sharded engine's rank 0, idle, tells its followers it lives this
    #: often (their broadcasts must not wait past the group's timeout)
    KEEPALIVE_S = 10.0

    def __init__(
        self,
        cfg: LlamaConfig,
        params: Optional[Params] = None,
        batch_size: int = 8,
        max_len: int = 1024,
        rng_seed: int = 0,
        paged: bool = False,
        kv_block_size: int = 32,
        total_kv_blocks: Optional[int] = None,
        quantize: Optional[str] = None,
        kv_quantize: Optional[str] = None,
        prefix_cache: bool = False,
        prefill_chunk: Optional[int] = None,
        speculation: Optional[str] = None,
        speculation_k: Optional[int] = None,
        telemetry: Optional[Any] = None,
        device: Optional[Union[str, torch.device]] = None,
        mesh: Optional[Any] = None,
        sharding_policy: Optional[ShardingPolicy] = None,
        compile_cache: Optional[CompileCache] = None,
    ) -> None:
        """``device``: None means CUDA, and raises when no card is visible;
        the CPU runs only when asked for (``device="cpu"``).

        ``mesh`` (a DeviceMesh over the process group, one rank a card:
        :func:`dstack_tpu_torch.parallel.mesh.build_mesh`) serves the model
        sharded as the JAX engine's mesh does: heads and ffn over the
        policy's ``tensor`` axis (Megatron-style; the KV cache holds this
        rank's Hkv / tensor heads in every format), MoE experts over
        ``expert``, the matrices' contraction dim over ``fsdp_axis``
        (gathered a layer at a time at use; ``lm_head`` at (fsdp,
        tensor)), the embedding replicated and a head of its own
        vocab-sharded.  Every rank holds all the slots: the batch axes
        stripe nothing, as the JAX engine's unconstrained activations are
        replicated, and the KV cache is sharded over ``tensor`` only.
        ``sharding_policy`` defaults to ``ShardingPolicy(batch_axes=(),
        fsdp_axis=None, tensor_axis="tensor")``.  Given ``params`` are
        whole trees, of which each rank keeps its blocks; without them
        each rank draws every matrix from ``rng_seed`` and keeps its
        blocks (the one-card engine's weights, never whole on one card).
        Every rank builds the engine; rank 0 drives it and :meth:`close`
        ends it, and every other rank calls :meth:`follow`
        (serving/lockstep.py).  Prefill/decode export and install run on
        every rank as lockstep operations.

        ``paged=True`` switches the KV cache from a dense [B, max_len] row
        per slot to block paging: each request reserves only
        ceil((prompt + max_new) / block) blocks at admission, and decode
        reads the pages through the paged-decode kernel.  Admission blocks
        (the request waits queued) when the pool is exhausted — never
        mid-decode.

        ``prefix_cache=True`` (paged only) reuses the KV of shared prompt
        prefixes: a prompt's full blocks are published under chained
        content keys after its prefill, and a later prompt that starts
        with the same blocks takes them (refcounted) and prefills only its
        suffix (serving/paging.py PrefixBlockAllocator).

        ``kv_quantize="int8"`` stores the KV cache as int8 with one f32
        scale per (token, head) row; the paged kernel dequantizes pages
        in place.  ``"int4"`` packs two values per byte (a quarter of the
        bf16 bytes, ~6% RMS row error); paged int4 decode attends over a
        gathered view of the slots' blocks, not through the kernel.

        ``quantize="int8"``: weight-only int8 (serving/quant.py).

        ``prefill_chunk``: prompts longer than this prefill in chunks of at
        most this many tokens, ONE chunk per scheduling step, interleaved
        with decode windows; the slot stays inactive until its last chunk
        produces the first token.  None disables.  A prefix-cache hit
        starts its chunks past the reused rows.

        ``speculation="ngram"`` (dense cache only): greedy windows verify
        ``speculation_k`` draft tokens (default ``TUNED_SPECULATION_K``),
        taken from the slot's own token history, in one (k+1)-wide
        forward per step, emitting 1..k+1 tokens per step; the tokens are
        those of plain greedy decode.  Windows with a sampled request take
        the plain window (:meth:`_decode_window_spec`).

        ``telemetry``: a `telemetry.serving.EngineTelemetry`, or None (the
        hot paths then pay one ``is None`` check).

        ``compile_cache``: a `dstack_tpu_torch.elastic.compile_cache.
        CompileCache` through which a CUDA engine that launches the
        paged-decode kernel (paged, pages not int4; under a mesh on every
        rank) makes its library present before the first launch or in
        :meth:`warmup`, whichever comes first: a scaling-up replica whose
        library a peer already built fetches it instead of running nvcc.
        Defaults to the env-configured cache (``DSTACK_COMPILE_CACHE`` /
        ``DSTACK_COMPILE_CACHE_PEERS``); both unset → no caching, the
        library is built at first launch.  Hit/miss counters surface on
        ``/load`` and ``/stats``.
        """
        # under a mesh, the card of this rank (or the mesh's CPU)
        self.device = (resolve_device(device) if mesh is None
                       else mesh_lib.mesh_device(mesh))
        self.mesh = mesh
        self._layout: Optional[Layout] = None
        self._fsdp = False
        self._leader = self._follower = None
        #: why a sharded engine stopped serving (a step failed on rank 0),
        #: or None
        self.failed: Optional[str] = None
        self.cfg = cfg
        self.telemetry = telemetry
        self.compile_cache = (compile_cache if compile_cache is not None
                              else CompileCache.from_env())
        self.batch_size = batch_size
        self.max_len = min(max_len, cfg.max_seq_len)
        self.paged = paged
        if kv_quantize not in (None, "int8", "int4"):
            raise ValueError(f"unsupported kv_quantize={kv_quantize!r} "
                             "(only 'int8' or 'int4')")
        if kv_quantize == "int4" and cfg.head_dim % 2:
            raise ValueError("int4 KV packing needs an even head_dim")
        self.kv_quantize = kv_quantize
        self.kv_quant = kv_quantize is not None
        #: the libraries still to be resolved through the compile cache
        #: (before their first launch): the row kernel of every norm on
        #: the card, the paged decode's where it reads pages
        self._kernels_pending = () if (
            self.compile_cache is None or self.device.type != "cuda") else (
            ("rownorm", "paged_decode") if paged and kv_quantize != "int4"
            else ("rownorm",))
        #: paged decode reads a power-of-two bucket of each slot's block
        #: table sized to the longest active slot; DSTACK_TPU_RAGGED_DECODE=0
        #: reads the full span (the JAX engine's dense-paged baseline)
        self._ragged = os.environ.get(
            "DSTACK_TPU_RAGGED_DECODE", "1") != "0"
        #: a sharded engine's device operations, each sent and run whole
        #: (a prefill leg's export comes from the HTTP thread)
        self._op_lock = (threading.Lock() if mesh is not None
                         else contextlib.nullcontext())
        if paged:
            if kv_block_size <= 0 or kv_block_size & (kv_block_size - 1):
                # prefill buckets are powers of two: any power-of-two block
                # size tiles them exactly
                raise ValueError("kv_block_size must be a power of two")
            if self.max_len % kv_block_size:
                raise ValueError("max_len must be a multiple of kv_block_size")
            self._block_size = kv_block_size
            self._blocks_per_slot = self.max_len // kv_block_size
            n_blocks = (total_kv_blocks if total_kv_blocks is not None
                        else batch_size * self._blocks_per_slot + 1)
            if n_blocks <= self._blocks_per_slot:
                # a max-size request must always be admittable on an idle
                # engine, or the head-of-line stall never resolves
                raise ValueError(
                    f"total_kv_blocks must exceed {self._blocks_per_slot} "
                    f"(= max_len / kv_block_size)")
            self._alloc = (PrefixBlockAllocator(n_blocks) if prefix_cache
                           else BlockAllocator(n_blocks))
            self._tables_host = np.zeros(
                (batch_size, self._blocks_per_slot), np.int32)
            self._slot_blocks: List[List[int]] = [[] for _ in range(batch_size)]
        elif prefix_cache:
            raise ValueError("prefix_cache requires paged=True (the cache "
                             "is block-addressed)")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.prefill_chunk = prefill_chunk
        if speculation not in (None, "ngram"):
            raise ValueError(f"unsupported speculation={speculation!r} "
                             "(only 'ngram')")
        if speculation and paged:
            raise ValueError("speculation requires the dense cache")
        self.speculation = speculation
        self.speculation_k = (speculation_k if speculation_k is not None
                              else self.TUNED_SPECULATION_K)
        self.prefix_cache = prefix_cache
        #: per-slot (prefix_len, block_keys) staged between reserve and
        #: prefill (prefix-cache mode)
        self._slot_prefix: List[tuple] = [(0, []) for _ in range(batch_size)]
        #: slot_id -> {"tokens", "done", ("logits", "n")} for prompts
        #: mid-chunked-prefill
        self._chunking: dict = {}
        #: Mixtral-style MoE: an MoEConfig, or a layer tree with a router
        self._is_moe = isinstance(cfg, moe.MoEConfig) or (
            params is not None and "router" in (
                params["layers"][0]
                if isinstance(params["layers"], (list, tuple))
                else params["layers"]))
        if self._is_moe and not isinstance(cfg, moe.MoEConfig):
            raise ValueError(
                "these params route their MLP through experts (a layer has "
                "a 'router'): pass a models.moe.MoEConfig, which says how "
                "many experts a token takes")
        if mesh is not None:
            self._shard_over(mesh, sharding_policy, device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(rng_seed)
            params = (moe.init_params if self._is_moe else init_params)(
                cfg, self.device, gen, block=self._block)
        elif mesh is not None:
            params = self._local_blocks(params)
        if quantize is not None:
            if quantize != "int8":
                raise ValueError(f"unsupported quantize={quantize!r} "
                                 "(only 'int8')")
            # tied models get an int8 copy of the head so the logits matmul
            # (the largest single weight read) reads int8 too
            params = quantize_params(params, tied_head_copy=cfg.tie_embeddings,
                                     reduce=self._absmax_reduce)
            if mesh is not None and cfg.tie_embeddings:
                # the tied head's copy, quantized whole: its vocab block
                params["lm_head"] = self._local_blocks(
                    {"lm_head": params["lm_head"]})["lm_head"]
        self.params = params
        self._layers = (
            _GatheredLayers(params, cfg, self._layout,
                            {n: self._leaf_spec(n) for n in params["layers"]})
            if self._fsdp else _all_layers(params, cfg))
        self._inv_freqs = _inv_freqs(cfg, self.device)
        self._queue: "queue.Queue[Request]" = queue.Queue()
        #: head-of-line request waiting for KV blocks (paged mode)
        self._stalled: Optional[Request] = None
        self._slots: List[Optional[Request]] = [None] * batch_size
        #: source of the sampler's noise (sampled requests only)
        self._gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self._reset_device_state()
        self._stop = False
        #: drain mode: finish in-flight work, refuse new submissions
        self.draining = False
        #: request popped from the queue but not yet in a slot (visible to
        #: has_work() for the whole admission)
        self._admitting: Optional[Request] = None
        #: bumped on any slot-assignment change; keys the cached per-window
        #: device constants in _dispatch_window
        self._slots_gen = 0
        #: decode steps dispatched (window widths summed; on every rank of
        #: a sharded engine): with a paged cache every step launches the
        #: paged-decode kernel once per layer
        self.decode_steps = 0
        #: engine watchdog: a scheduling step stuck past this window means
        #: the device runtime is wedged (the server fails /health and /load)
        self._watchdog_s = float(os.environ.get(
            "DSTACK_TPU_ENGINE_WATCHDOG_S", "300"))
        self._step_started_at: Optional[float] = None
        #: speculative-decode counters: verification steps of decoding
        #: slots and the draft tokens they accepted (end-of-request
        #: overshoot included)
        self.spec_stats = {"steps": 0, "accepted": 0}
        if mesh is not None:
            self._leader, self._follower = lockstep.role(self)
        #: rank 0 of a sharded engine, or a one-card engine: the rank that
        #: returns what the operations produce
        self._is_rank0 = self._follower is None

    # -- the mesh ----------------------------------------------------------

    def _shard_over(self, mesh, policy: Optional[ShardingPolicy],
                    device) -> None:
        """Check ``mesh`` and ``policy`` as the JAX engine does (its
        messages) and set the layout and the serving specs."""
        cfg = self.cfg
        policy = policy or ShardingPolicy(batch_axes=(), fsdp_axis=None,
                                          tensor_axis="tensor")
        names = tuple(mesh.mesh_dim_names)
        if policy.tensor_axis and policy.tensor_axis not in names:
            raise ValueError(
                f"mesh axes {names} lack the policy's tensor axis "
                f"{policy.tensor_axis!r}; name the mesh axis to match (or "
                f"pass a sharding_policy)")
        sizes = mesh_lib.mesh_sizes(mesh)
        t = sizes.get(policy.tensor_axis, 1) if policy.tensor_axis else 1
        if cfg.num_kv_heads % t or cfg.num_heads % t:
            raise ValueError(
                f"tensor-parallel serving needs head counts divisible by the "
                f"tensor degree: heads {cfg.num_heads}/{cfg.num_kv_heads}, "
                f"tensor={t}")
        e = sizes.get("expert", 1)
        if self._is_moe and e > 1 and cfg.num_experts % e:
            raise ValueError(
                f"expert-parallel serving needs num_experts "
                f"({cfg.num_experts}) divisible by the expert mesh degree "
                f"({e})")
        over = [a for a in (policy.seq_axis, policy.stage_axis)
                if a and sizes.get(a, 1) > 1]
        if over:
            raise NotImplementedError(
                f"serving with the sequence or the layers sharded over "
                f"{over} is not yet ported to dstack_tpu_torch")
        if device is not None and torch.device(device).type != mesh.device_type:
            raise ValueError(f"device={device} but the mesh is on "
                             f"{mesh.device_type}")
        self._layout = (
            moe.ExpertLayout(mesh, policy, cfg, "expert", serving=True)
            if self._is_moe else Layout(mesh, policy, cfg, serving=True))
        #: the weights are sharded over fsdp: gathered a layer at a time
        self._fsdp = bool(policy.fsdp_axis) and sizes.get(
            policy.fsdp_axis, 1) > 1
        specs = (moe.param_specs(cfg, policy) if self._is_moe
                 else llama.param_specs(cfg, policy))
        # the embedding replicated: decode reads one row a token, and a
        # vocab-sharded table would need a collective for it; a head of
        # its own (untied, or a tied model's int8 copy) is vocab-sharded
        specs["embed"] = (None, None)
        specs.setdefault("lm_head", (policy.fsdp_axis, policy.tensor_axis))
        self._specs = specs
        self._sizes = sizes

    def _leaf_spec(self, name: str) -> tuple:
        """A leaf's serving spec; a layer weight's without its [L] dim."""
        if name in self._specs:
            return tuple(self._specs[name])
        return tuple(self._specs["layers"][name][1:])

    @property
    def _block(self):
        """``init_params``' block: this rank's slices of each matrix."""
        if self.mesh is None:
            return None
        coord = mesh_lib.mesh_coordinate(self.mesh)

        def block(name, shape):
            spec = (self._specs[name] if name in self._specs
                    else self._specs["layers"][name])
            return tuple(slice(a, b) for a, b in mesh_lib.shard_index(
                tuple(spec), shape, self._sizes, coord))
        return block

    def _local_blocks(self, params: Params) -> Params:
        """This rank's blocks of a whole tree (on any device), on the
        engine's device; an int8 ``{"q", "s"}`` leaf's scales follow its
        output channels."""
        def leaf(spec, x):
            if isinstance(x, dict):
                return {"q": leaf(spec, x["q"]),
                        "s": leaf(spec[:-2] + spec[-1:], x["s"])}
            return mesh_lib.copy_to(
                mesh_lib.local_block(x, spec, self.mesh), self.device)

        return {k: ({n: leaf(tuple(self._specs["layers"][n]), w)
                     for n, w in v.items()} if k == "layers"
                    else leaf(tuple(self._specs[k]), v))
                for k, v in params.items()}

    def _absmax_reduce(self, name: str):
        """For int8 weights under a mesh: a weight whose contraction dim is
        sharded (row-parallel ``wo``, ``w_down``) takes its channel scales
        from the whole matrix, as the JAX engine (quantizing sharded
        arrays) does: the absmax's max over the ranks holding its rows."""
        if self.mesh is None:
            return None
        axes = [a for a in mesh_lib.entry_axes(self._leaf_spec(name)[-2])
                if self._sizes[a] > 1]
        if not axes:
            return None

        def reduce(amax):
            import torch.distributed as dist

            for a in axes:
                dist.all_reduce(amax, op=dist.ReduceOp.MAX,
                                group=self.mesh.get_group(a))
            return amax
        return reduce

    def follow(self) -> dict:
        """A follower rank's serving loop: runs rank 0's device operations
        until rank 0 closes (``{"ops", "checked"}``: operations run, rank
        0's token arrays checked equal to this rank's)."""
        if self._follower is None:
            raise RuntimeError("follow() is for the ranks other than 0 of a "
                               "sharded engine")
        # once: the follower holds the engine, so the pair is let go
        follower, self._follower = self._follower, None
        return follower.run()

    def close(self) -> None:
        """Rank 0: end the followers' loops (after the engine's last
        step, from the thread that drives it).  Idempotent."""
        with self._op_lock:
            if self._leader is not None:
                self._leader.stop()
                self._leader = None

    def _op(self, name: str, **args):
        """Run device operation ``name`` (``_do_<name>``) with host
        ``args``, on every rank of a sharded engine: rank 0 broadcasts it
        first, and no other operation is sent or run meanwhile (from
        another thread of rank 0)."""
        with self._op_lock:
            if self._leader is not None:
                self._leader.send(name, args)
            self._ensure_kernels()
            return getattr(self, "_do_" + name)(**args)

    def _produced(self, kind: str, *arrays) -> None:
        if self._leader is not None:
            with self._op_lock:
                self._leader.produced(kind, *arrays)

    def _reset_device_state(self) -> None:
        """(Re-)allocate the KV cache and slot state.  Called at init and
        after a failed step."""
        if self.paged and isinstance(self._alloc, PrefixBlockAllocator):
            # the KV behind every cached key is about to go
            self._alloc.clear_cache()
        self._pending = None
        self._chunking = {}
        #: the slot generation whose per-window constants are on the device
        self._consts_gen = -1
        self._op("reset")

    def _do_reset(self) -> None:
        cfg, b = self.cfg, self.batch_size
        #: the KV heads this rank holds (all of them off a mesh)
        self._hkv = hkv = cfg.num_kv_heads // (
            self._layout.tsize if self._layout else 1)
        if self.paged:
            shape = (cfg.num_layers, self._alloc.num_blocks,
                     self._block_size, hkv, cfg.head_dim)
        else:
            shape = (cfg.num_layers, b, self.max_len, hkv, cfg.head_dim)

        def zeros():
            if self.kv_quantize == "int4":
                return {"q4": torch.zeros(shape[:-1] + (shape[-1] // 2,),
                                          dtype=torch.int8,
                                          device=self.device),
                        "s": torch.zeros(shape[:-1], dtype=torch.float32,
                                         device=self.device)}
            if self.kv_quant:
                return {"q": torch.zeros(shape, dtype=torch.int8,
                                         device=self.device),
                        "s": torch.zeros(shape[:-1], dtype=torch.float32,
                                         device=self.device)}
            return torch.zeros(shape, dtype=cfg.dtype, device=self.device)

        self._cache_k = None  # let the old cache go before the new one
        self._cache_v = None
        self._cache_k = zeros()
        self._cache_v = zeros()
        self._decode_consts = None
        #: each slot's last prefill logits, until its first token is drawn
        self._logits: Dict[int, torch.Tensor] = {}
        #: tokens in cache per slot (int32: the kernel's lengths type)
        self._lengths = torch.zeros((b,), dtype=torch.int32,
                                    device=self.device)
        # host mirror of _lengths: _emit's bookkeeping must not pay a
        # device->host copy per generated token
        self._host_lengths = np.zeros((b,), np.int64)
        self._last_token = torch.zeros((b,), dtype=torch.int64,
                                       device=self.device)
        self._active = torch.zeros((b,), dtype=torch.bool, device=self.device)
        #: on-device token history per slot (speculation's n-gram corpus);
        #: column max_len is a sink for the writes that fall past the span
        self._hist = torch.zeros((b, self.max_len + 1), dtype=torch.int64,
                                 device=self.device)

    # -- public API --------------------------------------------------------

    def submit(self, request: Request) -> Request:
        if self.draining:
            raise EngineDraining("engine is draining; not admitting")
        # clamp so prompt + generation always fit the cache
        request.max_new_tokens = max(min(request.max_new_tokens,
                                         self.max_len - 2), 1)
        self._queue.put(request)
        if self.telemetry is not None:
            self.telemetry.record_queue_depth(self._queue.qsize())
        return request

    def generate(self, tokens: List[int], **kw) -> Request:
        """Blocking helper: submit + run the loop until this request is done
        (single-threaded use / tests)."""
        req = Request(tokens=tokens, **kw)
        self.submit(req)
        while not req.done.is_set():
            self.step()
        return req

    def warmup(self, prompt_len: int = 8, max_new_tokens: int = 4) -> float:
        """Drive one tiny request end to end, after making the kernel's
        library present through the compile cache, so the first real
        request pays neither nvcc nor the card's first launches — the
        standby's warming step (elastic/standby.py).  Under a mesh, rank
        0 calls it and the ranks run its operations in lockstep.  Returns
        elapsed seconds."""
        t0 = time.time()
        self._ensure_kernels()
        self.generate(list(range(1, prompt_len + 1)),
                      max_new_tokens=max_new_tokens)
        return time.time() - t0

    def _ensure_kernels(self) -> None:
        names, self._kernels_pending = self._kernels_pending, ()
        for name in names:
            self.compile_cache.ensure(name)

    def run_forever(self) -> None:
        """Serving loop: step when there is work, block when idle.  A bad
        request must not kill the engine thread — fail the in-flight
        requests and keep serving.  Under a mesh a failed step ends the
        loop instead, with :attr:`failed` set: the other ranks may be
        waiting in a collective of the failed operation, so the replica
        cannot recover in place (the server then exits non-zero)."""
        while not self._stop:
            if not self.has_work():
                if self._leader is not None:
                    with self._op_lock:
                        self._leader.keepalive(self.KEEPALIVE_S)
                try:
                    req = self._queue.get(timeout=0.05)
                    self._queue.put(req)
                except queue.Empty:
                    continue
            try:
                self.step()
            except Exception as exc:  # noqa: BLE001 — the thread must live
                traceback.print_exc()
                # fail only the requests that were in flight, from HOST
                # state (a device update could itself raise)
                for slot_id, req in enumerate(self._slots):
                    if req is not None:
                        self._release_host(slot_id)
                        req.finish_reason = "error"
                        req.finished_at = time.time()
                        req.done.set()
                        if self.telemetry is not None:
                            self.telemetry.record_preemption("engine_error")
                            self.telemetry.record_finished(req)
                if self.mesh is not None:
                    self.failed = f"engine step failed on rank 0: {exc!r}"
                    logger.error("%s: this replica stops", self.failed)
                    return
                try:
                    self._reset_device_state()
                except Exception:  # noqa: BLE001 — runtime truly dead
                    traceback.print_exc()
                    time.sleep(0.5)  # don't spin hot; retry on next step
        self.close()

    def stop(self) -> None:
        self._stop = True

    def begin_drain(self) -> None:
        """Stop admitting, keep decoding what is in flight (idempotent)."""
        self.draining = True

    def end_drain(self) -> None:
        """Leave drain mode (an aborted migration, maintenance over): new
        work is admitted again, caches intact.  Idempotent."""
        self.draining = False

    @property
    def drained(self) -> bool:
        """True once drain mode is on and no request is queued, admitted
        or mid-dispatch: the replica can go with nothing dropped."""
        return self.draining and not self.has_work()

    def has_work(self) -> bool:
        return (any(s is not None for s in self._slots)
                or self._pending is not None or bool(self._chunking)
                or self._stalled is not None or self._admitting is not None
                or not self._queue.empty())

    # -- scheduling --------------------------------------------------------

    @property
    def wedged(self) -> bool:
        """True when ONE scheduling step has been stuck longer than the
        watchdog window (read from the HTTP thread)."""
        t0 = self._step_started_at
        return t0 is not None and time.time() - t0 > self._watchdog_s

    def step(self) -> None:
        """One scheduling iteration (see :meth:`_step`), stamped for the
        wedge watchdog."""
        self._step_started_at = time.time()
        try:
            self._step()
        finally:
            self._step_started_at = None

    def _step(self) -> None:
        """One scheduling iteration, software-pipelined over the device.

        A decode window's outputs are device tensors; the NEXT window needs
        only those, not the tokens.  So when a window is in flight, the
        next one is queued BEFORE the current one's tokens are copied to
        the host, and the copy plus the Python emit loop overlap device
        work.  Admission (prefill) only happens when NO window is in
        flight: a prefill writes cache rows that an in-flight window's
        end-of-window insert could clobber.
        """
        advanced = False
        if self._pending is not None:
            want_admit = (
                (self._stalled is not None or not self._queue.empty())
                and any(s is None for s in self._slots))
            nxt = None
            if not want_admit:
                self._advance_chunks()  # queued before nxt on the stream
                advanced = True
                nxt = self._dispatch_window(self._pending["remaining_after"])
            self._drain_window()
            self._finish_chunked()
            self._pending = nxt
            if nxt is not None:
                return
        self._admit()
        if not advanced:  # at most ONE chunk per step (decode-stall bound)
            self._advance_chunks()
        self._finish_chunked()
        decoding = [
            req for slot_id, req in enumerate(self._slots)
            if req is not None and slot_id not in self._chunking]
        if decoding:
            remaining = max(
                req.max_new_tokens - len(req.output) for req in decoding)
            self._pending = self._dispatch_window(remaining)

    def _advance_chunks(self) -> None:
        """Run at most ONE prefill chunk across all mid-chunking slots."""
        for slot_id, st in list(self._chunking.items()):
            if "logits" in st:
                continue  # complete; awaiting _finish_chunked
            req = self._slots[slot_id]
            if req is None or req.cancelled:
                del self._chunking[slot_id]
                if req is not None:
                    self._release(slot_id)
                    req.finish_reason = req.finish_reason or "cancelled"
                    req.finished_at = time.time()
                    req.done.set()
                    if self.telemetry is not None:
                        self.telemetry.record_finished(req)
                continue
            tokens, done = st["tokens"], st["done"]
            chunk = tokens[done:done + self.prefill_chunk]
            cbucket = self._bucket(len(chunk))
            padded = np.zeros((cbucket,), np.int64)
            padded[:len(chunk)] = chunk
            self._op("chunk", slot=slot_id, padded=padded,
                     length=len(chunk), prefix_len=done,
                     table_row=(self._tables_host[slot_id].copy()
                                if self.paged else None))
            st["done"] = done + len(chunk)
            if self.telemetry is not None:
                self.telemetry.record_prefill(len(chunk), cbucket)
                self.telemetry.record_prefill_backlog(self._chunk_backlog())
            if st["done"] >= len(tokens):
                st["logits"] = True  # the slot's logits wait on the device
                st["n"] = len(tokens)
            return

    def _finish_chunked(self) -> None:
        """Activate slots whose final prefill chunk has completed: sample
        the first token from the chunk's logits and open the slot for
        decode windows."""
        for slot_id, st in list(self._chunking.items()):
            if "logits" not in st:
                continue
            del self._chunking[slot_id]
            req = self._slots[slot_id]
            if req is None:
                continue
            self._publish_prefix(slot_id, st["n"])
            self._activate(slot_id, req, st["n"], st["tokens"])

    def _activate(self, slot_id: int, req: Request, n: int,
                  history: List[int], first: Optional[int] = None) -> None:
        """Open a prefilled slot for decode: its first token (sampled from
        the slot's prefill logits with the request's sampling, unless
        ``first`` is given), its token history seeded with ``history`` (the
        prompt); then emit the first token."""
        first = self._op("activate", slot=slot_id, n=n,
                         history=(list(history[:self.max_len - 2])
                                  if self.speculation else None),
                         temperature=req.temperature, top_p=req.top_p,
                         top_k=req.top_k or 0, first=first)
        self._produced("first", first)
        self._slots[slot_id] = req
        self._slots_gen += 1
        self._host_lengths[slot_id] = n
        self._emit(slot_id, req, first)

    def _do_activate(self, slot: int, n: int, history: Optional[List[int]],
                     temperature: float, top_p: float, top_k: int,
                     first: Optional[int]) -> int:
        if first is None:
            first = self._sample_first(self._logits.pop(slot), temperature,
                                       top_p, top_k)
        self._lengths[slot] = n
        self._last_token[slot] = first
        self._active[slot] = True
        if history is not None:
            self._record_history(slot, history, first)
        return first

    def _publish_prefix(self, slot_id: int, n: int) -> None:
        """Prefix-cache mode: publish the full blocks of a slot's finished
        n-token prompt for later prompts (no-ops for reused blocks)."""
        if not self.prefix_cache:
            return
        blocks = self._slot_blocks[slot_id]
        for i, bkey in enumerate(self._slot_prefix[slot_id][1]):
            if (i + 1) * self._block_size <= n and i < len(blocks):
                self._alloc.register(bkey, blocks[i])

    def _record_history(self, slot_id: int, tokens: List[int],
                        first: int) -> None:
        """Seed the slot's on-device token history (speculation's n-gram
        corpus): the prompt at positions [0, n), the first generated token
        at n.  The whole row is written, so a reused slot cannot leak its
        previous request's tokens into drafts."""
        n = min(len(tokens), self.max_len - 2)
        row = np.zeros((self.max_len + 1,), np.int64)
        row[:n] = tokens[:n]
        row[n] = first
        self._hist[slot_id] = torch.from_numpy(row).to(self.device)

    def _admit(self) -> None:
        for slot_id in range(self.batch_size):
            if self._slots[slot_id] is not None:
                continue
            req = self._stalled
            self._stalled = None
            if req is None:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    return
            self._admitting = req
            try:
                if (not req.cancelled and req.deadline is not None
                        and time.time() > req.deadline):
                    # expired while queued: evict before burning a prefill
                    req.cancel(reason="deadline")
                if req.cancelled:
                    req.finish_reason = req.finish_reason or "cancelled"
                    req.finished_at = time.time()
                    req.done.set()
                    if self.telemetry is not None:
                        self.telemetry.record_finished(req)
                    continue
                if self.paged and not self._reserve_blocks(slot_id, req):
                    # pool exhausted: hold at head of line until a release
                    # frees blocks (decode itself can never stall)
                    if (self.telemetry is not None
                            and not getattr(req, "_stall_counted", False)):
                        req._stall_counted = True
                        req._kv_stalled_at = time.time()
                        self.telemetry.record_preemption(
                            "kv_blocks_exhausted")
                    self._stalled = req
                    return
                try:
                    if req.prefill is not None:
                        self._insert_prefilled(slot_id, req)
                    elif (self.prefill_chunk is not None
                            and self._prompt_len(req) > self.prefill_chunk):
                        # long prompt: claim the slot now, prefill one chunk
                        # per step; the slot stays inactive until the last
                        # chunk yields the first token.  A prefix-cache hit
                        # starts past the reused rows.
                        self._slots[slot_id] = req
                        self._slots_gen += 1
                        self._mark_admitted(req)
                        self._chunking[slot_id] = {
                            "tokens": self._prompt_tokens(
                                req.tokens, req.max_new_tokens),
                            "done": self._slot_prefix[slot_id][0]}
                    else:
                        self._prefill(slot_id, req)
                except Exception:
                    # claim the slot so run_forever's handler fails this
                    # request and releases its KV blocks
                    if self._slots[slot_id] is None:
                        self._slots[slot_id] = req
                        self._slots_gen += 1
                    raise
            finally:
                self._admitting = None

    def _mark_admitted(self, req: Request) -> None:
        if req.admitted_at is None:
            req.admitted_at = time.time()
            if self.telemetry is not None:
                self.telemetry.record_admitted(
                    req.admitted_at - req.submitted_at,
                    trace_id=req.trace_id)
                if self.speculation:
                    # baseline of the decode span's spec-accept attributes
                    req._spec0 = (self.telemetry.spec_steps.value,
                                  self.telemetry.spec_accepted.value)

    def _prompt_tokens(self, tokens: List[int],
                       max_new_tokens: int) -> List[int]:
        """Prompt tokens that survive the cache budget clamp."""
        budget = max(self.max_len - max_new_tokens - 1, 1)
        return list(tokens[-budget:]) or [0]

    def _prompt_len(self, req: Request) -> int:
        if req.prefill is not None:
            return min(int(req.prefill["length"]), self.max_len - 2)
        return len(self._prompt_tokens(req.tokens, req.max_new_tokens))

    def _reserve_blocks(self, slot_id: int, req: Request) -> bool:
        n = self._prompt_len(req)
        bs = self._block_size
        need = -(-(n + req.max_new_tokens + 1) // bs)
        matched: List[int] = []
        keys: list = []
        if self.prefix_cache and req.prefill is None:
            tokens = self._prompt_tokens(req.tokens, req.max_new_tokens)
            keys = PrefixBlockAllocator.block_keys(tokens, bs)
            # at least one suffix token must remain: the prefill has to
            # produce the last position's logits
            matched = self._alloc.lookup(keys[: (n - 1) // bs])
        prefix_len = len(matched) * bs
        if req.prefill is None:
            # a colocated prefill writes a whole padded bucket (past the
            # reused prefix)
            need = max(need, (prefix_len + self._bucket(n - prefix_len)) // bs)
        need = min(need, self._blocks_per_slot)
        fresh = self._alloc.alloc(need - len(matched))
        if fresh is None:
            if matched:
                self._alloc.release(matched)  # undo the lookup's refs
            return False
        blocks = matched + fresh
        self._slot_blocks[slot_id] = blocks
        self._slot_prefix[slot_id] = (prefix_len, keys)
        self._tables_host[slot_id, :] = 0
        self._tables_host[slot_id, :need] = blocks
        return True

    def _bucket(self, n: int) -> int:
        for b in PREFILL_BUCKETS:
            if n <= b and b <= self.max_len:
                bucket = b
                break
        else:
            bucket = self.max_len
        if self.paged:
            bucket = max(bucket, self._block_size)  # whole blocks
        return bucket

    # -- prefill -------------------------------------------------------------

    def _prefill(self, slot_id: int, req: Request) -> None:
        """Whole-prompt prefill into ``slot_id`` (cache written in place);
        after a prefix-cache hit, a prefill of the suffix only, attending
        over the reused blocks."""
        self._mark_admitted(req)
        tokens = self._prompt_tokens(req.tokens, req.max_new_tokens)
        n = len(tokens)
        prefix_len = self._slot_prefix[slot_id][0]
        bucket = self._bucket(n - prefix_len)
        padded = np.zeros((bucket,), np.int64)
        padded[:n - prefix_len] = tokens[prefix_len:prefix_len + bucket]
        if prefix_len > 0:
            self._op("chunk", slot=slot_id, padded=padded,
                     length=n - prefix_len, prefix_len=prefix_len,
                     table_row=self._tables_host[slot_id].copy())
        else:
            self._op("prefill", slot=slot_id, padded=padded, length=n,
                     blocks=(list(self._slot_blocks[slot_id])
                             if self.paged else None))
        self._publish_prefix(slot_id, n)
        if self.telemetry is not None:
            # the suffix is what was computed
            self.telemetry.record_prefill(n - prefix_len, bucket)
        self._activate(slot_id, req, n, tokens)

    def _do_prefill(self, slot: int, padded: np.ndarray, length: int,
                    blocks: Optional[List[int]]) -> None:
        """Whole-prompt forward into ``slot``'s cache rows (paged: its
        ``blocks``); the logits wait for the slot's first token."""
        logits, ks, vs = _prompt_forward(
            self.params, self.cfg, torch.from_numpy(padded).to(self.device),
            length, padded.shape[0], layout=self._layout, layers=self._layers)
        self._install_rows(slot, ks[:, 0], vs[:, 0], blocks)
        self._logits[slot] = logits

    def _do_chunk(self, slot: int, padded: np.ndarray, length: int,
                  prefix_len: int, table_row: Optional[np.ndarray]) -> None:
        """One prefill chunk of ``slot`` against the cache (paged through
        ``table_row``); the logits wait for the slot's first token."""
        padded_t = torch.from_numpy(padded).to(self.device)
        if self.paged:
            logits = self._prefill_paged_chunk(padded_t, length, prefix_len,
                                               table_row)
        else:
            logits = self._prefill_dense_chunk(padded_t, length, prefix_len,
                                               slot)
        self._logits[slot] = logits

    def _install_rows(self, slot_id: int, ks, vs,
                      blocks: Optional[List[int]] = None) -> None:
        """Write K/V rows [L, rows, Hkv, D] at the start of a slot: dense,
        its first rows; paged, its first blocks (``blocks``, by default the
        slot's; ``rows`` a whole number of blocks)."""
        if self.paged:
            nblk = ks.shape[1] // self._block_size
            if blocks is None:
                blocks = self._slot_blocks[slot_id]
            bids = torch.tensor(blocks[:nblk], dtype=torch.int64,
                                device=self.device)

            def insert(leaf, rows):  # rows [L, nblk * BS, ...]
                leaf[:, bids] = rows.reshape(
                    (rows.shape[0], nblk, self._block_size) + rows.shape[2:])
        else:
            def insert(leaf, rows):
                leaf[:, slot_id, :rows.shape[1]] = rows

        _kv_map(self._cache_k, ks, insert)
        _kv_map(self._cache_v, vs, insert)

    def prefill_export(self, tokens: List[int],
                       max_new_tokens: int = 128) -> dict:
        """Prefill/decode disaggregation, the prefill side: the prompt's
        K/V ([L, n, Hkv, D] on the host) and last-position f32 logits,
        with no slot taken.  The prompt budget is :meth:`_prefill`'s, so
        a disaggregated prompt is cut exactly as a colocated one.  Under
        a mesh rank 0 calls it (from any thread) and every rank runs the
        forward of its shards (:meth:`_do_export`)."""
        max_new_tokens = max(min(max_new_tokens, self.max_len - 2), 1)
        toks = self._prompt_tokens(tokens, max_new_tokens)
        n = len(toks)
        bucket = self._bucket(n)
        padded = np.zeros((bucket,), np.int64)
        padded[:n] = toks[:bucket]
        return self._op("export", padded=padded, length=n)

    def _do_export(self, padded: np.ndarray, length: int) -> Optional[dict]:
        """The prompt forward of a prefill leg; under ``tensor`` each rank's
        K/V heads are gathered in head order (the logits are whole
        already).  Rank 0 returns the one-card export, a follower None."""
        logits, ks, vs = _prompt_forward(
            self.params, self.cfg, torch.from_numpy(padded).to(self.device),
            length, padded.shape[0], layout=self._layout, layers=self._layers)
        ks, vs = ks[:, 0, :length], vs[:, 0, :length]
        if self._layout is not None and self._layout.tensor is not None:
            ks, vs = (collectives.all_gather_list(t, 2, self.mesh,
                                                  self._layout.tensor)
                      for t in (ks, vs))
        if not self._is_rank0:
            return None
        logits = logits.cpu()
        return {"ks": ks.cpu(), "vs": vs.cpu(),
                # the logits let the decode side sample the first token
                # with the request's own sampling; first_token is the
                # greedy one for wire formats without logits
                "logits": logits, "first_token": int(torch.argmax(logits)),
                "length": length}

    def _insert_prefilled(self, slot_id: int, req: Request) -> None:
        """Prefill/decode disaggregation, the decode side: install a
        prefill replica's K/V into the slot (:meth:`_do_install`, on every
        rank) and start decoding from its first token."""
        self._mark_admitted(req)
        p = req.prefill
        n = int(p["length"])
        ks = torch.as_tensor(p["ks"])
        vs = torch.as_tensor(p["vs"])
        # a prefill replica with a larger max_len must not be able to crash
        # this engine: keep the newest rows that fit
        limit = self.max_len - 2
        if n > limit:
            ks, vs, n = ks[:, n - limit:], vs[:, n - limit:], limit
        logits = p.get("logits")
        if logits is not None:
            logits = torch.as_tensor(logits)
        if self.mesh is not None:
            # the operation's arguments go to every rank: compact host
            # copies (a pickled view would carry its whole storage)
            ks, vs = (t.cpu().clone(memory_format=torch.contiguous_format)
                      for t in (ks, vs))
            if logits is not None:
                logits = logits.cpu()
        self._op("install", slot=slot_id, ks=ks, vs=vs, logits=logits,
                 blocks=(list(self._slot_blocks[slot_id])
                         if self.paged else None))
        self._activate(
            slot_id, req, n,
            self._prompt_tokens(req.tokens, req.max_new_tokens)[:n],
            None if logits is not None else int(p["first_token"]))

    def _do_install(self, slot: int, ks: torch.Tensor, vs: torch.Tensor,
                    logits: Optional[torch.Tensor],
                    blocks: Optional[List[int]]) -> None:
        """Write a prefill replica's rows [L, n, Hkv, D] at the start of
        ``slot`` (paged: padded to whole blocks, into ``blocks``); under
        ``tensor`` this rank's heads of them.  The logits, when given,
        wait for the slot's first token."""
        if self._layout is not None and self._layout.tensor is not None:
            h0 = self.mesh.get_local_rank(self._layout.tensor) * self._hkv
            ks, vs = ks[:, :, h0:h0 + self._hkv], vs[:, :, h0:h0 + self._hkv]
        ks = ks.to(self.device, self.cfg.dtype)
        vs = vs.to(self.device, self.cfg.dtype)
        if self.paged:
            # pad to whole blocks, scattered into the slot's blocks
            pad = -ks.shape[1] % self._block_size
            ks = F.pad(ks, (0, 0, 0, 0, 0, pad))
            vs = F.pad(vs, (0, 0, 0, 0, 0, pad))
        self._install_rows(slot, ks, vs, blocks)
        if logits is not None:
            # the request's own temperature/top_p/top_k
            self._logits[slot] = logits.to(self.device, torch.float32)

    def _chunk_forward(self, padded, length: int, positions, kv_pos,
                       insert, gather):
        """Shared body of both chunk prefills: every layer inserts the
        chunk's K/V and attends over the gathered slot span; returns the
        last real position's f32 logits."""
        cfg = self.cfg
        x = _embed(self.params, cfg, padded)[None, :, :]
        token_mask = (torch.arange(padded.shape[0], device=self.device)
                      < length)[None, :]
        for l, lp in enumerate(self._layers):
            x = _suffix_layer(x, lp, cfg, positions, self._inv_freqs, kv_pos,
                              token_mask, _kv_layer(self._cache_k, l),
                              _kv_layer(self._cache_v, l), insert, gather,
                              self._layout)
        x = rms_norm(x, self.params["final_norm"], cfg.rms_eps)
        return _logits(x[0, length - 1, :], self.params, cfg, self._layout)

    def _prefill_dense_chunk(self, padded, chunk_len: int, prefix_len: int,
                             slot: int):
        """One chunk of a long prompt against the DENSE cache: writes the
        chunk's K/V at rows [prefix_len, prefix_len + chunk_len) of the
        slot (bucket padding is not written) and attends the chunk over
        everything the slot holds so far."""
        span = self.max_len
        cbucket = padded.shape[0]
        positions = prefix_len + torch.arange(
            cbucket, device=self.device)[None, :]
        kv_pos = torch.arange(span, device=self.device)[None, :]
        n_write = min(chunk_len, span - prefix_len)

        def insert(leaf, rows):  # leaf [B, S, ...], rows [1, cbucket, ...]
            leaf[slot, prefix_len:prefix_len + n_write] = rows[0, :n_write]

        def gather(layer_kv):
            return _tree_map(lambda t: t[slot:slot + 1], layer_kv)

        return self._chunk_forward(padded, chunk_len, positions, kv_pos,
                                   insert, gather)

    def _prefill_paged_chunk(self, padded, chunk_len: int, prefix_len: int,
                             tables_row: np.ndarray):
        """One chunk against the PAGED cache: scatters the chunk's K/V rows
        into the slot's blocks (padding rows past the span land in the
        NULL block) and attends over the slot's gathered block span."""
        bs, bps = self._block_size, self._blocks_per_slot
        kv_span = bps * bs
        sbucket = padded.shape[0]
        idx = prefix_len + np.arange(sbucket)
        blk = np.where(idx < kv_span,
                       tables_row[np.clip(idx // bs, 0, bps - 1)], 0)
        blk_t = torch.from_numpy(blk.astype(np.int64)).to(self.device)
        off_t = torch.from_numpy((idx % bs).astype(np.int64)).to(self.device)
        table_t = torch.from_numpy(tables_row.astype(np.int64)).to(self.device)
        positions = torch.from_numpy(idx).to(self.device)[None, :]
        kv_pos = torch.arange(kv_span, device=self.device)[None, :]

        def insert(leaf, rows):  # leaf [NB, BS, ...], rows [1, sbucket, ...]
            leaf[blk_t, off_t] = rows[0]

        def gather(layer_kv):
            return _tree_map(lambda t: t[table_t].reshape(
                (kv_span,) + t.shape[2:])[None], layer_kv)

        return self._chunk_forward(padded, chunk_len, positions, kv_pos,
                                   insert, gather)

    # -- decode --------------------------------------------------------------

    def _sample_on_device(self, logits, temps, top_ps, top_ks, uniform):
        """Temperature/top-k/nucleus sampling on the device.

        A top-k prefilter (k = min(1024, V)) bounds the sort; per-request
        ``top_ks`` (0 = off) masks within it; the nucleus keeps the
        smallest prefix whose mass reaches top_p (the first token always).
        ``uniform`` [B, k] in [0, 1) is the Gumbel noise's source (from the
        engine's generator; tests feed their own).  Greedy at temp <= 0.
        """
        k = min(1024, self.cfg.vocab_size)
        vals, idx = torch.topk(logits, k, dim=-1)        # [B, k] descending
        scaled = vals / temps.clamp_min(1e-6)[:, None]
        rank = torch.arange(k, device=logits.device)[None, :]
        scaled = torch.where(
            (top_ks[:, None] <= 0) | (rank < top_ks[:, None]),
            scaled, -torch.inf)
        probs = torch.softmax(scaled, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_ps[:, None]
        masked = torch.where(keep, scaled, -torch.inf)
        gumbel = -torch.log(-torch.log(uniform.clamp(1e-20, 1.0)) + 1e-20)
        choice = torch.argmax(masked + gumbel, dim=-1)
        sampled = torch.gather(idx, 1, choice[:, None])[:, 0]
        return torch.where(temps > 0.0, sampled, idx[:, 0])

    def _noise(self, shape):
        k = min(1024, self.cfg.vocab_size)
        return torch.rand(shape + (k,), generator=self._gen,
                          device=self.device)

    def _decode_window(self, temps, top_ps, top_ks, tables, uniform, *,
                       window: int, sampling: bool, kv_blocks: int):
        """Decode ``window`` steps for every slot with a write-once cache.

        The big cache is READ-ONLY for the whole window: each step's K/V
        goes into a small [L, W, B, Hkv, D] window buffer, attention runs
        over (cache rows < base_len) + (window rows <= this step), and the
        cache absorbs the W rows in ONE write at the end.  ``base_len`` is
        frozen for the window.

        Paged: the cache half is the paged-decode kernel's normalised
        (o, lse) over the slot's first ``kv_blocks`` table columns (the
        ragged bucket); the window half is plain torch; the two merge by
        logsumexp.  Dense: one softmax over the concatenated scores.
        Paged int4, which the kernel does not read: the dense math over a
        view of each slot's ``kv_blocks`` blocks, gathered (packed) once
        for the window.

        Returns (tokens [W, B], last token [B], new lengths [B]); the
        cache is written in place and no value is read back to the host.
        """
        cfg = self.cfg
        b, w, dev = self.batch_size, window, self.device
        hkv, group = self._hkv, cfg.num_heads // cfg.num_kv_heads
        scale = cfg.head_dim ** -0.5
        lengths, active = self._lengths, self._active
        base_len = torch.clamp(lengths, max=self.max_len - 1)
        kv_span = kv_blocks * self._block_size if self.paged else self.max_len
        cache_mask = (torch.arange(kv_span, device=dev)[None, :]
                      < base_len[:, None])[:, None, None, :]
        use_kernel = self.paged and self.kv_quantize != "int4"
        self._ensure_kernels()
        view_k, view_v = self._cache_k, self._cache_v
        if self.paged and not use_kernel:
            # [L, B, span, ...] linear views, read-only until the insert
            idx = tables.long()
            view_k, view_v = (_tree_map(lambda t: t[:, idx].reshape(
                (cfg.num_layers, b, kv_span) + t.shape[3:]), c)
                for c in (self._cache_k, self._cache_v))
        win_k = torch.zeros((cfg.num_layers, w, b, hkv, cfg.head_dim),
                            dtype=cfg.dtype, device=dev)
        win_v = torch.zeros_like(win_k)
        last, step_lengths = self._last_token, lengths
        tokens_all = []
        for i in range(w):
            positions = torch.clamp(step_lengths, max=self.max_len - 1)[:, None]
            x = _embed(self.params, cfg, last)[:, None, :]
            for l, lp in enumerate(self._layers):
                q, k, v = _qkv(x, lp, cfg, positions, self._inv_freqs)
                win_k[l, i] = k[:, 0]
                win_v[l, i] = v[:, 0]
                # window rows 0..i are visible at step i; the rows past i
                # are left out instead of masked
                wk, wv = win_k[l, :i + 1], win_v[l, :i + 1]
                qg = q.reshape(b, hkv, group, cfg.head_dim)
                layer_k = _kv_layer(view_k, l)
                layer_v = _kv_layer(view_v, l)
                if use_kernel:
                    o_c, lse_c = paged_decode_attention(
                        qg, layer_k, layer_v, tables, base_len, scale=scale)
                    s_w = (torch.einsum("bhgd,jbhd->bhgj", qg, wk)
                           * scale).float()
                    m_w = s_w.amax(dim=-1)
                    p_w = torch.exp(s_w - m_w[..., None])
                    l_w = p_w.sum(dim=-1)
                    o_w = torch.einsum("bhgj,jbhd->bhgd", p_w.to(x.dtype),
                                       wv).float() / l_w[..., None]
                    lse_w = m_w + torch.log(l_w)
                    # an empty cache half has lse_c = -1e30: weight 0
                    lse = torch.logaddexp(lse_c, lse_w)
                    attn = (o_c * torch.exp(lse_c - lse)[..., None]
                            + o_w * torch.exp(lse_w - lse)[..., None]
                            ).to(x.dtype)
                else:
                    lk = _kv_mat(layer_k, x.dtype)
                    lv = _kv_mat(layer_v, x.dtype)
                    s_c = torch.einsum("bhgd,bkhd->bhgk", qg, lk) * scale
                    s_c = torch.where(cache_mask, s_c, _NEG_INF)
                    s_w = torch.einsum("bhgd,jbhd->bhgj", qg, wk) * scale
                    probs = torch.softmax(
                        torch.cat([s_c, s_w], dim=-1).float(),
                        dim=-1).to(x.dtype)
                    attn = (torch.einsum("bhgk,bkhd->bhgd",
                                         probs[..., :kv_span], lv)
                            + torch.einsum("bhgj,jbhd->bhgd",
                                           probs[..., kv_span:], wv))
                x = _layer_tail(x, attn, lp, cfg, layout=self._layout)
            x = rms_norm(x, self.params["final_norm"], cfg.rms_eps)
            logits = _logits(x, self.params, cfg, self._layout)[:, 0]
            if sampling:
                last = self._sample_on_device(logits, temps, top_ps, top_ks,
                                              uniform[i])
            else:
                last = torch.argmax(logits, dim=-1)
            tokens_all.append(last)
            step_lengths = torch.where(active, step_lengths + 1, step_lengths)

        pos = base_len[:, None] + torch.arange(w, device=dev)[None, :]  # [B, W]
        if self.paged:
            # row-wise scatter of the W new rows into each slot's blocks;
            # inactive slots (released, or mid-chunked-prefill) and rows
            # past the span write the NULL block instead
            bs = self._block_size
            safe = (pos < kv_span) & active[:, None]
            blk_col = torch.clamp(pos // bs, 0, kv_blocks - 1)
            phys = torch.where(safe, torch.gather(tables, 1, blk_col),
                               0).long()
            off = pos % bs

            def write(leaf, rows):  # leaf [L, NB, BS, ...], rows [L, W, B, ...]
                leaf[:, phys, off] = rows.transpose(1, 2)

            _kv_map(self._cache_k, win_k, write)
            _kv_map(self._cache_v, win_v, write)
        else:
            # cache row p takes window row p - base_len wherever
            # base_len <= p < base_len + W (and the slot is active)
            kv_index = torch.arange(self.max_len, device=dev)[None, :]
            widx = torch.clamp(kv_index - base_len[:, None], 0, w - 1).long()
            sel = ((kv_index >= base_len[:, None])
                   & (kv_index < base_len[:, None] + w) & active[:, None])
            _dense_window_insert(self._cache_k, win_k, widx, sel)
            _dense_window_insert(self._cache_v, win_v, widx, sel)
        return torch.stack(tokens_all), last, step_lengths

    def _decode_window_spec(self, *, window: int, k: int):
        """Greedy decode window with n-gram (prompt-lookup) speculation.

        Each step verifies ``k`` draft tokens plus the real one in ONE
        (k+1)-wide forward: the drafts are the k tokens that followed the
        latest earlier occurrence of the slot's current bigram in its
        on-device history; the forward gives the greedy token at all k+1
        positions, and the longest matching draft prefix is accepted, so
        a step emits 1..k+1 tokens for one pass over the weights.

        The window K/V buffer has ``window * (k+1)`` columns whose
        validity is ``win_pos`` ([B, cols] positions, -1 = invalid).  Rows
        are written optimistically before acceptance is known and
        invalidated after: a query at draft depth j is only used when
        drafts 1..j were accepted, and then every row it attended was
        real.  Accepted positions of successive steps are disjoint, so the
        end-of-window insert maps each position to one column.  Greedy
        and dense only.  Everything stays on the device: the steps queue
        with no host sync, as the plain window's do.

        Returns (tokens [W, B, k+1], accepted [W, B], last token [B], new
        lengths [B]); the cache and the history are written in place.
        """
        cfg = self.cfg
        b, dev, span = self.batch_size, self.device, self.max_len
        hkv, group = self._hkv, cfg.num_heads // cfg.num_kv_heads
        scale = cfg.head_dim ** -0.5
        active = self._active
        cur_len = self._lengths.long()
        base_len = torch.clamp(cur_len, max=span - 1)
        kv_index = torch.arange(span, device=dev)[None, :]
        cache_mask = (kv_index < base_len[:, None])[:, None, None, None, :]
        wc = window * (k + 1)
        win_k = torch.zeros((cfg.num_layers, wc, b, hkv, cfg.head_dim),
                            dtype=cfg.dtype, device=dev)
        win_v = torch.zeros_like(win_k)
        win_pos = torch.full((b, wc), -1, dtype=torch.int64, device=dev)
        jj = torch.arange(k + 1, device=dev)[None, :]
        pos_r = torch.arange(span - 1, device=dev)[None, :]
        rows = torch.arange(b, device=dev)[:, None]
        hist = self._hist
        last = self._last_token
        toks, accs = [], []
        for i in range(window):
            # invariant: hist[cur_len] == last, so the bigram's first token
            # is hist[cur_len - 1]; earlier pairs start at p <= cur_len - 2
            prev = torch.gather(hist, 1,
                                torch.clamp(cur_len - 1, 0, span - 1)[:, None])
            m = ((hist[:, :span - 1] == prev)
                 & (hist[:, 1:span] == last[:, None])
                 & (pos_r < (cur_len - 1)[:, None]))
            found = m.any(dim=1) & (cur_len >= 2)
            p = (span - 2) - torch.argmax(m.flip(1).to(torch.int32), dim=1)
            didx = p[:, None] + 2 + jj[:, :k]
            drafts = torch.gather(hist, 1, torch.clamp(didx, 0, span - 1))
            drafts = torch.where(found[:, None] & (didx < cur_len[:, None]),
                                 drafts, -1)  # -1 is never accepted
            tokens_in = torch.cat([last[:, None], drafts.clamp_min(0)], dim=1)
            positions = torch.clamp(cur_len, max=span - 1)[:, None] + jj
            positions_c = torch.clamp(positions, max=span - 1)
            step_pos = torch.where(positions < span, positions, -1)
            col0, col1 = i * (k + 1), (i + 1) * (k + 1)
            win_pos[:, col0:col1] = step_pos  # optimistic validity
            # columns past this step's are all invalid: left out, not masked
            w_pos = win_pos[:, None, None, None, :col1]
            w_mask = (w_pos >= 0) & (w_pos <= positions[:, None, None, :, None])
            x = _embed(self.params, cfg, tokens_in)          # [B, k+1, D]
            for l, lp in enumerate(self._layers):
                q, kk, vv = _qkv(x, lp, cfg, positions_c, self._inv_freqs)
                win_k[l, col0:col1] = kk.transpose(0, 1)
                win_v[l, col0:col1] = vv.transpose(0, 1)
                qg = q.reshape(b, k + 1, hkv, group, cfg.head_dim)
                lk = _kv_mat(_kv_layer(self._cache_k, l), x.dtype)
                lv = _kv_mat(_kv_layer(self._cache_v, l), x.dtype)
                wk, wv = win_k[l, :col1], win_v[l, :col1]
                s_c = torch.einsum("bqhgd,bkhd->bhgqk", qg, lk) * scale
                s_c = torch.where(cache_mask, s_c, _NEG_INF)
                s_w = torch.einsum("bqhgd,wbhd->bhgqw", qg, wk) * scale
                s_w = torch.where(w_mask, s_w, _NEG_INF)
                probs = torch.softmax(torch.cat([s_c, s_w], dim=-1).float(),
                                      dim=-1).to(x.dtype)
                attn = (torch.einsum("bhgqk,bkhd->bqhgd",
                                     probs[..., :span], lv)
                        + torch.einsum("bhgqw,wbhd->bqhgd",
                                       probs[..., span:], wv))
                x = _layer_tail(x, attn, lp, cfg, layout=self._layout)
            x = rms_norm(x, self.params["final_norm"], cfg.rms_eps)
            logits = _logits(x, self.params, cfg, self._layout)
            greedy = torch.argmax(logits, dim=-1)             # [B, k+1]
            match = (drafts == greedy[:, :k]).long()
            n_acc = torch.where(active, torch.cumprod(match, 1).sum(1), 0)
            # invalidate the draft rows past the accepted prefix, and every
            # row of an inactive slot
            step_valid = (jj <= n_acc[:, None]) & (step_pos >= 0) & active[:, None]
            win_pos[:, col0:col1] = torch.where(step_valid, step_pos, -1)
            # emitted tokens enter the history at positions + 1 (each greedy
            # token continues the position it was predicted at); the rest
            # land in the sink column
            wpos = torch.where(step_valid & (positions + 1 < span),
                               positions + 1, span)
            hist[rows, wpos] = greedy
            new_last = torch.gather(greedy, 1, n_acc[:, None])[:, 0]
            last = torch.where(active, new_last, last)
            cur_len = cur_len + torch.where(active, n_acc + 1, 0)
            toks.append(greedy)
            accs.append(n_acc)

        # end-of-window insert, keyed by each column's position
        eq = kv_index[:, :, None] == win_pos[:, None, :]       # [B, S, cols]
        sel = eq.any(dim=-1)
        widx = torch.argmax(eq.to(torch.int32), dim=-1)
        _dense_window_insert(self._cache_k, win_k, widx, sel)
        _dense_window_insert(self._cache_v, win_v, widx, sel)
        return (torch.stack(toks), torch.stack(accs), last,
                cur_len.to(self._lengths.dtype))

    def _pick_window(self, remaining: int) -> int:
        """Window size minimizing total tail cost = wasted device steps +
        per-window dispatch overhead (WINDOW_DISPATCH_COST_STEPS each)."""
        ws = sorted(self.DECODE_WINDOWS)
        if remaining >= ws[-1]:
            return ws[-1]
        f = self.WINDOW_DISPATCH_COST_STEPS

        def cost(r: int) -> int:
            if r <= 0:
                return 0
            return min((f + w - r) if w >= r else (f + cost(r - w))
                       for w in ws)

        best_w, best_c = ws[-1], None
        for w in ws:
            c = (f + w - remaining) if w >= remaining \
                else (f + cost(remaining - w))
            # ties break toward the LARGER window
            if best_c is None or c < best_c or (c == best_c and w > best_w):
                best_w, best_c = w, c
        return best_w

    def _ragged_blocks(self, window: int) -> int:
        """Block-table columns the NEXT decode window can touch, rounded up
        to a power of two.  Host lengths lag the device by the in-flight
        window, so its width is added back (this can only over-size).
        Under ``DSTACK_TPU_RAGGED_DECODE=0``, the full span."""
        if not self._ragged:
            return self._blocks_per_slot
        inflight = (self._pending["window"]
                    if self._pending is not None else 0)
        need = 0
        for slot_id, req in enumerate(self._slots):
            if req is None or slot_id in self._chunking:
                continue
            need = max(need,
                       int(self._host_lengths[slot_id]) + inflight + window)
        need = min(need, self.max_len)
        nbk = max(-(-need // self._block_size), 1)
        bucket = 1
        while bucket < nbk:
            bucket *= 2
        return min(bucket, self._blocks_per_slot)

    def _dispatch_window(self, remaining: int):
        """Queue one decode window; returns the pending record ({tokens,
        window, remaining_after, decoding}) or None."""
        if remaining <= 0 or not any(
                req is not None and slot_id not in self._chunking
                for slot_id, req in enumerate(self._slots)):
            return None
        window = self._pick_window(remaining)
        sampling = any(
            req is not None and req.temperature > 0.0 for req in self._slots)
        if self.speculation and not sampling:
            return self._dispatch_window_spec(remaining, window)
        nbk = self._ragged_blocks(window) if self.paged else 0
        # per-slot constants, copied to the device once per slot assignment
        consts = None
        if self._consts_gen != self._slots_gen:
            self._consts_gen = self._slots_gen
            slots = self._slots
            consts = ([r.temperature if r else 0.0 for r in slots],
                      [r.top_p if r else 1.0 for r in slots],
                      [r.top_k if r else 0 for r in slots],
                      self._tables_host.copy() if self.paged else None)
        # queuing a window is host work of the same order as running it, so
        # the inter-token clock starts before it, not after
        t0 = time.time()
        tokens_all = self._op("window", window=window, sampling=sampling,
                              nbk=nbk, consts=consts)
        # which slots this window decodes for: by drain time a mid-chunking
        # slot may have finished its prefill, but its rows here are junk
        decoding = frozenset(
            slot_id for slot_id, req in enumerate(self._slots)
            if req is not None and slot_id not in self._chunking)
        pending = {"tokens": tokens_all, "window": window,
                   "remaining_after": remaining - window,
                   "decoding": decoding}
        if self.telemetry is not None:
            self._record_dispatch(len(decoding), pending, t0)
        return pending

    def _do_window(self, window: int, sampling: bool, nbk: int,
                   consts: Optional[tuple]) -> torch.Tensor:
        """Queue one decode window (:meth:`_decode_window`); ``consts``
        (temperatures, top-p, top-k, the block tables) when the slots
        changed since the last window."""
        if consts is not None:
            temps, top_ps, top_ks, tables = consts

            def dev(values, dtype):
                return torch.tensor(values, dtype=dtype, device=self.device)

            self._decode_consts = (
                dev(temps, torch.float32), dev(top_ps, torch.float32),
                dev(top_ks, torch.int64),
                torch.tensor(tables, device=self.device)
                if tables is not None else None)
        temps, top_ps, top_ks, tables_full = self._decode_consts
        # the ragged bucket is a column slice: row stride stays the full
        # table's, which the kernel takes as an argument
        tables = tables_full[:, :nbk] if self.paged else None
        uniform = self._noise((window, self.batch_size)) if sampling else None
        tokens_all, self._last_token, self._lengths = self._decode_window(
            temps, top_ps, top_ks, tables, uniform, window=window,
            sampling=sampling, kv_blocks=nbk)
        self.decode_steps += window
        return tokens_all

    def _do_window_spec(self, window: int, k: int) -> tuple:
        """Queue one speculative window (:meth:`_decode_window_spec`)."""
        toks, accs, self._last_token, self._lengths = \
            self._decode_window_spec(window=window, k=k)
        self.decode_steps += window
        return toks, accs

    def _dispatch_window_spec(self, remaining: int, window: int):
        """Queue a speculative greedy window (:meth:`_decode_window_spec`).
        A step emits 1..k+1 tokens per slot, so the drain walks the
        accepted counts; ``remaining_after`` counts the one token a step
        always gives (tokens past a request's end are dropped, as the plain
        window's overshoot is)."""
        t0 = time.time()
        toks, accs = self._op("window_spec", window=window,
                              k=self.speculation_k)
        decoding = frozenset(
            slot_id for slot_id, req in enumerate(self._slots)
            if req is not None and slot_id not in self._chunking)
        pending = {"tokens": toks, "accepted": accs, "window": window,
                   "remaining_after": remaining - window,
                   "decoding": decoding, "spec": True}
        if self.telemetry is not None:
            self._record_dispatch(len(decoding), pending, t0)
        return pending

    def _kv_used_fraction(self) -> float:
        """KV capacity in use: allocated blocks over the usable pool
        (paged; prefix blocks parked for reuse count as used — they hold
        live KV) or cached rows over batch * max_len (dense)."""
        if self.paged:
            usable = self._alloc.num_blocks - 1  # block 0 is the NULL block
            return (usable - self._alloc.free_blocks) / max(usable, 1)
        return (float(self._host_lengths.sum())
                / max(self.batch_size * self.max_len, 1))

    def _record_dispatch(self, n_decoding: int, pending: dict,
                         t0: float) -> None:
        t = self.telemetry
        t.record_window(n_decoding, self.batch_size)
        t.record_kv_utilization(self._kv_used_fraction())
        t.record_queue_depth(self._queue.qsize())
        t.record_prefill_backlog(self._chunk_backlog())
        pending["t0"] = t0

    def _chunk_backlog(self) -> int:
        return sum(
            max(len(st["tokens"]) - st["done"], 0)
            for st in self._chunking.values() if "logits" not in st)

    def _drain_window(self) -> None:
        """Copy the in-flight window's tokens to the host and emit them —
        the ONE device->host sync per window.  A speculative window's step
        emits its first ``accepted + 1`` tokens ([W, B, k+1]), a plain
        window's step one ([W, B])."""
        p = self._pending
        if p is None:
            return
        self._pending = None
        tokens_np = p["tokens"].cpu().numpy()
        if p.get("spec"):
            accs_np = p["accepted"].cpu().numpy()             # [W, B]
            self._produced("window", tokens_np, accs_np)
            self._count_spec(p, accs_np)
        else:
            self._produced("window", tokens_np)
            tokens_np = tokens_np[..., None]
            accs_np = np.zeros(tokens_np.shape[:2], np.int64)
        emitted = 0
        for step in range(p["window"]):
            for slot_id, req in enumerate(self._slots):
                if req is None or slot_id not in p["decoding"]:
                    # finished mid-window (overshoot) or still prefilling
                    # when the window was queued
                    continue
                for j in range(int(accs_np[step, slot_id]) + 1):
                    if self._slots[slot_id] is None:
                        break  # finished mid-step: drop the rest
                    self._host_lengths[slot_id] += 1  # mirrors the device
                    emitted += 1
                    self._emit(slot_id, req, int(tokens_np[step, slot_id, j]))
        if self.telemetry is not None and "t0" in p:
            self.telemetry.record_drain(emitted, time.time() - p["t0"],
                                        len(p["decoding"]))

    def _count_spec(self, p: dict, accs_np: np.ndarray) -> None:
        """Speculation's acceptance over a window's decoding slots: into
        ``spec_stats`` and the telemetry's counters."""
        cols = sorted(p["decoding"])
        if not cols:
            return
        steps_n = p["window"] * len(cols)
        accepted_n = int(accs_np[:, cols].sum())
        self.spec_stats["steps"] += steps_n
        self.spec_stats["accepted"] += accepted_n
        if self.telemetry is not None:
            self.telemetry.record_spec(steps_n, accepted_n)

    def _sample_first(self, logits, temperature: float, top_p: float,
                      top_k: int) -> int:
        """A request's FIRST token, from the same sampler as the decode
        windows; one int crosses to the host."""
        temps = torch.tensor([temperature], dtype=torch.float32,
                             device=self.device)
        top_ps = torch.tensor([top_p], dtype=torch.float32,
                              device=self.device)
        top_ks = torch.tensor([top_k], dtype=torch.int64,
                              device=self.device)
        uniform = (self._noise((1,)) if temperature > 0.0
                   else torch.zeros((1, min(1024, self.cfg.vocab_size)),
                                    device=self.device))
        return int(self._sample_on_device(logits[None, :], temps, top_ps,
                                          top_ks, uniform)[0])

    def _emit(self, slot_id: int, req: Request, token: int) -> None:
        if (not req.cancelled and req.deadline is not None
                and time.time() > req.deadline):
            req.cancel(reason="deadline")
        if req.cancelled:
            # discard this token and free the slot for the queue
            req.finish_reason = req.finish_reason or "cancelled"
            req.finished_at = time.time()
            self._release(slot_id)
            req.done.set()
            if self.telemetry is not None:
                self.telemetry.record_finished(req)
            return
        if req.first_token_at is None:
            req.first_token_at = time.time()
            if self.telemetry is not None:
                self.telemetry.record_first_token(
                    req.first_token_at - req.submitted_at,
                    trace_id=req.trace_id)
        req.output.append(token)
        if req.on_token is not None:
            req.on_token(token)
        hit_eos = req.eos_id is not None and token == req.eos_id
        length = int(self._host_lengths[slot_id]) + 1  # +1 for this token
        out_of_room = length >= self.max_len - 1
        if len(req.output) >= req.max_new_tokens or hit_eos or out_of_room:
            req.finish_reason = req.finish_reason or (
                "stop" if hit_eos else "length")
            req.finished_at = time.time()
            self._release(slot_id)
            req.done.set()
            if self.telemetry is not None:
                self.telemetry.record_finished(req)

    def _release(self, slot_id: int) -> None:
        self._release_host(slot_id)
        self._op("release", slot=slot_id)

    def _do_release(self, slot: int) -> None:
        self._active[slot] = False
        self._lengths[slot] = 0

    def _release_host(self, slot_id: int) -> None:
        """Host-side half of release (safe when the device is wedged)."""
        self._slots[slot_id] = None
        self._slots_gen += 1
        self._host_lengths[slot_id] = 0
        if self.paged and self._slot_blocks[slot_id]:
            # refcounted in prefix-cache mode (shared blocks park in the
            # allocator's LRU); plain free otherwise
            self._alloc.release(self._slot_blocks[slot_id])
            self._slot_blocks[slot_id] = []
            self._slot_prefix[slot_id] = (0, [])
            self._tables_host[slot_id, :] = 0
