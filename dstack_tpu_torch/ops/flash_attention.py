"""Flash attention on Hopper: the kernels' wrappers and their plain versions.

Two functions, each a hand-written CUDA kernel (built by ``_build.py``)
beside a plain PyTorch version of the same arithmetic.  A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises.

**Causal flash attention** (training): :func:`flash_attention` is causal
GQA attention over [B, S, H, D], differentiable through a
``torch.autograd.Function`` whose forward is ``csrc/flash_fwd.cu`` and
whose backward is ``csrc/flash_bwd.cu``.  The forward keeps only o and the
softmax logsumexp; the backward recomputes the probabilities from them.
With a ``window`` W each query i sees the keys j with 0 <= i - j < W (a
sliding-window layer): the kernels then walk only the key tiles that meet
the window, in an instantiation of their own.  v may be narrower than q
and k (multi-head latent attention: QK width 192, V width 128), in a
third instantiation, ``mla_fwd_kernel`` / ``mla_bwd_kernel``.
:func:`flash_attention_sharded` runs the same on each rank's rows and heads
of DTensors over a device mesh (the JAX package's ``shard_map`` wrapper).

**Paged decode attention** (serving): single-query GQA attention for the
serving engine's decode loop, read straight out of the paged KV pool
(serving/paging.py) through block tables: only the pages a slot owns
cross device memory, once, and no dense per-slot view is built.  The
kernel is ``csrc/paged_decode.cu``: a split-KV walk whose splits
(:func:`paged_decode_splits`) a second kernel merges by logsumexp
(:func:`paged_decode_merge_plain` is the merge's plain version);
``paged_decode_attention_plain`` computes the whole function by gathering
the pages into a dense view.  It
returns a NORMALISED output plus the softmax logsumexp, so the caller can
merge other attention pieces (the engine's in-window KV buffer) by
logsumexp without re-reading pages.  A slot with length 0 returns o = 0
and lse = -1e30: a finite sentinel (not -inf) whose weight under any
logsumexp merge is exactly 0 while the merge arithmetic stays NaN-free.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from dstack_tpu_torch.ops import _build

_NEG_INF = -1e30
#: head dims the paged-decode kernel is built for (any number of query heads
#: per kv head)
PAGED_HEAD_DIMS = tuple(range(16, 257, 16))
#: head dims the causal kernels are built for, and their row-block size
FLASH_HEAD_DIMS = (64, 128)
#: (QK width, V width) pairs the kernels are built for: the causal and
#: windowed ones at equal widths, latent attention's at 192 / 128
FLASH_WIDTHS = ((64, 64), (128, 128), (192, 128))
_FLASH_BLOCK = 64


# -- causal flash attention (training) ----------------------------------------


def supports(seq: int, head_dim: int, dtype: torch.dtype,
             group: int = 1) -> bool:
    """Whether the fused path takes this shape; the JAX package's rule
    (``dstack_tpu/ops/flash_attention.py`` ``supports``), copied so both
    route the same shapes: seq a multiple of 128 whose whole-sequence rows
    fit the TPU kernel's 10 MiB budget.  (On the card the kernel also needs
    head_dim in :data:`FLASH_HEAD_DIMS`; other head dims raise there.)"""
    del group  # kept for the reference's signature
    if seq < 128 or seq % 128:
        return False
    lanes = max(head_dim, 128)
    per_program = seq * lanes * (3 * dtype.itemsize + 4)
    return per_program <= 10 * 1024 * 1024


def kernel_takes(seq: int, d_qk: int, d_v: Optional[int] = None) -> bool:
    """Whether the card's kernels take this shape, whatever the TPU's
    budget (:func:`supports`): seq a positive multiple of 128 and the
    widths (``d_v`` None: equal to ``d_qk``) among :data:`FLASH_WIDTHS`.
    The kernels stream K/V tiles, so the sequence has no limit of theirs;
    the walk fuses where either rule holds."""
    d_v = d_qk if d_v is None else d_v
    return seq >= 128 and seq % 128 == 0 and (d_qk, d_v) in FLASH_WIDTHS


def _heads_first(x: torch.Tensor, group: int = 1) -> torch.Tensor:
    """[B, S, H, D] -> f32 [B, H * group, S, D], each head repeated
    ``group`` times in place (query head h reads kv head h // group)."""
    x = x.float().transpose(1, 2)
    return x.repeat_interleave(group, dim=1) if group > 1 else x


def _window(window: Optional[int], seq: int) -> Optional[int]:
    """The window that masks anything at ``seq``: None (causal) when it
    covers the whole sequence."""
    if window is None or window >= seq:
        return None
    if window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    return int(window)


def _causal_scores(q, k, scale, window: Optional[int] = None):
    """f32 [B, Hq, S, S] scores (q . k) * scale, -1e30 above the diagonal
    (and, with a ``window``, where i - j >= window)."""
    group = q.shape[2] // k.shape[2]
    s = torch.matmul(_heads_first(q), _heads_first(k, group).transpose(-1, -2))
    s = s * scale
    seq = q.shape[1]
    keep = torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril()
    if window is not None:
        keep = keep.triu(1 - window)
    return torch.where(keep, s, _NEG_INF)


def flash_attention_fwd_plain(q, k, v, scale: Optional[float] = None,
                              window: Optional[int] = None):
    """Plain version of the forward kernel: ``(o, lse)``.

    q/k [B, S, H, D], v [B, S, Hkv, Dv] (Dv may differ from D); o [B, S,
    Hq, Dv] in q's dtype, lse f32 [B, Hq, S].  The scale defaults to
    D^-0.5.  The kernel's numerics with one softmax pass over the
    whole row: s = (q . k) * scale in f32, -1e30 above the diagonal (and
    outside the ``window``), p = exp(s - m) summed in f32, p cast to v's
    dtype before PV, o = acc / l, lse = m + log(l)."""
    b, seq, hq, d = q.shape
    group = hq // k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    s = _causal_scores(q, k, scale, _window(window, seq))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), _heads_first(v, group))
    o = (acc / l).to(q.dtype).transpose(1, 2).contiguous()
    return o, (m + torch.log(l))[..., 0]


def flash_attention_bwd_plain(q, k, v, o, lse, do,
                              scale: Optional[float] = None,
                              window: Optional[int] = None):
    """Plain version of the backward kernel: ``(dq, dk, dv)`` from the
    forward's inputs, its ``(o, lse)`` and the output gradient ``do``
    (``window`` as the forward's).

    Recomputes p = exp(s - lse) (not autograd through the forward);
    delta = rowsum(do * o) in f32; dv = bf16(p)^T do; dp = do v^T;
    ds = bf16(p * (dp - delta)); dk = ds^T q * scale and dq = ds k * scale,
    dk/dv summed over each kv head's group in f32 before the cast."""
    b, seq, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
    p = torch.exp(_causal_scores(q, k, scale, _window(window, seq))
                  - lse[..., None])
    do_h = _heads_first(do)
    dv = torch.matmul(p.to(k.dtype).float().transpose(-1, -2), do_h)
    dp = torch.matmul(do_h, _heads_first(v, group).transpose(-1, -2))
    ds = (p * (dp - delta[..., None])).to(k.dtype).float()
    dk = torch.matmul(ds.transpose(-1, -2), _heads_first(q)) * scale
    dq = torch.matmul(ds, _heads_first(k, group)) * scale

    def kv_grad(x):  # [B, Hq, S, D] -> group sum -> [B, S, Hkv, D]
        x = x.reshape(b, hkv, group, seq, x.shape[-1]).sum(dim=2)
        return x.to(k.dtype).transpose(1, 2).contiguous()

    return (dq.to(q.dtype).transpose(1, 2).contiguous(), kv_grad(dk),
            kv_grad(dv))


def _check_flash(q, k, v, *others):
    """What the causal kernels take: bf16 [B, S, H, D] (and f32 lse and
    delta), (D, v's width) in FLASH_WIDTHS, S a multiple of the block, all
    on one device, contiguous and 16-byte aligned."""
    b, seq, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    if (d, dv) not in FLASH_WIDTHS:
        raise ValueError(f"the flash kernels are built for (head_dim, v's "
                         f"head_dim) in {FLASH_WIDTHS}, got ({d}, {dv})")
    if (seq % _FLASH_BLOCK or hq % hkv or k.shape != (b, seq, hkv, d)
            or v.shape != (b, seq, hkv, dv)):
        raise ValueError(f"unsupported flash shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    others = (v,) + others
    for t in (q, k) + others:
        if t.device != q.device:
            raise ValueError(f"flash_attention: all tensors must be on "
                             f"{q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention: tensors must be contiguous "
                             "and 16-byte aligned")
        if t.dim() == 4 and t.dtype != torch.bfloat16:
            raise ValueError("flash_attention: q, k, v, o and do must be "
                             "bf16 on the card")


def _launch(name: str, *args) -> None:
    """Launch ``csrc/<name>.cu`` on the current stream of the first
    argument's device: tensors pass as pointers, everything else as is.
    The raw stream handle and no device switch while that device is the
    current one keep the host's cost per launch low."""
    fn = _build.load(name)
    index = args[0].device.index
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        rc = fn(*ptrs, stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _latent_window(window: Optional[int], d: int, dv: int):
    """The window, refused at unequal widths: latent attention's kernels
    are causal only."""
    if window is not None and dv != d:
        raise ValueError(f"no windowed flash kernel at QK width {d}, V "
                         f"width {dv}")
    return window


def _flash_fwd_kernel(q, k, v, scale: float, window: Optional[int] = None):
    """``(o, lse)`` from ``csrc/flash_fwd.cu`` (its windowed instantiation
    when ``window`` masks anything)."""
    _check_flash(q, k, v)
    b, seq, hq, d = q.shape
    dv = v.shape[-1]
    window = _latent_window(_window(window, seq), d, dv)
    o = q.new_empty((b, seq, hq, dv))
    lse = torch.empty((b, hq, seq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, k, v, o, lse, b, seq, hq, k.shape[2], d, dv,
            window or 0, float(scale))
    if dv != d:
        flash_attention.mla_fwd_launches += 1
    elif window is None:
        flash_attention.fwd_launches += 1
    else:
        flash_attention.window_fwd_launches += 1
    return o, lse


def _flash_bwd_kernel(q, k, v, o, lse, do, scale: float,
                      window: Optional[int] = None):
    """``(dq, dk, dv)`` from ``csrc/flash_bwd.cu``: its pre-pass computes
    delta = rowsum(do * o) and zeroes an f32 dq accumulator, which the
    main kernel adds into by reduce-adds in no fixed order (so dq is not
    bitwise repeatable from run to run) and its post-pass rounds to
    bf16."""
    b, seq, hq, d = q.shape
    if lse.shape != (b, hq, seq) or lse.dtype != torch.float32:
        raise ValueError("lse must be f32 [B, Hq, S]")
    _check_flash(q, k, v, o, do, lse)
    d_v = v.shape[-1]
    if o.shape != do.shape or o.shape != (b, seq, hq, d_v):
        raise ValueError(f"o and do must be [B, S, Hq, {d_v}], got "
                         f"{tuple(o.shape)} and {tuple(do.shape)}")
    window = _latent_window(_window(window, seq), d, d_v)
    delta = torch.empty((b, hq, seq), dtype=torch.float32, device=q.device)
    dq_accum = torch.empty((b, seq, hq, d), dtype=torch.float32,
                           device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd", q, k, v, o, do, lse, delta, dq_accum, dq, dk, dv, b,
            seq, hq, k.shape[2], d, d_v, window or 0, float(scale))
    if d_v != d:
        flash_attention.mla_bwd_launches += 1
    elif window is None:
        flash_attention.bwd_launches += 1
    else:
        flash_attention.window_bwd_launches += 1
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Causal attention whose forward saves (q, k, v, o, lse) and whose
    backward runs the given backward function on them (``window``: as
    :func:`flash_attention`'s)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, fwd, bwd, window=None):
        o, lse = fwd(q, k, v, scale, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.bwd, ctx.window = scale, bwd, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, o, lse, do.contiguous(), ctx.scale,
                             ctx.window)
        return dq, dk, dv, None, None, None, None


def flash_attention_plain(q, k, v, scale: Optional[float] = None,
                          window: Optional[int] = None):
    """:func:`flash_attention` through the plain versions on any device
    (what the CPU runs; on the card, the yardstick the kernels are held
    to)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _Flash.apply(q, k, v, scale, flash_attention_fwd_plain,
                        flash_attention_bwd_plain, window)


def flash_attention(q, k, v, scale: Optional[float] = None,
                    window: Optional[int] = None):
    """Causal GQA attention, fused.  q, k: [B, S, H, D]; v: [B, S, Hkv,
    Dv].

    Differentiable: the backward recomputes the probabilities from the
    saved logsumexp.  Returns [B, S, Hq, Dv] in q's dtype; the scale
    defaults to D^-0.5.  Callers check :func:`supports` or
    :func:`kernel_takes` first.  CPU tensors take the plain versions; CUDA
    tensors launch ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (bf16,
    (D, Dv) in :data:`FLASH_WIDTHS`, contiguous) or raise.  ``window`` W:
    query i sees the keys j with 0 <= i - j < W (None, or a W of at least
    S: causal, the same launches; at unequal widths it raises).
    ``flash_attention.fwd_launches`` and ``.bwd_launches`` count the
    causal kernels' launches, ``.window_fwd_launches`` and
    ``.window_bwd_launches`` the windowed ones', ``.mla_fwd_launches`` and
    ``.mla_bwd_launches`` those at unequal widths.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(), scale,
                        _flash_fwd_kernel, _flash_bwd_kernel,
                        _window(window, q.shape[1]))


flash_attention.fwd_launches = 0
flash_attention.bwd_launches = 0
flash_attention.window_fwd_launches = 0
flash_attention.window_bwd_launches = 0
flash_attention.mla_fwd_launches = 0
flash_attention.mla_bwd_launches = 0


def flash_attention_sharded(mesh, q, k, v, *,
                            batch_axes=("dcn", "data", "fsdp"),
                            head_axis="tensor"):
    """:func:`flash_attention` over a device mesh: q, k, v are DTensors
    with the batch sharded over ``batch_axes`` (major first), the heads
    over ``head_axis`` and the sequence whole (redistributed there if
    placed otherwise).  Each rank runs the same kernels (the plain
    versions on the CPU) on its local shard, so the kernels never see a
    DTensor; the result is a DTensor placed as q.  v narrower than q (latent
    attention) is not ported under a mesh and raises."""
    from dstack_tpu_torch.parallel.mesh import shard_call

    if v.shape[-1] != q.shape[-1]:
        raise NotImplementedError(
            "latent attention (v narrower than q) under a device mesh is "
            "not ported")

    return shard_call(flash_attention, mesh,
                      (tuple(batch_axes), None, head_axis, None), q, k, v)


# -- paged decode attention (serving) -----------------------------------------


def _pages(pages):
    """(values, scales or None) of a bf16 pool or an int8 {"q","s"} pool."""
    if isinstance(pages, dict):
        if "q4" in pages:
            raise NotImplementedError(
                "paged_decode_attention reads bf16 or int8 pages; the "
                "engine decodes int4 pages through a gathered view")
        return pages["q"], pages["s"]
    return pages, None


def paged_decode_attention_plain(q, k_pages, v_pages, tables, lengths, *,
                                 scale: Optional[float] = None):
    """Gather-and-softmax version of :func:`paged_decode_attention` (same
    arguments and results).  int8 pages dequantise as (int8 -> f32) * scale
    cast to q's dtype, and p is cast to q's dtype before the PV product,
    as the kernel does."""
    kq, ks = _pages(k_pages)
    vq, vs = _pages(v_pages)
    b, hkv, group, d = q.shape
    nbk = tables.shape[1]
    bs = kq.shape[1]
    if scale is None:
        scale = d ** -0.5
    idx = tables.long()

    def gather(values, scales):
        rows = values[idx]                       # [B, NBK, BS, Hkv, D]
        if scales is not None:
            rows = (rows.float() * scales[idx][..., None]).to(q.dtype)
        return rows.reshape(b, nbk * bs, hkv, d).float()

    k = gather(kq, ks)
    v = gather(vq, vs)
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k) * scale
    valid = (torch.arange(nbk * bs, device=q.device)[None, :]
             < lengths[:, None])[:, None, None, :]
    s = torch.where(valid, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1)
    safe_l = torch.where(l > 0, l, 1.0)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(q.dtype).float(), v)
    o = o / safe_l[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(safe_l), _NEG_INF)
    return o, lse


def paged_decode_splits(nbk: int, batch: int, hkv: int, num_sms: int) -> int:
    """How many splits the kernel cuts each slot's table walk into.

    A function of host integers only (the table width NBK, B, Hkv and the
    card's SM count), never of the lengths, which stay on the device: as
    many splits as keep the (split, kv head, slot) grid within two CTAs
    per SM, each at least two table columns, so a table of three columns
    or fewer is walked in one split and needs no merge.  On an H100 the
    all-full table (8 slots, 8 kv heads, 32 columns) ran as fast at 2 and
    4 splits and slower at 6 and more, and the ragged burst ran fastest at
    4 (``chip_smoke.py``'s split sweep)."""
    want = max(1, min(2 * num_sms // max(batch * hkv, 1), nbk // 2))
    return -(-nbk // -(-nbk // want)) if nbk > 0 else 1


def paged_decode_split_ranges(nbk: int, splits: int):
    """The kernel's cut of table columns [0, nbk) into ``splits`` runs:
    split s walks columns [c0, c1), ``ceil(nbk / splits)`` columns each."""
    cols = -(-nbk // splits)
    return [(min(s * cols, nbk), min((s + 1) * cols, nbk))
            for s in range(splits)]


def paged_decode_merge_plain(o_parts, lse_parts):
    """Plain version of the merge kernel: ``(o, lse)`` from the splits'
    partials, o_parts f32 [B, Hkv, S, G, D] (each normalised over its own
    rows) and lse_parts f32 [B, Hkv, S, G], by logsumexp over S.  An empty
    partial (lse -1e30) weighs exactly 0; where every partial is empty, o
    is 0 and lse exactly -1e30."""
    m = lse_parts.amax(dim=2)
    empty = m <= _NEG_INF
    w = torch.where(empty[:, :, None], 0.0,
                    torch.exp(lse_parts - m[:, :, None]))
    wsum = w.sum(dim=2)
    safe = torch.where(empty, 1.0, wsum)
    o = (w[..., None] * o_parts).sum(dim=2) / safe[..., None]
    lse = torch.where(empty, _NEG_INF, m + torch.log(safe))
    return o, lse


def _check(q, kq, ks, vq, vs, tables, lengths):
    """What the kernel takes (every tensor on q's device): bf16 q [B, Hkv,
    G, D], 4-byte aligned, with D in :data:`PAGED_HEAD_DIMS` and any G;
    pages bf16 or int8 (f32 scales) [NB, BS, Hkv, D], 16-byte aligned (the
    kernel copies 16-byte chunks); int32 tables [B, NBK] with unit column
    stride; int32 lengths [B]; q and the pages contiguous."""
    dev = q.device
    for t in (kq, vq, tables, lengths, ks, vs):
        if t is not None and t.device != dev:
            raise ValueError("paged_decode_attention: all tensors must be on "
                             f"{dev}")
    if q.dtype != torch.bfloat16 or q.dim() != 4 or not q.is_contiguous():
        raise ValueError("q must be a contiguous bf16 [B, Hkv, G, D] tensor")
    b, hkv, group, d = q.shape
    if d not in PAGED_HEAD_DIMS or group < 1:
        raise ValueError(f"unsupported head shape G={group}, D={d}: the "
                         "kernel takes D a multiple of 16 up to 256")
    want = torch.int8 if ks is not None else torch.bfloat16
    shape = kq.shape
    for t in (kq, vq):
        if (t.dtype != want or t.dim() != 4 or t.shape != shape
                or shape[2] != hkv or shape[3] != d or not t.is_contiguous()):
            raise ValueError(f"pages must be contiguous {want} "
                             "[NB, BS, Hkv, D] tensors of one shape")
    if shape[1] < 1:
        raise ValueError("pages must hold at least one row")
    if ks is not None:
        for t in (ks, vs):
            if (t.dtype != torch.float32 or t.shape != shape[:3]
                    or not t.is_contiguous()):
                raise ValueError("int8 page scales must be contiguous f32 "
                                 "[NB, BS, Hkv] tensors")
    if (tables.dtype != torch.int32 or tables.dim() != 2
            or tables.shape[0] != b or tables.stride(1) != 1):
        raise ValueError("tables must be int32 [B, NBK] with unit column "
                         "stride (a column slice of a wider table is fine)")
    if (lengths.dtype != torch.int32 or lengths.shape != (b,)
            or not lengths.is_contiguous()):
        raise ValueError("lengths must be a contiguous int32 [B] tensor")
    if q.data_ptr() % 4:
        raise ValueError("q must be 4-byte aligned")
    if kq.data_ptr() % 16 or vq.data_ptr() % 16:
        raise ValueError("the pages must be 16-byte aligned")


def _paged_buffers(b: int, hkv: int, group: int, d: int, splits: int,
                   device):
    """``(o, lse, o_part, lse_part)``: o f32 [B, Hkv, G, D] and lse f32
    [B, Hkv, G] as views, and the addresses of the partials' scratch
    o_part f32 [B, Hkv, S, G, D] and lse_part f32 [B, Hkv, S, G] (empty when
    S = 1: the walk then writes o and lse itself), all in one
    ``torch.empty`` in the order o, o_part, lse, lse_part, so the two
    [..., D] arrays start 16-byte aligned.  The scratch lives as long as o
    and lse (it shares their storage)."""
    rows = b * hkv * group
    part_rows = rows * splits if splits > 1 else 0
    n_o = (rows + part_rows) * d
    buf = torch.empty(n_o + rows + part_rows, dtype=torch.float32,
                      device=device)
    o = buf.as_strided((b, hkv, group, d), (hkv * group * d, group * d, d, 1))
    lse = buf.as_strided((b, hkv, group), (hkv * group, group, 1), n_o)
    base = buf.data_ptr()
    return o, lse, base + 4 * rows * d, base + 4 * (n_o + rows)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _paged_decode_kernel(q, kq, ks, vq, vs, tables, lengths, scale,
                         splits: int):
    """``(o, lse)`` from ``csrc/paged_decode.cu`` at ``splits`` splits, on
    checked arguments (see :func:`_check`)."""
    b, hkv, group, d = q.shape
    o, lse, o_part, lse_part = _paged_buffers(b, hkv, group, d, splits,
                                              q.device)
    if scale is None:
        scale = d ** -0.5
    _launch("paged_decode", q, kq, vq, ks, vs, tables, tables.stride(0),
            lengths, o, lse, o_part, lse_part, b, hkv, group, d, kq.shape[1],
            tables.shape[1], splits, float(scale), int(ks is not None))
    return o, lse


def paged_decode_attention(q, k_pages, v_pages, tables, lengths, *,
                           scale: Optional[float] = None):
    """Paged single-token GQA decode attention over block tables.

    q: [B, Hkv, G, D] (query head h = kv * G + g); k_pages/v_pages:
    [NUM_BLOCKS, BS, Hkv, D] paged pools, or int8 ``{"q", "s"}`` dicts
    (scales [NUM_BLOCKS, BS, Hkv]); tables: int32 [B, NBK] table columns
    (0 = NULL block) — pass a column slice to bound the walk at a ragged
    bucket; lengths: int32 [B] valid KV rows per slot.

    Returns ``(o, lse)``: o float32 [B, Hkv, G, D] normalised over the
    slot's ``length`` rows, lse float32 [B, Hkv, G] (-1e30 where length is
    0, with o = 0).  CPU tensors take :func:`paged_decode_attention_plain`;
    CUDA tensors launch ``csrc/paged_decode.cu`` (bf16 q, bf16 or int8
    pages; see :func:`_check`) or raise.  On the card one call launches
    the split walk and, when :func:`paged_decode_splits` gives more than
    one split, the merge kernel after it; ``paged_decode_attention.
    launches`` counts calls that launched, once per call.  The lengths
    are never read on the host.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, tables,
                                            lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    kq, ks = _pages(k_pages)
    vq, vs = _pages(v_pages)
    _check(q, kq, ks, vq, vs, tables, lengths)
    b, hkv = q.shape[:2]
    splits = paged_decode_splits(tables.shape[1], b, hkv,
                                 _sm_count(q.device.index))
    o, lse = _paged_decode_kernel(q, kq, ks, vq, vs, tables, lengths, scale,
                                  splits)
    paged_decode_attention.launches += 1
    return o, lse


paged_decode_attention.launches = 0
