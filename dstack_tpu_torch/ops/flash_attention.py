"""Flash attention on Hopper: the kernels' wrappers and their plain versions.

Two functions, each a hand-written CUDA kernel (built by ``_build.py``)
beside a plain PyTorch version of the same arithmetic.  A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises.

**Causal flash attention** (training): :func:`flash_attention` is causal
GQA attention over [B, S, H, D], differentiable through a
``torch.autograd.Function`` whose forward is ``csrc/flash_fwd.cu`` and
whose backward is ``csrc/flash_bwd.cu``.  The forward keeps only o and the
softmax logsumexp; the backward recomputes the probabilities from them.

**Paged decode attention** (serving): single-query GQA attention for the
serving engine's decode loop, read straight out of the paged KV pool
(serving/paging.py) through block tables: only the pages a slot owns
cross device memory, once, and no dense per-slot view is built.  The
kernel is ``csrc/paged_decode.cu``; ``paged_decode_attention_plain``
computes the same function by gathering the pages into a dense view.  It
returns a NORMALISED output plus the softmax logsumexp, so the caller can
merge other attention pieces (the engine's in-window KV buffer) by
logsumexp without re-reading pages.  A slot with length 0 returns o = 0
and lse = -1e30: a finite sentinel (not -inf) whose weight under any
logsumexp merge is exactly 0 while the merge arithmetic stays NaN-free.
"""

from __future__ import annotations

from typing import Optional

import torch

from dstack_tpu_torch.ops import _build

_NEG_INF = -1e30
#: the paged-decode kernel keeps G * D accumulators over 128 threads, 8
#: per thread
_MAX_GROUP_X_DIM = 1024
#: head dims the causal kernels are built for, and their row-block size
FLASH_HEAD_DIMS = (64, 128)
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


def _heads_first(x: torch.Tensor, group: int = 1) -> torch.Tensor:
    """[B, S, H, D] -> f32 [B, H * group, S, D], each head repeated
    ``group`` times in place (query head h reads kv head h // group)."""
    x = x.float().transpose(1, 2)
    return x.repeat_interleave(group, dim=1) if group > 1 else x


def _causal_scores(q, k, scale):
    """f32 [B, Hq, S, S] scores (q . k) * scale, -1e30 above the diagonal."""
    group = q.shape[2] // k.shape[2]
    s = torch.matmul(_heads_first(q), _heads_first(k, group).transpose(-1, -2))
    s = s * scale
    seq = q.shape[1]
    keep = torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril()
    return torch.where(keep, s, _NEG_INF)


def flash_attention_fwd_plain(q, k, v, scale: Optional[float] = None):
    """Plain version of the forward kernel: ``(o, lse)``.

    q [B, S, Hq, D], k/v [B, S, Hkv, D]; o [B, S, Hq, D] in q's dtype, lse
    f32 [B, Hq, S].  The kernel's numerics with one softmax pass over the
    whole row: s = (q . k) * scale in f32, -1e30 above the diagonal,
    p = exp(s - m) summed in f32, p cast to v's dtype before PV,
    o = acc / l, lse = m + log(l)."""
    b, seq, hq, d = q.shape
    group = hq // k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    s = _causal_scores(q, k, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), _heads_first(v, group))
    o = (acc / l).to(q.dtype).transpose(1, 2).contiguous()
    return o, (m + torch.log(l))[..., 0]


def flash_attention_bwd_plain(q, k, v, o, lse, do,
                              scale: Optional[float] = None):
    """Plain version of the backward kernel: ``(dq, dk, dv)`` from the
    forward's inputs, its ``(o, lse)`` and the output gradient ``do``.

    Recomputes p = exp(s - lse) (not autograd through the forward);
    delta = rowsum(do * o) in f32; dv = bf16(p)^T do; dp = do v^T;
    ds = bf16(p * (dp - delta)); dk = ds^T q * scale and dq = ds k * scale,
    dk/dv summed over each kv head's group in f32 before the cast."""
    b, seq, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
    p = torch.exp(_causal_scores(q, k, scale) - lse[..., None])
    do_h = _heads_first(do)
    dv = torch.matmul(p.to(k.dtype).float().transpose(-1, -2), do_h)
    dp = torch.matmul(do_h, _heads_first(v, group).transpose(-1, -2))
    ds = (p * (dp - delta[..., None])).to(k.dtype).float()
    dk = torch.matmul(ds.transpose(-1, -2), _heads_first(q)) * scale
    dq = torch.matmul(ds, _heads_first(k, group)) * scale

    def kv_grad(x):  # [B, Hq, S, D] -> group sum -> [B, S, Hkv, D]
        x = x.reshape(b, hkv, group, seq, d).sum(dim=2)
        return x.to(k.dtype).transpose(1, 2).contiguous()

    return (dq.to(q.dtype).transpose(1, 2).contiguous(), kv_grad(dk),
            kv_grad(dv))


def _check_flash(q, k, *others):
    """What the causal kernels take: bf16 [B, S, H, D] (and f32 lse and
    delta), head_dim in FLASH_HEAD_DIMS, S a multiple of the block, all
    on one device, contiguous and 16-byte aligned."""
    b, seq, hq, d = q.shape
    hkv = k.shape[2]
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"the flash kernels are built for head_dim in "
                         f"{FLASH_HEAD_DIMS}, got {d}")
    if seq % _FLASH_BLOCK or hq % hkv or k.shape != (b, seq, hkv, d):
        raise ValueError(f"unsupported flash shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
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
    argument's device: tensors pass as pointers, everything else as is."""
    fn = _build.load(name)
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _flash_fwd_kernel(q, k, v, scale: float):
    """``(o, lse)`` from ``csrc/flash_fwd.cu``."""
    _check_flash(q, k, v)
    b, seq, hq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, seq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, k, v, o, lse, b, seq, hq, k.shape[2], d,
            float(scale))
    flash_attention.fwd_launches += 1
    return o, lse


def _flash_bwd_kernel(q, k, v, o, lse, do, scale: float):
    """``(dq, dk, dv)`` from ``csrc/flash_bwd.cu``: its pre-pass computes
    delta = rowsum(do * o) and zeroes an f32 dq accumulator, which the
    main kernel adds into by reduce-adds in no fixed order (so dq is not
    bitwise repeatable from run to run) and its post-pass rounds to
    bf16."""
    b, seq, hq, d = q.shape
    if lse.shape != (b, hq, seq) or lse.dtype != torch.float32:
        raise ValueError("lse must be f32 [B, Hq, S]")
    _check_flash(q, k, v, o, do, lse)
    delta = torch.empty((b, hq, seq), dtype=torch.float32, device=q.device)
    dq_accum = torch.empty((b, seq, hq, d), dtype=torch.float32,
                           device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd", q, k, v, o, do, lse, delta, dq_accum, dq, dk, dv, b,
            seq, hq, k.shape[2], d, float(scale))
    flash_attention.bwd_launches += 1
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Causal attention whose forward saves (q, k, v, o, lse) and whose
    backward runs the given backward function on them."""

    @staticmethod
    def forward(ctx, q, k, v, scale, fwd, bwd):
        o, lse = fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.bwd = scale, bwd
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, o, lse, do.contiguous(), ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention_plain(q, k, v, scale: Optional[float] = None):
    """:func:`flash_attention` through the plain versions on any device
    (what the CPU runs; on the card, the yardstick the kernels are held
    to)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _Flash.apply(q, k, v, scale, flash_attention_fwd_plain,
                        flash_attention_bwd_plain)


def flash_attention(q, k, v, scale: Optional[float] = None):
    """Causal GQA attention, fused.  q: [B, S, Hq, D]; k, v: [B, S, Hkv, D].

    Differentiable: the backward recomputes the probabilities from the
    saved logsumexp.  Returns [B, S, Hq, D] in q's dtype.  Callers check
    :func:`supports` first.  CPU tensors take the plain versions; CUDA
    tensors launch ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (bf16,
    head_dim 64 or 128, contiguous) or raise.  ``flash_attention.
    fwd_launches`` and ``.bwd_launches`` count the kernels' launches.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(), scale,
                        _flash_fwd_kernel, _flash_bwd_kernel)


flash_attention.fwd_launches = 0
flash_attention.bwd_launches = 0


# -- paged decode attention (serving) -----------------------------------------


def _pages(pages):
    """(values, scales or None) of a bf16 pool or an int8 {"q","s"} pool."""
    if isinstance(pages, dict):
        if "q4" in pages:
            raise NotImplementedError(
                "paged_decode_attention reads bf16 or int8 pages; int4 KV "
                "is not ported")
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


def _check(q, kq, ks, vq, vs, tables, lengths):
    dev = q.device
    tensors = [kq, vq, tables, lengths] + [t for t in (ks, vs) if t is not None]
    if any(t.device != dev for t in tensors):
        raise ValueError("paged_decode_attention: all tensors must be on "
                         f"{dev}")
    if q.dtype != torch.bfloat16 or q.dim() != 4 or not q.is_contiguous():
        raise ValueError("q must be a contiguous bf16 [B, Hkv, G, D] tensor")
    b, hkv, group, d = q.shape
    if d % 2 or group * d > _MAX_GROUP_X_DIM:
        raise ValueError(f"unsupported head shape G={group}, D={d}")
    want = torch.int8 if ks is not None else torch.bfloat16
    for t in (kq, vq):
        if (t.dtype != want or t.dim() != 4 or t.shape[2:] != (hkv, d)
                or t.shape != kq.shape or not t.is_contiguous()):
            raise ValueError(f"pages must be contiguous {want} "
                             "[NB, BS, Hkv, D] tensors of one shape")
    if ks is not None:
        for t in (ks, vs):
            if (t.dtype != torch.float32 or t.shape != kq.shape[:3]
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
    if any(t.data_ptr() % 4 for t in (q, kq, vq)):
        raise ValueError("q and the pages must be 4-byte aligned")


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
    CUDA tensors launch the Hopper kernel (bf16 q, bf16 or int8 pages) or
    raise.  ``paged_decode_attention.launches`` counts kernel launches.
    """
    kq, ks = _pages(k_pages)
    vq, vs = _pages(v_pages)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, tables,
                                            lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    _check(q, kq, ks, vq, vs, tables, lengths)
    b, hkv, group, d = q.shape
    if scale is None:
        scale = d ** -0.5
    o = torch.empty((b, hkv, group, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, hkv, group), dtype=torch.float32, device=q.device)
    _launch("paged_decode", q, kq, vq, ks, vs, tables, tables.stride(0),
            lengths, o, lse, b, hkv, group, d, kq.shape[1], tables.shape[1],
            float(scale), int(ks is not None))
    paged_decode_attention.launches += 1
    return o, lse


paged_decode_attention.launches = 0
