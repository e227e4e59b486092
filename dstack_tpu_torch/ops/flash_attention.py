"""Paged decode attention: the Hopper kernel's wrapper and its plain version.

Single-query GQA attention for the serving engine's decode loop, read
straight out of the paged KV pool (serving/paging.py) through block
tables: only the pages a slot owns cross device memory, once, and no
dense per-slot view is built.  The kernel is ``csrc/paged_decode.cu``
(built by ``_build.py``); ``paged_decode_attention_plain`` computes the
same function by gathering the pages into a dense view, for the CPU and
for holding the kernel to on the card.

Returns a NORMALISED output plus the softmax logsumexp, so the caller can
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
#: the kernel keeps G * D accumulators over 128 threads, 8 per thread
_MAX_GROUP_X_DIM = 1024


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
    fn = _build.load("paged_decode")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
                ks.data_ptr() if ks is not None else None,
                vs.data_ptr() if vs is not None else None,
                tables.data_ptr(), tables.stride(0), lengths.data_ptr(),
                o.data_ptr(), lse.data_ptr(), b, hkv, group, d,
                kq.shape[1], tables.shape[1], float(scale),
                int(ks is not None), stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{rc}")
    paged_decode_attention.launches += 1
    return o, lse


paged_decode_attention.launches = 0
