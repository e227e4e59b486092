"""The row kernel: RMSNorm over rows, and a split-halves rotation (RoPE)
after it, forward and backward in one pass each way, and their plain
versions.

The kernel is ``csrc/rownorm.cu`` (built by ``_build.py``): it reads bf16 or
f32 rows, computes in f32 registers and writes the rows' type, so nothing
f32 of a row's size goes through device memory but the backward's
weight-gradient partials.  It runs the norm alone (:func:`rmsnorm.rms_norm`'s
D-wide rows), the rotation alone, or both (:func:`rotary.qk_prologue`'s q
and k heads, both tensors in one launch).  :func:`rows_fwd_plain` and
:func:`rows_bwd_plain` are the same arithmetic in plain PyTorch: the CPU
tests hold them to autograd of the eager chain, and ``chip_smoke.py`` holds
the kernel to them on the card.

Numerics (kernel and plain versions alike): the eager chain's, step by
step.  The forward is ``x.float()``, the mean of squares, ``rsqrt(var +
eps)``, two products and the cast; the rotation ``x1 * cos - x2 * sin``,
``x2 * cos + x1 * sin`` on the normed row as its type holds it.  The
backward is autograd's: the rotation's transpose, the gradient cast to the
row's type where ``x.float()`` stood, then ``dn * r + ((-0.5 * dot) * r^3 /
n) * 2x`` with ``dn = g * w`` and ``dot`` the row sum of ``dn * x``, and
``dw`` the rows' sum of ``g * (x * r)``.  The kernel sums squares, ``dot``
and ``dw`` in another order than PyTorch; nothing else differs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

#: the backward's weight-gradient partial rows a streaming multiprocessor
#: may need (blocks of 256 threads resident on one)
_PART_ROWS_PER_SM = 8


def rotate_half(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """``x`` [..., n] rotated by split halves, in f32 with ``cos``/``sin``
    broadcast to ``x[..., :n/2]``; the result in ``x``'s dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def table_cos_sin(table: torch.Tensor) -> tuple:
    """(cos, sin) of a rotation table [2, P, S, n/2], each [P, S, 1, n/2]:
    broadcast over [B, S, H, n/2] heads."""
    return table[0][:, :, None, :], table[1][:, :, None, :]


def rows_fwd_plain(x: torch.Tensor, w: Optional[torch.Tensor],
                   table: Optional[torch.Tensor], eps: float) -> tuple:
    """``(y, rstd)``: ``x`` [..., n] normed by ``w`` [n] (None: no norm,
    rstd None), then rotated by ``table`` (None: not; else ``x`` is [B, S,
    H, n] and the table [2, P, S, n/2], P 1 or B).  rstd f32 [...], one a
    row."""
    y, rstd = x, None
    if w is not None:
        x32 = x.float()
        rstd = torch.rsqrt(x32.square().mean(dim=-1) + eps)
        y = ((x32 * rstd[..., None]) * w.float()).to(x.dtype)
    if table is not None:
        y = rotate_half(y, *table_cos_sin(table))
    return y, rstd


def rows_bwd_plain(x: torch.Tensor, w: Optional[torch.Tensor],
                   table: Optional[torch.Tensor],
                   rstd: Optional[torch.Tensor], dy: torch.Tensor) -> tuple:
    """``(dx, dw)`` of :func:`rows_fwd_plain` from its input ``x``, weight,
    table, its ``rstd`` and the output gradient ``dy`` (dw None without a
    norm)."""
    g = dy.float()
    if table is not None:
        cos, sin = table_cos_sin(table)
        g1, g2 = g.chunk(2, dim=-1)
        g = torch.cat([g1 * cos + g2 * sin, g2 * cos - g1 * sin], dim=-1)
        if w is None:
            return g.to(x.dtype), None
        g = g.to(x.dtype).float()
    n = x.shape[-1]
    x32 = x.float()
    r = rstd[..., None]
    dw = (g * (x32 * r)).reshape(-1, n).sum(dim=0).to(w.dtype)
    dn = g * w.float()
    dot = (dn * x32).sum(dim=-1, keepdim=True)
    coef = ((-0.5 * dot) * (r * r * r)) * (1.0 / n)
    dx = (dn * r + coef * (2.0 * x32)).to(x.dtype)
    return dx, dw


def _plain_fwd(xs, ws, table, eps, counter):
    outs = [rows_fwd_plain(x, w, table, eps) for x, w in zip(xs, ws)]
    return [y for y, _ in outs], [r for _, r in outs]


def _plain_bwd(xs, ws, table, rstds, dys, need_dw, counter):
    outs = [rows_bwd_plain(x, w, table, r, dy)
            for x, w, r, dy in zip(xs, ws, rstds, dys)]
    return ([dx for dx, _ in outs],
            [dw if need else None for (_, dw), need in zip(outs, need_dw)])


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(xs, ws, table) -> None:
    """What the kernel takes: one or two CUDA tensors of rows, bf16 or f32
    alike, n a multiple of two 16-byte chunks; weights [n] bf16 or f32
    alike, for every tensor or none; a rotation's rows [B, S, H, n] and its
    f32 table [2, P, S, n/2], P 1 or B; no DTensor (pass its local
    shard)."""
    x0 = xs[0]
    n = x0.shape[-1]
    for t in (*xs, *ws, table):
        if t is None:
            continue
        if hasattr(t, "to_local"):
            raise TypeError("the row kernel takes plain tensors; pass a "
                            "DTensor's local shard")
        if t.device != x0.device:
            raise ValueError(f"the row kernel's tensors must all be on "
                             f"{x0.device}")
    if any(x.dtype not in _DTYPES or x.dtype != x0.dtype for x in xs):
        raise ValueError(f"the row kernel takes bf16 or f32 rows of one "
                         f"dtype, got {[x.dtype for x in xs]}")
    chunk = 16 // x0.element_size()
    if n % (2 * chunk) or any(x.shape[-1] != n for x in xs):
        raise ValueError(f"the row kernel takes rows of one length, a "
                         f"multiple of {2 * chunk} for {x0.dtype}; got "
                         f"{[tuple(x.shape) for x in xs]}")
    if n // 2 // chunk > 1024:
        raise ValueError(f"the row kernel takes rows of at most "
                         f"{2048 * chunk} values, got {n}")
    if (ws[0] is None) != (ws[-1] is None):
        raise ValueError("the row kernel norms every tensor or none")
    if ws[0] is not None and any(
            w.dtype not in _DTYPES or w.dtype != ws[0].dtype
            or tuple(w.shape) != (n,) for w in ws):
        raise ValueError(f"the row kernel's weights must be bf16 or f32 "
                         f"[{n}] of one dtype")
    if table is not None:
        b, s = x0.shape[:2]
        if (any(x.dim() != 4 or x.shape[:2] != (b, s) for x in xs)
                or table.dtype != torch.float32 or table.dim() != 4
                or table.shape[0] != 2 or table.shape[1] not in (1, b)
                or tuple(table.shape[2:]) != (s, n // 2)):
            raise ValueError(
                f"a rotation takes [B, S, H, n] rows and an f32 [2, 1 or B, "
                f"S, n/2] table; got {[tuple(x.shape) for x in xs]} and "
                f"{tuple(table.shape)} {table.dtype}")
        if n // 2 // chunk > 512:
            raise ValueError(f"a rotation takes rows of at most "
                             f"{1024 * chunk} values, got {n}")


def _ready(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` contiguous and 16-byte aligned (a copy when it is not)."""
    if t is None:
        return None
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _pairs(items: Sequence, fill=None) -> list:
    """Two items: the tensors' own, or the first and ``fill``."""
    return [items[0], items[1] if len(items) > 1 else fill]


def _geometry(xs, table) -> list:
    """The entry point's sizes: each tensor's rows (0 for an absent
    second), n, each tensor's heads, S and P (1s without a rotation)."""
    n = xs[0].shape[-1]
    rows = _pairs([x.numel() // n for x in xs], 0)
    if table is None:
        return rows + [n, 1, 1, 1, 1]
    heads = _pairs([x.shape[2] for x in xs], 1)
    return rows + [n] + heads + [xs[0].shape[1], table.shape[1]]


def _kernel_fwd(xs, ws, table, eps, counter, keep=True):
    """``(ys, rstds)`` from one launch of ``csrc/rownorm.cu`` (rstd f32
    [...] a tensor when normed and ``keep``, else None)."""
    from dstack_tpu_torch.ops.flash_attention import _launch

    ys = [torch.empty_like(x) for x in xs]
    norm = ws[0] is not None
    rstds = [torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
             if norm and keep else None for x in xs]
    _launch("rownorm", *_pairs(xs), None, None, *_pairs(ys), *_pairs(ws),
            *_pairs(rstds), None, None, table, None, *_geometry(xs, table),
            _DTYPES[xs[0].dtype], _DTYPES[ws[0].dtype] if norm else 0, 0, 0,
            float(eps))
    counter.launches += 1
    if table is not None:
        counter.rope_launches += 1
    return ys, rstds


def _kernel_bwd(xs, ws, table, rstds, dys, need_dw, counter):
    """``(dxs, dws)`` from one launch of ``csrc/rownorm.cu``'s backward
    (and its partials' sum when a weight gradient is wanted)."""
    from dstack_tpu_torch.ops.flash_attention import _launch, _sm_count

    n = xs[0].shape[-1]
    dxs = [torch.empty_like(x) for x in xs]
    norm = ws[0] is not None
    dws = [torch.empty_like(w) if norm and need else None
           for w, need in zip(ws, need_dw)]
    part_rows = 0
    part = None
    if any(dw is not None for dw in dws):
        part_rows = _PART_ROWS_PER_SM * _sm_count(xs[0].device.index)
        part = torch.empty((part_rows, n), dtype=torch.float32,
                           device=xs[0].device)
    _launch("rownorm", *_pairs(xs), *_pairs(dys), *_pairs(dxs), *_pairs(ws),
            *_pairs(rstds), *_pairs(dws), table, part, *_geometry(xs, table),
            _DTYPES[xs[0].dtype], _DTYPES[ws[0].dtype] if norm else 0, 1,
            part_rows, 0.0)
    counter.bwd_launches += 1
    if table is not None:
        counter.rope_bwd_launches += 1
    return dxs, dws


class _RowNorm(torch.autograd.Function):
    """Rows normed and/or rotated by ``fwd``, differentiated by ``bwd``
    (the kernel's or the plain versions'); inputs ``(x0, w0[, x1, w1])``,
    outputs one y a tensor.  Saves the inputs, the table and one f32 rstd
    a row."""

    @staticmethod
    def forward(ctx, fwd, bwd, counter, table, eps, *xw):
        xs, ws = xw[0::2], xw[1::2]
        ys, rstds = fwd(xs, ws, table, eps, counter)
        ctx.save_for_backward(table, *xs, *ws, *rstds)
        ctx.bwd, ctx.counter, ctx.count = bwd, counter, len(xs)
        return tuple(ys) if len(ys) > 1 else ys[0]

    @staticmethod
    def backward(ctx, *dys):
        table, *rest = ctx.saved_tensors
        c = ctx.count
        xs, ws, rstds = rest[:c], rest[c:2 * c], rest[2 * c:]
        dys = [torch.zeros_like(x) if d is None else _ready(d)
               for x, d in zip(xs, dys)]
        need_dw = [ctx.needs_input_grad[6 + 2 * i] for i in range(c)]
        dxs, dws = ctx.bwd(xs, ws, table, rstds, dys, need_dw, ctx.counter)
        grads = [None] * 5
        for dx, dw in zip(dxs, dws):
            grads += [dx, dw]
        return tuple(grads)


def apply_rows(counter, xs: Sequence[torch.Tensor],
               ws: Sequence[Optional[torch.Tensor]],
               table: Optional[torch.Tensor], eps: float) -> tuple:
    """The rows of each of ``xs`` (CUDA tensors, one or two) normed by its
    weight (``ws`` all None: no norm) and rotated by ``table`` (None: not),
    as a tuple of one output a tensor: one kernel launch each way, counted
    on ``counter.launches`` and ``counter.bwd_launches``, and those that
    rotate on ``counter.rope_launches`` and ``counter.rope_bwd_launches``
    too (a call without a gradient to track launches the forward alone and
    saves nothing)."""
    if xs[0].device.type != "cuda":
        raise ValueError(f"the row kernel runs on CUDA tensors, got "
                         f"{xs[0].device}")
    _check(xs, ws, table)
    xs, ws, table = [_ready(x) for x in xs], [_ready(w) for w in ws], \
        _ready(table)
    tracked = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (*xs, *ws))
    if not tracked:
        return tuple(_kernel_fwd(xs, ws, table, eps, counter, keep=False)[0])
    xw = [t for pair in zip(xs, ws) for t in pair]
    out = _RowNorm.apply(_kernel_fwd, _kernel_bwd, counter, table, eps, *xw)
    return out if isinstance(out, tuple) else (out,)
