"""The yardstick's peaks and the least times of the port's kernels.

Frozen copies of ``chip_smoke.py``'s ``bound`` (the paged-decode kernel,
K5) and ``flash_bounds`` (the causal kernels, K1-K4), with the batch and
page size made arguments instead of module constants.  A kernel's roofline
share is one of these least times over its measured device time.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the full
700 W power limit.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

Bound = Tuple[float, str, int, int]


def _least(nbytes: int, flops: int) -> Bound:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def paged_decode_bound(lengths: Sequence[int], d: int, quant: bool,
                       hkv: int, g: int, block_size: int) -> Bound:
    """Least time (ms) of one paged-decode call over ``lengths`` (one per
    slot), what bounds it, its bytes and its operations.  Each input byte
    the function needs is read once (q, the K/V rows below each length,
    their scales, the table entries walked, the lengths), each output byte
    written once (o f32, lse f32), against 4 * sum(length) * Hq * D
    operations (QK and PV, two per multiply-add)."""
    b = len(lengths)
    hq = hkv * g
    rows = sum(int(n) for n in lengths)
    elem = 1 if quant else 2
    kv = 2 * rows * hkv * d * elem + (2 * rows * hkv * 4 if quant else 0)
    pages = sum(-(-int(n) // block_size) for n in lengths)
    nbytes = (b * hq * d * 2 + kv + pages * 4 + b * 4
              + b * hq * d * 4 + b * hq * 4)
    return _least(nbytes, 4 * rows * hq * d)


def flash_bounds(shape: Tuple[int, int, int, int, int]) -> Dict[str, Bound]:
    """Least times (ms) of the causal forward and backward at ``shape`` =
    (B, S, Hq, Hkv, D), each with what bounds it.  Bytes: each input read
    once and each output written once (forward: q, k, v -> o, lse;
    backward: q, k, v, o, lse, do -> dq, dk, dv).  Operations: 2 per
    multiply-add over the (query, key) pairs the causal mask keeps,
    S(S+1)/2 per head: two products forward, five backward."""
    b, s, hq, hkv, d = shape
    pairs = b * hq * s * (s + 1) // 2
    q_bytes, kv_bytes, lse_bytes = (b * s * hq * d * 2, b * s * hkv * d * 2,
                                    b * hq * s * 4)
    return {
        "fwd": _least(2 * q_bytes + 2 * kv_bytes + lse_bytes, 4 * d * pairs),
        "bwd": _least(4 * q_bytes + 4 * kv_bytes + lse_bytes, 10 * d * pairs),
    }
