"""Weight-only int8 quantization and int8/int4 KV rows for the serving
engine.

Symmetric per-channel (absmax) weights: ``{"q": int8 [..., in, out], "s":
f32 [..., out]}``; norms and the embedding stay in the original dtype (a
tied head gets its own int8 copy, see :func:`quantize_params`).  KV rows
quantize per (token, head) row with one f32 scale each, at 8 bits or at 4
bits packed two to a byte.

Plain torch: ``qmatmul`` converts the int8 weight to the compute dtype
before the product, so on the card the int8 bytes are read once and the
converted copy once more — a fused dequant-matmul kernel is later work.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

#: layer weights quantized (matmul RHS, [in, out] layout)
_LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_weight(w: torch.Tensor,
                    reduce: Optional[Callable] = None
                    ) -> Dict[str, torch.Tensor]:
    """[..., in, out] -> {"q": int8, "s": f32 [..., out] channel scales}.

    ``reduce``, given a rank's rows of a matrix whose other rows other
    ranks hold, takes the channels' absmax ([..., 1, out]) to the whole
    matrix's (a max over those ranks), so the shards quantize as the
    whole matrix does."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-2, keepdim=True)
    if reduce is not None:
        amax = reduce(amax)
    scale = (amax / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(w32 / scale), -127, 127)
    return {"q": q.to(torch.int8), "s": scale[..., 0, :].float()}


def qmatmul(x: torch.Tensor, w: Any, compute_dtype: torch.dtype,
            preferred: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ w for plain tensors OR quantized {"q","s"} dicts; the result is
    cast to ``preferred`` when given (the logits ask for float32)."""
    if isinstance(w, dict) and "q" in w:
        y = torch.matmul(x, w["q"].to(compute_dtype))
        if preferred is not None:
            y = y.to(preferred)
        return y * w["s"].to(preferred or compute_dtype)
    y = torch.matmul(x, w)
    return y if preferred is None else y.to(preferred)


def quantize_params(params: Any, tied_head_copy: bool = False,
                    reduce: Optional[Callable[[str], Optional[Callable]]]
                    = None) -> Any:
    """Quantize every stacked layer matmul weight (and the lm_head);
    everything else passes through.  ``tied_head_copy``: for tied models,
    add an int8 copy of ``embed.T`` as "lm_head" (the embedding gather keeps
    the original precision).  ``reduce(name)``: the absmax reduction of
    layer weight ``name`` under a mesh (see :func:`quantize_weight`), or
    None."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in _LAYER_WEIGHTS:
        if name in layers:
            layers[name] = quantize_weight(
                layers[name], None if reduce is None else reduce(name))
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"] = quantize_weight(params["lm_head"])
    elif tied_head_copy:
        out["lm_head"] = quantize_weight(params["embed"].T)
    return out


def quantize_kv(x: torch.Tensor):
    """[..., D] K/V rows -> (int8 [..., D], f32 scales [...]): symmetric
    absmax per (token, head) row."""
    x32 = x.float()
    s = (x32.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(x32 / s), -127, 127)
    return q.to(torch.int8), s[..., 0].float()


def dequantize_kv(q: torch.Tensor, s: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`, computed in ``dtype``."""
    return q.to(dtype) * s[..., None].to(dtype)


def quantize_kv4(x: torch.Tensor):
    """[..., D] K/V rows -> (int8 [..., D/2] nibble-packed, f32 scales [...]).

    The per-(token, head)-row absmax scheme of :func:`quantize_kv` at 4
    bits: values quantize to [-7, 7] and adjacent pairs pack two to a byte,
    the even index in the low nibble.  Needs an even D."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"int4 KV packing needs an even head_dim, got {d}")
    x32 = x.float()
    # a divisor on x's device: CUDA divides by a Python number as a
    # product with its reciprocal, which can move a scale by one ulp
    # from the CPU's (and JAX's) quotient
    seven = torch.full((), 7.0, device=x.device)
    s = (x32.abs().amax(dim=-1, keepdim=True) / seven).clamp_min(1e-12)
    q = torch.clamp(torch.round(x32 / s), -7, 7).to(torch.int8)
    lo = q[..., 0::2] & 0x0F
    hi = q[..., 1::2] << 4
    return lo | hi, s[..., 0].float()


def dequantize_kv4(q4: torch.Tensor, s: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv4`, computed in ``dtype``: arithmetic
    shifts of the int8 bytes sign-extend both nibbles, which interleave
    back to [..., D]."""
    lo = (q4 << 4) >> 4
    hi = q4 >> 4
    vals = torch.stack([lo, hi], dim=-1).reshape(
        q4.shape[:-1] + (2 * q4.shape[-1],))
    return vals.to(dtype) * s[..., None].to(dtype)
