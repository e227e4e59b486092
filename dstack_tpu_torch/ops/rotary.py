"""Rotary position embeddings (RoPE), including Llama-3 frequency scaling.

The inverse frequencies are computed on the host in float64 and cast to
float32 (so every caller gets bit-identical tables); the rotation uses the
split-halves convention (rotate_half), matching Llama, except
:func:`rotate_pairs`, DeepSeek's interleaved pairs (``rope_interleave``).

The training layers rotate through :func:`qk_prologue`: q and k's optional
per-head RMSNorm and their rotation by a cos/sin table that
:func:`rope_table` builds once per backbone call, one row-kernel launch each
way on the card (``csrc/rownorm.cu``).  Serving and the plain-cache decode
keep :func:`apply_rope`, plain torch on every device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dstack_tpu_torch.ops import rownorm
from dstack_tpu_torch.ops.rmsnorm import rms_norm


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3 style NTK-by-parts scaling for long-context extension."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position: int = 8192


def rope_frequencies(
    head_dim: int,
    theta: float = 500_000.0,
    scaling: Optional[RopeScaling] = None,
) -> np.ndarray:
    """Inverse frequencies [head_dim // 2], float32, computed on host."""
    freqs = 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    )
    if scaling is not None:
        low_wavelen = scaling.original_max_position / scaling.low_freq_factor
        high_wavelen = scaling.original_max_position / scaling.high_freq_factor
        wavelen = 2 * np.pi / freqs
        # three bands: keep high frequencies, divide low ones by `factor`,
        # interpolate smoothly in between
        smooth = (scaling.original_max_position / wavelen
                  - scaling.low_freq_factor) / (
            scaling.high_freq_factor - scaling.low_freq_factor)
        freqs = np.where(
            wavelen > low_wavelen,
            freqs / scaling.factor,
            np.where(
                wavelen < high_wavelen,
                freqs,
                (1 - smooth) * freqs / scaling.factor + smooth * freqs,
            ),
        )
    return freqs.astype(np.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freqs: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [..., seq, heads, head_dim] by position-dependent phases.

    ``positions`` is [..., seq] (global token positions); ``inv_freqs`` is
    [head_dim // 2] float32 on ``x``'s device.  Math in float32, result in
    ``x``'s dtype.
    """
    angles = positions[..., :, None].float() * inv_freqs  # [..., S, D/2]
    cos = torch.cos(angles)[..., :, None, :]              # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., :, None, :]
    return rownorm.rotate_half(x, cos, sin)


def rope_table(positions: torch.Tensor,
               inv_freqs: torch.Tensor) -> torch.Tensor:
    """The cos/sin table [2, P, S, head_dim // 2] f32 of ``positions`` [P,
    S] (or [S]: P = 1), by :func:`apply_rope`'s own operations, so a
    rotation by the table is bit for bit :func:`apply_rope`'s."""
    angles = positions.reshape(-1, positions.shape[-1])[..., :, None].float(
        ) * inv_freqs
    return torch.stack([torch.cos(angles), torch.sin(angles)])


def qk_prologue(q: torch.Tensor, k: torch.Tensor,
                q_w: Optional[torch.Tensor] = None,
                k_w: Optional[torch.Tensor] = None,
                rope: Optional[torch.Tensor] = None,
                eps: float = 1e-5) -> tuple:
    """``(q, k)`` [B, S, H, head_dim] before attention: each head normed by
    ``q_w`` / ``k_w`` [head_dim] when given (an RMSNorm, cast back to the
    heads' dtype), then rotated by the :func:`rope_table` ``rope`` when
    given.  CPU tensors take :func:`rms_norm` and :func:`apply_rope`'s
    arithmetic; CUDA tensors one row-kernel launch for both tensors forward
    and one backward, counted on ``qk_prologue.launches`` and
    ``.bwd_launches``, and those that rotate on ``.rope_launches`` and
    ``.rope_bwd_launches`` too."""
    if (q_w is None) != (k_w is None):
        raise ValueError("qk_prologue norms both q and k or neither")
    if q_w is None and rope is None:
        return q, k
    if q.device.type != "cpu":
        return rownorm.apply_rows(qk_prologue, (q, k), (q_w, k_w), rope, eps)
    if q_w is not None:
        q, k = rms_norm(q, q_w, eps), rms_norm(k, k_w, eps)
    if rope is not None:
        cos, sin = rownorm.table_cos_sin(rope)
        q, k = (rownorm.rotate_half(q, cos, sin),
                rownorm.rotate_half(k, cos, sin))
    return q, k


def rotate_pairs(x: torch.Tensor, rope: torch.Tensor) -> torch.Tensor:
    """``x`` [B, S, H, n] rotated by the :func:`rope_table` ``rope`` in
    DeepSeek's interleaved convention: dimensions (2i, 2i + 1) are pair i,
    turned by pos * inv_freqs[i], and stay where they are.  Plain torch on
    every device, in f32; the result in ``x``'s dtype.  (DeepSeek-V3's
    modelling code permutes the pairs to split halves and rotates those;
    the dot product of two vectors so rotated is the same.)"""
    cos, sin = rownorm.table_cos_sin(rope)
    pairs = x.float().unflatten(-1, (-1, 2))
    x1, x2 = pairs[..., 0], pairs[..., 1]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).flatten(-2).to(x.dtype)


qk_prologue.launches = 0
qk_prologue.bwd_launches = 0
qk_prologue.rope_launches = 0
qk_prologue.rope_bwd_launches = 0
