"""Rotary position embeddings (RoPE), including Llama-3 frequency scaling.

The inverse frequencies are computed on the host in float64 and cast to
float32 (so every caller gets bit-identical tables); the rotation uses the
split-halves convention (rotate_half), matching Llama.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


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
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)
