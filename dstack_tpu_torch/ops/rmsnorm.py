"""RMSNorm: f32 accumulation, result cast back to the input dtype.

Plain torch on purpose: a decode step normalises a [B, 1, D] row, which is
launch overhead rather than bandwidth; a fused kernel is not on this path.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)
