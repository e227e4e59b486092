"""RMSNorm: f32 accumulation, result cast back to the input dtype.

CPU tensors take plain torch (the JAX parity tests read it).  CUDA tensors
take the row kernel (``csrc/rownorm.cu`` through :mod:`rownorm`): one launch
forward, one backward, every row read as bf16 or f32 and the f32 math kept
in registers.  That holds for the training layers' norms and the serving
engine's prefill and decode rows alike; a decode step's [B, 1, D] rows are
one small launch instead of the eager chain's seven.
"""

from __future__ import annotations

import torch

from dstack_tpu_torch.ops import rownorm


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """``x`` [..., D] over its last dimension, times ``weight`` [D].
    ``rms_norm.launches`` and ``.bwd_launches`` count the kernel's
    launches."""
    if x.device.type == "cpu":
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        normed = x32 * torch.rsqrt(var + eps)
        return (normed * weight.float()).to(x.dtype)
    return rownorm.apply_rows(rms_norm, (x,), (weight,), None, eps)[0]


rms_norm.launches = 0
rms_norm.bwd_launches = 0
