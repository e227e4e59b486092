"""The port's flash attention wrappers without JAX programs: routing
(``supports``, equal to the JAX package's rule on a grid of shapes), the
CPU path, dtypes, and the checks the kernel wrappers make before any build
or launch.  Parity with the JAX kernels is in ``test_torch_flash.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.ops import flash_attention as j_flash
from dstack_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)


def _inputs(d, b=1, s=128, hq=4, hkv=2):
    rng = np.random.default_rng(d)
    q, do = (torch.from_numpy(rng.standard_normal((b, s, hq, d)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, hkv, d)).astype(
        np.float32)) for _ in range(2))
    return q, k, v, do


def test_cpu_path_launches_no_kernel():
    q, k, v, do = _inputs(16)
    q.requires_grad_()
    before = (fa.flash_attention.fwd_launches, fa.flash_attention.bwd_launches)
    fa.flash_attention(q, k, v).backward(do)
    assert q.grad is not None
    assert (fa.flash_attention.fwd_launches,
            fa.flash_attention.bwd_launches) == before


def test_bf16_plain_keeps_dtypes():
    q, k, v, do = (x.to(torch.bfloat16) for x in _inputs(64))
    o, lse = fa.flash_attention_fwd_plain(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    grads = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]


_SUPPORT_GRID = [(seq, d, dt) for seq in (64, 100, 128, 1000, 1024, 4096,
                                          8192, 16384, 32768)
                 for d in (16, 64, 128, 256) for dt in ("bfloat16", "float32")]


@pytest.mark.parametrize("seq,d,dt", _SUPPORT_GRID)
def test_supports_matches_jax(seq, d, dt):
    want = j_flash.supports(seq, d, getattr(jnp, dt), group=4)
    assert fa.supports(seq, d, getattr(torch, dt), group=4) == want


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """The checks run before any build or launch (meta tensors: no data)."""
    q = torch.empty((1, 128, 4, 32), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 128, 2, 32), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        fa._check_flash(q, k, k)
    q = torch.empty((1, 96, 4, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 96, 2, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="shapes"):
        fa._check_flash(q, k, k)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, k, k)
