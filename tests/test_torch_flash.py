"""The port's causal flash attention against the JAX package's, on the CPU.

Both sides get the same numpy inputs (b1, s128, 4 query heads over 2 kv
heads) in float32.  The JAX side runs its Pallas kernels in interpret mode:
K1/K2 (``_fwd``, ``_bwd_merged``) at head_dim 16 and K3/K4 (the head-pair
packed kernels) at head_dim 64.  The port's side is what a CPU tensor
takes: the kernels' plain versions, through the same autograd Function the
card uses.  Each JAX result is computed once per module, and the file
holds few tests: pytest-xdist starts the files with the most tests first,
beside the load-sensitive dtlint scan guard, so the JAX work here runs
later (the port-only checks are in ``test_torch_flash_ops.py``).

Tolerances (absolute, f32):
- 2e-6 where both sides do the same f32 arithmetic in another order
  (one 128-row block per program in interpret mode, so one softmax pass);
- 5e-6 at head_dim 64: the packed kernels rebuild each head's scores as
  (s_sum +/- s_dif) / 2, which loses about one ulp of the other head's
  score per entry (``dstack_tpu/ops/flash_attention.py`` :297-299), and
  the gradients sum 128 such terms (1.7e-6 seen);
- 1e-5 against ``causal_attention``, which scales q before the dot and
  runs torch's softmax, so p differs in the last bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.ops import flash_attention as j_flash
from dstack_tpu_torch.ops import flash_attention as fa
from dstack_tpu_torch.ops.attention import causal_attention

torch.set_num_threads(1)

B, S, HQ, HKV = 1, 128, 4, 2
TOL = {16: 2e-6, 64: 5e-6}
TOL_CAUSAL = 1e-5


def _inputs(d):
    rng = np.random.default_rng(d)
    q, do = (rng.standard_normal((B, S, HQ, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, S, HKV, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _jax_lse(q, k, v, d):
    """The JAX forward kernel's lse as [B, Hq, S]."""
    scale = d ** -0.5
    if d == 64:
        qp = j_flash._pack_heads(jnp.asarray(q))
        kp, vp = j_flash._dup_lanes(jnp.asarray(k)), j_flash._dup_lanes(
            jnp.asarray(v))
        _, lse0, lse1 = j_flash._fwd_packed(qp, kp, vp, scale)
        pair = jnp.stack([lse0[..., 0], lse1[..., 0]], axis=1)  # [P, 2, S]
        return np.asarray(pair.reshape(B, HQ, S))
    q3 = jnp.asarray(q).transpose(0, 2, 1, 3).reshape(B * HQ, S, d)
    k3 = jnp.asarray(k).transpose(0, 2, 1, 3).reshape(B * HKV, S, d)
    v3 = jnp.asarray(v).transpose(0, 2, 1, 3).reshape(B * HKV, S, d)
    _, lse = j_flash._fwd(q3, k3, v3, scale)
    return np.asarray(lse.reshape(B, HQ, S))


@pytest.fixture(scope="module", params=[16, 64], ids=["d16_K1K2", "d64_K3K4"])
def case(request):
    """Inputs and the JAX results at one head dim, computed once."""
    d = request.param
    assert j_flash._use_packed(d, HQ, HKV) == (d == 64)
    q, k, v, do = _inputs(d)
    o, vjp = jax.vjp(j_flash.flash_attention, jnp.asarray(q), jnp.asarray(k),
                     jnp.asarray(v))
    dq, dk, dv = vjp(jnp.asarray(do))
    want = {"o": o, "lse": _jax_lse(q, k, v, d), "dq": dq, "dk": dk, "dv": dv}
    return d, (q, k, v, do), {n: np.asarray(x) for n, x in want.items()}


def _port(inputs, fn):
    q, k, v, do = (torch.from_numpy(x).requires_grad_() for x in inputs)
    o = fn(q, k, v)
    o.backward(do.detach())
    return {"o": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}


def test_forward_plain_matches_jax_kernel(case):
    d, (q, k, v, _), want = case
    o, lse = fa.flash_attention_fwd_plain(*map(torch.from_numpy, (q, k, v)))
    assert o.shape == (B, S, HQ, d) and lse.shape == (B, HQ, S)
    np.testing.assert_allclose(o.numpy(), want["o"], atol=TOL[d], rtol=0)
    np.testing.assert_allclose(lse.numpy(), want["lse"], atol=TOL[d], rtol=0)


def test_backward_matches_jax_grad_and_causal_attention(case):
    """Through the autograd Function: o and the gradients against
    ``jax.vjp`` of the JAX kernels, and against autograd of the port's
    plain ``causal_attention``."""
    d, inputs, want = case
    got = _port(inputs, fa.flash_attention)
    ref = _port(inputs, causal_attention)
    for name in ("o", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[name].numpy(), want[name],
                                   atol=TOL[d], rtol=0, err_msg=name)
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(),
                                   atol=TOL_CAUSAL, rtol=0, err_msg=name)


def test_backward_plain_takes_o_and_lse_from_the_forward(case):
    """The plain backward recomputes p from lse: fed the forward's own
    (o, lse) it gives autograd's gradients of the plain forward."""
    d, (q, k, v, do), _ = case
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fa.flash_attention_fwd_plain(tq, tk, tv)
    dq, dk, dv = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo)
    ref = _port((q, k, v, do), lambda *a: fa.flash_attention_fwd_plain(*a)[0])
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(got.numpy(), ref[name].numpy(),
                                   atol=TOL[16], rtol=0, err_msg=name)
