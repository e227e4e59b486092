"""The port's paged decode attention against the JAX package's Pallas kernel.

On the CPU the port's ``paged_decode_attention`` takes its plain version
(gather + f32 softmax); the JAX side runs ``_paged_decode_kernel`` in
interpret mode, as the JAX package's own tests do.  Both get the same numpy
arrays in float32.  Tolerance 1e-5: the kernel's online softmax and the
plain global softmax sum the same terms in another order.  Each JAX
result is computed once per file (the interpret-mode kernel is the
costly part).  The Hopper kernel itself is held to the plain version on
the card by ``chip_smoke.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.ops import flash_attention as j_fa
from dstack_tpu.serving.quant import quantize_kv as j_quantize_kv
from dstack_tpu_torch.ops import flash_attention as t_fa

ATOL = 1e-5
BS = 8
# empty, one row, exactly one block, mid-block, full table
LENGTHS = [0, 1, BS, 13, 4 * BS]

# tiny shapes gain nothing from intra-op threads, and the suite runs
# several test processes at once
torch.set_num_threads(1)


def _case(seed=0, hkv=2, g=2, d=16, nb=14, nbk=4):
    rng = np.random.default_rng(seed)
    b = len(LENGTHS)
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    kp = rng.standard_normal((nb, BS, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((nb, BS, hkv, d)).astype(np.float32)
    # distinct pages per slot, NULL (0) past each slot's owned columns
    tables = np.zeros((b, nbk), np.int32)
    nxt = 1
    for i, n in enumerate(LENGTHS):
        for c in range(-(-n // BS)):
            tables[i, c] = nxt
            nxt += 1
    return q, kp, vp, tables, np.asarray(LENGTHS, np.int32)


def _jax(q, kp, vp, tables, lengths):
    o, lse = j_fa.paged_decode_attention(
        jnp.asarray(q), kp, vp, jnp.asarray(tables), jnp.asarray(lengths))
    return np.asarray(o), np.asarray(lse)


@functools.lru_cache(maxsize=None)
def _jax_case(quantized, cols=None):
    """The JAX kernel's (o, lse) on ``_case()``, its table cut to ``cols``
    columns (and every length inside them) when given."""
    q, kp, vp, tables, lengths = _case()
    if cols is not None:
        tables, lengths = tables[:, :cols], np.minimum(lengths, cols * BS)
    make = _int8_pools if quantized else _pools
    return _jax(q, *make(kp, vp, "jax"), tables, lengths)


def _port(q, kp, vp, tables, lengths):
    o, lse = t_fa.paged_decode_attention(
        torch.from_numpy(q), kp, vp, torch.from_numpy(tables),
        torch.from_numpy(lengths))
    return o.numpy(), lse.numpy()


def _pools(kp, vp, lib):
    """Plain pools as each side's array type."""
    if lib == "jax":
        return jnp.asarray(kp), jnp.asarray(vp)
    return torch.from_numpy(kp), torch.from_numpy(vp)


def _int8_pools(kp, vp, lib):
    """int8 {"q","s"} pools, quantized once (by the JAX package) and handed
    to both sides."""
    out = []
    for pool in (kp, vp):
        qv, s = (np.array(a) for a in j_quantize_kv(jnp.asarray(pool)))
        out.append({"q": jnp.asarray(qv), "s": jnp.asarray(s)} if lib == "jax"
                   else {"q": torch.from_numpy(qv), "s": torch.from_numpy(s)})
    return out


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["bf16-layout", "int8"])
def test_plain_matches_jax_kernel(quantized):
    q, kp, vp, tables, lengths = _case()
    make = _int8_pools if quantized else _pools
    want_o, want_lse = _jax_case(quantized)
    got_o, got_lse = _port(q, *make(kp, vp, "torch"), tables, lengths)
    np.testing.assert_allclose(got_o, want_o, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_lse, want_lse, atol=ATOL, rtol=1e-6)


def test_sliced_table_matches_jax_and_full_table():
    """A column slice of the table (the engine's ragged bucket) walks fewer
    pages; with every length inside the slice it gives the same numbers."""
    q, kp, vp, tables, lengths = _case()
    lengths = np.minimum(lengths, 2 * BS)
    want_o, want_lse = _jax_case(False, cols=2)
    t_tables = torch.from_numpy(tables)
    cut = t_fa.paged_decode_attention(
        torch.from_numpy(q), *_pools(kp, vp, "torch"), t_tables[:, :2],
        torch.from_numpy(lengths))
    full = t_fa.paged_decode_attention(
        torch.from_numpy(q), *_pools(kp, vp, "torch"), t_tables,
        torch.from_numpy(lengths))
    assert not t_tables[:, :2].is_contiguous()
    np.testing.assert_allclose(cut[0].numpy(), want_o, atol=ATOL, rtol=0)
    np.testing.assert_allclose(cut[1].numpy(), want_lse, atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(cut[0].numpy(), full[0].numpy(), atol=ATOL,
                               rtol=0)


def test_empty_slot_sentinel_and_zero_output():
    """length 0: o == 0 exactly and the finite -1e30 lse sentinel (the
    engine's logsumexp merge relies on it), on both sides."""
    q, kp, vp, tables, lengths = _case()
    assert lengths[0] == 0
    o, lse = _port(q, *_pools(kp, vp, "torch"), tables, lengths)
    assert np.all(o[0] == 0.0)
    assert np.all(lse[0] == np.float32(-1e30))
    j_o, j_lse = _jax_case(False)
    assert np.all(j_o[0] == 0.0)
    assert np.all(j_lse[0] <= -1e29)


def test_int4_pages_raise():
    q, kp, vp, tables, lengths = _case()
    fake = {"q4": torch.zeros((14, BS, 2, 8), dtype=torch.int8),
            "s": torch.ones((14, BS, 2))}
    with pytest.raises(NotImplementedError):
        t_fa.paged_decode_attention(torch.from_numpy(q), fake, fake,
                                    torch.from_numpy(tables),
                                    torch.from_numpy(lengths))


def test_cpu_calls_never_count_launches():
    q, kp, vp, tables, lengths = _case()
    before = t_fa.paged_decode_attention.launches
    _port(q, *_pools(kp, vp, "torch"), tables, lengths)
    _port(q, *_int8_pools(kp, vp, "torch"), tables, lengths)
    assert t_fa.paged_decode_attention.launches == before


def _bf16_args(quantized=False):
    q, kp, vp, tables, lengths = _case()
    pools = (_int8_pools(kp, vp, "torch") if quantized else
             [torch.from_numpy(p).to(torch.bfloat16) for p in (kp, vp)])
    return [torch.from_numpy(q).to(torch.bfloat16), *pools,
            torch.from_numpy(tables), torch.from_numpy(lengths)]


@pytest.mark.parametrize("mutate, match", [
    (lambda a: a.__setitem__(0, a[0].float()), "q must be"),
    (lambda a: a.__setitem__(0, a[0].transpose(1, 2)), "q must be"),
    (lambda a: a.__setitem__(1, a[1].float()), "pages must be"),
    (lambda a: a.__setitem__(3, a[3].long()), "tables must be"),
    (lambda a: a.__setitem__(3, a[3].t().contiguous().t()), "tables must be"),
    (lambda a: a.__setitem__(4, a[4][:-1]), "lengths must be"),
], ids=["q-dtype", "q-layout", "page-dtype", "table-dtype", "table-stride",
        "lengths-shape"])
def test_kernel_argument_checks(mutate, match):
    """The checks the wrapper runs before a launch reject what the kernel
    cannot take (run here on CPU tensors: they look at dtype and layout)."""
    args = _bf16_args()
    mutate(args)
    q, kp, vp, tables, lengths = args
    with pytest.raises(ValueError, match=match):
        t_fa._check(q, kp, None, vp, None, tables, lengths)


def test_kernel_argument_checks_accept_engine_layout():
    q, kp, vp, tables, lengths = _bf16_args()
    t_fa._check(q, kp, None, vp, None, tables[:, :2], lengths)
    q, kp, vp, tables, lengths = _bf16_args(quantized=True)
    t_fa._check(q, kp["q"], kp["s"], vp["q"], vp["s"], tables, lengths)
