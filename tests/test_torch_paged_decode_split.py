"""The split-KV design of the port's paged decode kernel, on the CPU.

Compiles no JAX program (``test_torch_paged_decode.py`` holds the plain
version to the JAX kernel).  Covered here: the split count the wrapper
picks from host integers, a plain model of the kernel's two passes (the
plain version over each split's table columns, then
``paged_decode_merge_plain``) against the unsplit plain version, the
one-buffer layout of the outputs and scratch, and the argument checks run
before a launch.  Tolerance of the split model: 1e-5 in f32 (the same
terms summed in another order, and one more rescale by exp(lse - max)).
The kernel itself is held to the plain version on the card by
``chip_smoke.py``.
"""

import inspect

import numpy as np
import pytest
import torch

from dstack_tpu_torch.ops import flash_attention as fa

ATOL = 1e-5
H100_SMS = 132

torch.set_num_threads(1)


# -- the split count ---------------------------------------------------------

WIDTHS = [(nbk, b, hkv, sms) for nbk in (1, 2, 3, 4, 7, 8, 16, 32, 33, 64, 512)
          for b, hkv, sms in ((8, 8, H100_SMS), (1, 8, H100_SMS),
                              (64, 8, H100_SMS), (2, 2, 4))]


@pytest.mark.parametrize("nbk,b,hkv,sms", WIDTHS,
                         ids=[f"nbk{n}-b{b}-h{h}-sm{s}"
                              for n, b, h, s in WIDTHS])
def test_every_column_in_exactly_one_split(nbk, b, hkv, sms):
    splits = fa.paged_decode_splits(nbk, b, hkv, sms)
    ranges = fa.paged_decode_split_ranges(nbk, splits)
    assert len(ranges) == splits >= 1
    owner = np.zeros(nbk, int)
    for c0, c1 in ranges:
        assert c0 < c1, "a split with no column"
        owner[c0:c1] += 1
    assert np.all(owner == 1)
    if splits > 1:
        # all but the last split walk the same number of columns, at least 2
        widths = [c1 - c0 for c0, c1 in ranges]
        assert len(set(widths[:-1])) == 1 and widths[0] >= 2


@pytest.mark.parametrize("nbk", [0, 1, 2, 3])
def test_narrow_table_is_one_split(nbk):
    assert fa.paged_decode_splits(nbk, 8, 8, H100_SMS) == 1


@pytest.mark.parametrize("b,hkv", [(8, 8), (1, 8), (4, 2), (16, 8)])
def test_full_table_fills_the_card(b, hkv):
    """At the served table width (1024 rows of 32-row pages) the grid
    stays within two CTAs per SM and is less than one split's CTAs short
    of it, unless the splits are already down to two columns each."""
    nbk = 32
    splits = fa.paged_decode_splits(nbk, b, hkv, H100_SMS)
    ctas = splits * b * hkv
    assert ctas <= max(2 * H100_SMS, b * hkv)
    assert ctas > 2 * H100_SMS - b * hkv or -(-nbk // splits) == 2
    assert splits == 1 or -(-nbk // splits) >= 2


def test_served_burst_takes_four_splits():
    """Llama-3-8B's 8 slots of 8 kv heads over 32 columns on an H100: 4
    splits of 8 columns, 256 CTAs on 132 SMs."""
    assert fa.paged_decode_splits(32, 8, 8, H100_SMS) == 4


def test_split_count_reads_host_integers_only():
    """The count is a function of (NBK, B, Hkv, SM count): no lengths, no
    tensor, so the wrapper never syncs with the device to pick it."""
    params = list(inspect.signature(fa.paged_decode_splits).parameters)
    assert params == ["nbk", "batch", "hkv", "num_sms"]
    assert fa.paged_decode_splits(np.int64(32), 8, 8, 132) == \
        fa.paged_decode_splits(32, 8, 8, 132)


# -- the plain split-then-merge model -----------------------------------------

BS = 4


def _case(lengths, nbk, seed=0, hkv=2, g=2, d=8, quantized=False,
          extra_cols=0):
    """f32 q and pools, distinct pages per slot, a table ``extra_cols``
    wider than the walk (sliced back to ``nbk`` columns)."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    nb = b * nbk + 1
    q = torch.from_numpy(
        rng.standard_normal((b, hkv, g, d)).astype(np.float32))
    pools = [torch.from_numpy(rng.standard_normal((nb, BS, hkv, d)).astype(
        np.float32)) for _ in range(2)]
    if quantized:
        pools = [{"q": torch.from_numpy(rng.integers(-127, 128, p.shape)
                                        .astype(np.int8)),
                  "s": torch.from_numpy(rng.uniform(0.005, 0.02, p.shape[:3])
                                        .astype(np.float32))}
                 for p in pools]
    perm = rng.permutation(nb - 1) + 1
    tables = np.zeros((b, nbk + extra_cols), np.int32)
    for i, n in enumerate(lengths):
        owned = -(-n // BS)
        tables[i, :owned] = perm[i * nbk:i * nbk + owned]
    tables = torch.from_numpy(tables)[:, :nbk]
    return q, pools[0], pools[1], tables, torch.tensor(lengths,
                                                       dtype=torch.int32)


def _split_then_merge(q, kp, vp, tables, lengths, splits):
    """The kernel's two passes in plain torch: each split's columns through
    the plain version (lengths shifted to the split's first row), then the
    merge's plain version."""
    o_parts, lse_parts = [], []
    for c0, c1 in fa.paged_decode_split_ranges(tables.shape[1], splits):
        rest = torch.clamp(lengths - c0 * BS, min=0).to(torch.int32)
        o, lse = fa.paged_decode_attention_plain(q, kp, vp, tables[:, c0:c1],
                                                 rest)
        o_parts.append(o)
        lse_parts.append(lse)
    return fa.paged_decode_merge_plain(torch.stack(o_parts, dim=2),
                                       torch.stack(lse_parts, dim=2))


NBK = 8
MODEL_CASES = {
    # random lengths over the whole table
    "random": (list(np.random.default_rng(7).integers(1, NBK * BS + 1, 6)),
               {}),
    # an empty slot beside full ones
    "empty-slot": ([0, NBK * BS, 1, 0], {}),
    # lengths ending inside a split and on its boundaries (2 columns a
    # split at 4 splits)
    "mid-split": ([2 * BS - 1, 2 * BS, 2 * BS + 1, 5 * BS + 2, 7 * BS + 3],
                  {}),
    # every split after the first wholly past the length
    "past-length": ([1, BS, 2 * BS], {}),
    # a column slice of a wider table, as the engine's ragged bucket
    "sliced-table": ([3, 17, 30, 9], {"extra_cols": 5}),
    "int8-pages": ([0, 5, 19, 32], {"quantized": True}),
    "group-4-d16": ([11, 32, 0, 25], {"g": 4, "d": 16}),
}


@pytest.mark.parametrize("splits", [1, 2, 3, 4, NBK])
@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_split_then_merge_matches_unsplit(case, splits):
    lengths, kw = MODEL_CASES[case]
    q, kp, vp, tables, lengths = _case([int(n) for n in lengths], NBK, **kw)
    if kw.get("extra_cols"):
        assert not tables.is_contiguous()
    want_o, want_lse = fa.paged_decode_attention_plain(q, kp, vp, tables,
                                                       lengths)
    got_o, got_lse = _split_then_merge(q, kp, vp, tables, lengths, splits)
    np.testing.assert_allclose(got_o.numpy(), want_o.numpy(), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=ATOL,
                               rtol=1e-6)
    empty = (lengths == 0).numpy()
    assert np.all(got_o.numpy()[empty] == 0.0)
    assert np.all(got_lse.numpy()[empty] == np.float32(-1e30))


def test_merge_of_only_empty_partials_is_the_sentinel():
    o_parts = torch.zeros((2, 3, 5, 4, 8))
    lse_parts = torch.full((2, 3, 5, 4), -1e30)
    o, lse = fa.paged_decode_merge_plain(o_parts, lse_parts)
    assert torch.all(o == 0) and torch.all(lse == np.float32(-1e30))


def test_merge_gives_empty_partials_no_weight():
    """One nonempty partial among empty ones comes out as it went in."""
    rng = np.random.default_rng(3)
    o_parts = torch.zeros((1, 2, 4, 3, 8))
    lse_parts = torch.full((1, 2, 4, 3), -1e30)
    o_parts[:, :, 2] = torch.from_numpy(
        rng.standard_normal((1, 2, 3, 8)).astype(np.float32))
    lse_parts[:, :, 2] = torch.from_numpy(
        rng.standard_normal((1, 2, 3)).astype(np.float32))
    o, lse = fa.paged_decode_merge_plain(o_parts, lse_parts)
    assert torch.equal(o, o_parts[:, :, 2])
    assert torch.equal(lse, lse_parts[:, :, 2])


# -- the one-buffer layout of outputs and scratch ----------------------------


@pytest.mark.parametrize("splits", [1, 2, 6])
@pytest.mark.parametrize("d", [64, 128])
def test_output_and_scratch_in_one_buffer(splits, d):
    b, hkv, g = 3, 2, 4
    o, lse, o_part, lse_part = fa._paged_buffers(b, hkv, g, d, splits, "cpu")
    assert o.shape == (b, hkv, g, d) and lse.shape == (b, hkv, g)
    assert o.is_contiguous() and lse.is_contiguous()
    assert o.dtype == lse.dtype == torch.float32
    storage = o.untyped_storage()
    assert lse.untyped_storage().data_ptr() == storage.data_ptr()
    parts = b * hkv * splits * g if splits > 1 else 0
    spans = sorted([(o.data_ptr(), 4 * o.numel()),
                    (lse.data_ptr(), 4 * lse.numel()),
                    (o_part, 4 * parts * d), (lse_part, 4 * parts)])
    # o, o_part, lse, lse_part back to back, filling the one allocation
    assert [s[0] for s in spans] == [o.data_ptr(), o_part, lse.data_ptr(),
                                     lse_part]
    assert all(a[0] + a[1] == nxt[0] for a, nxt in zip(spans, spans[1:]))
    assert spans[-1][0] + spans[-1][1] - spans[0][0] == storage.nbytes()
    assert o.data_ptr() % 16 == 0 and o_part % 16 == 0


# -- argument checks ---------------------------------------------------------


def _kernel_args(quantized=False, g=4, d=64, bs=32):
    """bf16 (or int8) arguments at a shape the kernel is built for."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 2, g, d)).astype(
        np.float32)).to(torch.bfloat16)
    pools = [torch.zeros((5, bs, 2, d), dtype=torch.bfloat16)
             for _ in range(2)]
    scales = [None, None]
    if quantized:
        pools = [torch.zeros((5, bs, 2, d), dtype=torch.int8)
                 for _ in range(2)]
        scales = [torch.ones((5, bs, 2)) for _ in range(2)]
    tables = torch.zeros((2, 4), dtype=torch.int32)
    lengths = torch.tensor([3, 40], dtype=torch.int32)
    return [q, pools[0], scales[0], pools[1], scales[1], tables, lengths]


def _misaligned(t, by=8):
    """t's values in a buffer that starts ``by`` bytes past a 16-byte
    edge."""
    flat = torch.zeros(t.numel() + 16, dtype=t.dtype)
    off = by // t.element_size()
    return flat[off:off + t.numel()].view(t.shape)


@pytest.mark.parametrize("mutate, match", [
    (lambda a: a.__setitem__(0, torch.cat([a[0], a[0][..., :8]], dim=3)),
     "unsupported head shape"),
    (lambda a: a.__setitem__(0, torch.zeros((2, 2, 4, 272),
                                            dtype=torch.bfloat16)),
     "unsupported head shape"),
    (lambda a: a.__setitem__(0, a[0][..., :8].contiguous()),
     "unsupported head shape"),
    (lambda a: a.__setitem__(0, _misaligned(a[0], 2)), "4-byte aligned"),
    (lambda a: a.__setitem__(1, _misaligned(a[1])), "16-byte aligned"),
    (lambda a: a.__setitem__(3, a[3][:4]), "pages must be"),
    (lambda a: a.__setitem__(5, a[5][:1]), "tables must be"),
    (lambda a: a.__setitem__(6, a[6].long()), "lengths must be"),
], ids=["head-dim-72", "head-dim-272", "head-dim-8", "q-misaligned",
        "pages-misaligned", "pages-differ", "tables-rows", "lengths-dtype"])
def test_argument_checks_reject(mutate, match):
    args = _kernel_args()
    mutate(args)
    with pytest.raises(ValueError, match=match):
        fa._check(*args)


def test_q_needs_only_word_alignment():
    """q is read in 4-byte words, the pages in 16-byte copies."""
    args = _kernel_args()
    args[0] = _misaligned(args[0], 4)
    fa._check(*args)


@pytest.mark.parametrize("bs", [1, 24, 48])
def test_any_block_size_is_taken(bs):
    """A power of two walks with a shift, any other size with a
    division."""
    fa._check(*_kernel_args(bs=bs))


def test_empty_pages_rejected():
    with pytest.raises(ValueError, match="at least one row"):
        fa._check(*_kernel_args(bs=0))


def test_int8_scales_checked():
    args = _kernel_args(quantized=True)
    args[2] = args[2].double()
    with pytest.raises(ValueError, match="scales"):
        fa._check(*args)


def test_head_dims_are_the_multiples_of_16_to_256():
    assert fa.PAGED_HEAD_DIMS == tuple(16 * i for i in range(1, 17))


@pytest.mark.parametrize("g", [1, 2, 5, 16])
@pytest.mark.parametrize("d", fa.PAGED_HEAD_DIMS)
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_argument_checks_accept_kernel_shapes(g, d, quantized):
    fa._check(*_kernel_args(quantized, g=g, d=d))
