"""The port's serving features against the JAX engine's, on the tiny config:
int4 KV, prefix caching, n-gram speculation and prefill/decode (PD)
export and install.

Both sides run ``LlamaConfig.tiny`` in float32 on the CPU with the same
weights (numpy from a seed, ``params_from_jax`` on the port's side), as in
``test_torch_engine.py``.  Greedy tokens must be EQUAL, and so must the
blocks each request reuses and speculation's counts: both engines compute
the same function in the same dtype and schedule alike.

This file compiles JAX programs, so it holds seven tests (xdist starts
files with the most tests first, and the JAX compiles then stay out of the
suite's first half-minute); every prompt falls in the 32-token prefill
bucket.  The features' cases that need no JAX program are in
``test_torch_serving_features_parts.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dstack_tpu.models.llama import LlamaConfig as JConfig
from dstack_tpu.serving import engine as j_engine
from dstack_tpu.serving.quant import quantize_kv4 as j_quantize_kv4
from dstack_tpu_torch.models.llama import LlamaConfig, params_from_jax
from dstack_tpu_torch.serving import engine as t_engine
from dstack_tpu_torch.serving.quant import quantize_kv4
from tests.test_torch_engine import _np_params

PROMPTS = [[1, 5, 9, 2, 7], list(range(3, 30))]  # both in the 32 bucket
ENGINE_KW = dict(batch_size=2, max_len=64)
PAGED_KW = dict(paged=True, kv_block_size=8)
PREFIX_KW = dict(prefix_cache=True, **PAGED_KW)

# tiny shapes gain nothing from intra-op threads, and the suite runs
# several test processes at once
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32)
    np_tree = _np_params(jcfg)
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    return (jcfg, jax.tree.map(jnp.asarray, np_tree), cfg,
            params_from_jax(np_tree, "cpu", torch.float32))


def _engines(weights, **kw):
    """(JAX engine, port engine) with the same weights and options."""
    jcfg, jparams, cfg, params = weights
    kw = {**ENGINE_KW, **kw}
    return (j_engine.InferenceEngine(jcfg, params=jparams, **kw),
            t_engine.InferenceEngine(cfg, params=params, device="cpu", **kw))


def _run(engine, reqs):
    """Submit ``reqs`` at once and step until all are done; their tokens."""
    for r in reqs:
        engine.submit(r)
    for _ in range(400):
        if all(r.done.is_set() for r in reqs):
            break
        engine.step()
    assert all(r.done.is_set() for r in reqs)
    return [r.output for r in reqs]


def _greedy(engine, prompts, n=8, waves=None):
    """Greedy tokens of ``prompts`` on ``engine``: all at once, or one wave
    (a list of prompt indices) after another."""
    cls = (t_engine.Request if isinstance(engine, t_engine.InferenceEngine)
           else j_engine.Request)
    waves = waves or [range(len(prompts))]
    out = {}
    for wave in waves:
        reqs = [cls(tokens=list(prompts[i]), max_new_tokens=n) for i in wave]
        out.update(zip(wave, _run(engine, reqs)))
    return [out[i] for i in range(len(prompts))]


def _track_reuse(engine) -> list:
    """A list the engine appends each admitted request's reused prefix
    blocks to (both engines stage them in ``_slot_prefix``)."""
    reused = []
    reserve = engine._reserve_blocks

    def spy(slot_id, req):
        ok = reserve(slot_id, req)
        if ok:
            reused.append(engine._slot_prefix[slot_id][0]
                          // engine._block_size)
        return ok

    engine._reserve_blocks = spy
    return reused


def test_quantize_kv4_matches_jax():
    """Packed bytes equal JAX's, scales within 1e-6 relative, on rows with
    negatives, exact nibble values and zero rows (after JAX's
    ``test_kv_quant_int4_negative_values_roundtrip_sign``)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 3, 4, 16)).astype(np.float32) * 3
    x[1] = 0.0
    x[2, 0, 0, :8] = [-7.0, 7.0, -3.0, 0.0, 1.0, -1.0, 5.0, -5.0]
    j_q4, j_s = j_quantize_kv4(jnp.asarray(x))
    q4, s = quantize_kv4(torch.from_numpy(x))
    assert q4.dtype == torch.int8 and tuple(q4.shape) == (6, 3, 4, 8)
    np.testing.assert_array_equal(q4.numpy(), np.asarray(j_q4))
    np.testing.assert_allclose(s.numpy(), np.asarray(j_s), rtol=1e-6,
                               atol=0)


def test_int4_greedy_matches_jax(weights):
    """Dense and paged int4 KV give JAX's int4 tokens (paged int4 attends
    over a gathered view on both sides: no kernel reads nibble pages).
    The tokens' drift from the plain f32 forward's argmax stays within
    the margin chip_smoke holds the 8B int4 engines to."""
    _, _, cfg, params = weights
    for kw in ({}, PAGED_KW):
        j_eng, t_eng = _engines(weights, kv_quantize="int4", **kw)
        got = _greedy(t_eng, PROMPTS)
        assert got == _greedy(j_eng, PROMPTS), kw
        worst = 0.0
        for prompt, out in zip(PROMPTS, got):
            seq = list(prompt)
            for tok in out:
                padded = torch.zeros(64, dtype=torch.long)
                padded[:len(seq)] = torch.tensor(seq)
                logits, _, _ = t_engine._prompt_forward(params, cfg, padded,
                                                        len(seq), 64)
                worst = max(worst, ((logits.max() - logits[tok])
                                    / logits.std()).item())
                seq.append(tok)
        assert worst <= chip_smoke.INT4_GAP_STD, (kw, worst)


def test_prefix_cache_matches_jax(weights):
    """JAX's test_prefix_cache.py scenarios, one request at a time: a
    repeated prompt, a shared prefix with other suffixes, and a
    block-aligned prompt (its last block is never reused: one token must
    be left to prefill).  Same tokens and same blocks reused per request,
    and the allocators end in the same state."""
    shared = [(i * 7 + 3) % 500 for i in range(19)]
    aligned = list(range(200, 224))                  # three whole blocks
    prompts = [shared + [1, 2], shared + [1, 2], shared + [9],
               shared + [4, 4, 4, 4, 4], aligned, aligned, PROMPTS[0]]
    waves = [[i] for i in range(len(prompts))]
    j_eng, t_eng = _engines(weights, **PREFIX_KW)
    j_reused, t_reused = _track_reuse(j_eng), _track_reuse(t_eng)
    got = _greedy(t_eng, prompts, waves=waves)
    assert got == _greedy(j_eng, prompts, waves=waves)
    assert t_reused == j_reused == [0, 2, 2, 2, 0, 2, 0]
    assert t_eng._alloc.stats == j_eng._alloc.stats
    # the tokens are the plain paged engine's
    plain = _engines(weights, **PAGED_KW)[1]
    assert _greedy(plain, prompts, waves=waves) == got


def test_prefix_cache_short_pool_and_chunks_match_jax(weights):
    """Both slots busy on a pool of nine blocks (the least an engine at
    max_len 64 takes): requests stall for blocks and cached blocks are
    evicted; prefill in chunks of 8, so a hit starts its chunks past the
    reused rows.  Same tokens, reuse and allocator counts as JAX."""
    shared = [(i * 11 + 5) % 500 for i in range(17)]
    prompts = [shared + [1], shared + [2, 3], list(range(300, 318)),
               list(range(400, 430)), shared + [7, 7],
               list(range(300, 318)) + [5]]
    kw = dict(total_kv_blocks=9, prefill_chunk=8, **PREFIX_KW)
    j_eng, t_eng = _engines(weights, **kw)
    j_reused, t_reused = _track_reuse(j_eng), _track_reuse(t_eng)
    waves = [[0], [1, 2], [3], [4, 5]]
    got = _greedy(t_eng, prompts, n=6, waves=waves)
    assert got == _greedy(j_eng, prompts, n=6, waves=waves)
    assert t_reused == j_reused
    assert sum(t_reused) > 0
    assert t_eng._alloc.stats == j_eng._alloc.stats
    assert t_eng._alloc.stats["evictions"] > 0
    assert t_eng._alloc.available_blocks == t_eng._alloc.num_blocks - 1


def test_speculation_long_horizon_matches_jax_and_plain(weights):
    """A 100-token greedy generation (after JAX's
    ``test_speculative_decode_exact_in_f32_long_horizon``): the port's
    speculative tokens are JAX's and the port's plain window's, and
    speculation's steps and accepted drafts are JAX's."""
    kw = dict(batch_size=1, max_len=128, speculation="ngram")
    j_eng, t_eng = _engines(weights, **kw)
    got = _greedy(t_eng, [[5, 9, 2]], n=100)
    assert got == _greedy(j_eng, [[5, 9, 2]], n=100)
    plain = _engines(weights, batch_size=1, max_len=128)[1]
    assert _greedy(plain, [[5, 9, 2]], n=100) == got
    assert t_eng.spec_stats == j_eng.spec_stats
    assert t_eng.spec_stats["accepted"] > 0


def test_speculation_int8_sampled_and_chunked_match_jax(weights):
    """Speculation with int8 KV; two slots with a short sampled request
    (the windows it is in take the plain path; only the greedy tokens are
    compared, the two packages draw other noise); and chunked prefill at
    8.  Windows of 8 steps, so the sampled request's end leaves windows to
    speculate in.  Prompts that repeat, so drafts are accepted.  Greedy
    tokens and spec_stats equal JAX's; greedy tokens equal the plain
    dense engine's."""
    rep = [7, 8, 9, 10, 11, 12] * 4
    prompts = [rep, [1, 2, 3, 1, 2, 3, 1, 2]]
    plain = _greedy(_engines(weights)[1], prompts, n=20)
    for kw, temps in ((dict(kv_quantize="int8"), (0.0, 0.0)),
                      ({}, (0.0, 1.0)),
                      (dict(prefill_chunk=8), (0.0, 0.0))):
        j_eng, t_eng = _engines(weights, speculation="ngram",
                                speculation_k=2, **kw)
        outs = []
        for eng, cls in ((j_eng, j_engine.Request), (t_eng, t_engine.Request)):
            eng.DECODE_WINDOWS = (8,)
            outs.append(_run(eng, [cls(tokens=list(p), temperature=t,
                                       max_new_tokens=6 if t else 20)
                                   for p, t in zip(prompts, temps)]))
        greedy = [i for i, t in enumerate(temps) if t == 0.0]
        j_out, t_out = ([o[i] for i in greedy] for o in outs)
        assert t_out == j_out, kw
        if "kv_quantize" not in kw:
            assert t_out == [plain[i] for i in greedy], kw
        assert t_eng.spec_stats == j_eng.spec_stats, kw
        assert t_eng.spec_stats["steps"] > 0, kw


def test_pd_export_and_install_match_jax(weights):
    """prefill_export's K/V and logits within 1e-4 of JAX's (f32 through
    two layers, summed in another order); JAX's export installed into the
    port's dense and paged engines, and the port's into JAX's, decode the
    tokens of a colocated prefill."""
    prompt = list(range(40, 61))
    j_eng, t_eng = _engines(weights)
    j_exp = j_eng.prefill_export(prompt, max_new_tokens=8)
    t_exp = t_eng.prefill_export(prompt, max_new_tokens=8)
    assert t_exp["length"] == j_exp["length"] == len(prompt)
    assert t_exp["first_token"] == j_exp["first_token"]
    for key in ("ks", "vs", "logits"):
        assert tuple(t_exp[key].shape) == j_exp[key].shape
        np.testing.assert_allclose(t_exp[key].numpy(), j_exp[key],
                                   atol=1e-4, rtol=0)
    want = _greedy(t_eng, [prompt])[0]
    for kw in ({}, PAGED_KW):
        eng = _engines(weights, **kw)[1]
        req = t_engine.Request(tokens=prompt, max_new_tokens=8, prefill={
            k: (torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
                else v) for k, v in j_exp.items()})
        assert _run(eng, [req]) == [want], kw
    req = j_engine.Request(tokens=prompt, max_new_tokens=8, prefill={
        k: (v.numpy() if isinstance(v, torch.Tensor) else v)
        for k, v in t_exp.items()})
    assert _run(j_eng, [req]) == [want]
