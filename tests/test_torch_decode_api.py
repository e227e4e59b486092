"""The port's plain-cache decode API and two compute knobs against the JAX
package's, on the CPU.

- ``llama.init_kv_caches``/``decode_step`` and ``attention.KVCache``/
  ``decode_step_attention``: the same numpy inputs through both, f32;
  logits and outputs within ``RTOL`` = 1e-5 of their largest value.
- ``quant.memory_bytes``: equal on the same bf16 and int8 trees.
- ``DSTACK_TPU_CE_CHUNK``: read at call time, the loss within ``RTOL``
  of JAX's, and JAX's two error messages word for word.
- ``DSTACK_TPU_RAGGED_DECODE=0``: read when the engine is made; a paged
  engine then reads the full block-table span, and its greedy tokens
  equal the JAX engine's at 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.models import llama as j_llama
from dstack_tpu.ops import attention as j_attention
from dstack_tpu.ops import loss as j_loss
from dstack_tpu.serving import engine as j_engine
from dstack_tpu.serving import quant as j_quant
from dstack_tpu_torch.models import llama
from dstack_tpu_torch.ops import attention, loss
from dstack_tpu_torch.serving import engine as t_engine
from dstack_tpu_torch.serving import quant

RTOL = 1e-5
STEPS = 8


def _tree(cfg, seed=0):
    """``init_params``' tree of a tiny config drawn with numpy (f32)."""
    rng = np.random.default_rng(seed)
    d, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def dense(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)

    tree = {
        "embed": dense((cfg.vocab_size, d), d),
        "layers": {
            "attn_norm": np.ones((n, d), np.float32),
            "wq": dense((n, d, cfg.q_dim), d),
            "wk": dense((n, d, cfg.kv_dim), d),
            "wv": dense((n, d, cfg.kv_dim), d),
            "wo": dense((n, cfg.q_dim, d), cfg.q_dim),
            "mlp_norm": np.ones((n, d), np.float32),
            "w_gate": dense((n, d, f), d),
            "w_up": dense((n, d, f), d),
            "w_down": dense((n, f, d), f),
        },
        "final_norm": np.ones((d,), np.float32),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense((d, cfg.vocab_size), d)
    return tree


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


def test_decode_step_matches_jax():
    """Eight steps of two rows from ``init_kv_caches``: each step's logits,
    and the caches after the last, are JAX's; the default device is CUDA,
    which this machine lacks."""
    jcfg = dataclasses.replace(j_llama.LlamaConfig.tiny(), dtype=jnp.float32)
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    tree = _tree(jcfg)
    params = llama.params_from_jax(tree, "cpu", torch.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, STEPS))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama.init_kv_caches(cfg, 2, 16)
    cache = llama.init_kv_caches(cfg, 2, 16, device="cpu")
    assert cache.k.shape == (cfg.num_layers, 2, 16, cfg.num_kv_heads,
                             cfg.head_dim)
    assert cache.k.dtype == torch.float32 and int(cache.length) == 0
    jcache = j_llama.init_kv_caches(jcfg, 2, 16)
    for t in range(STEPS):
        logits, cache = llama.decode_step(
            params, torch.from_numpy(tokens[:, t]), cache, cfg)
        jlogits, jcache = j_llama.decode_step(
            jparams, jnp.asarray(tokens[:, t], jnp.int32), jcache, jcfg)
        assert logits.dtype == torch.float32
        _close(logits.numpy(), jlogits)
    assert int(cache.length) == int(jcache.length) == STEPS
    _close(cache.k.numpy(), jcache.k)
    _close(cache.v.numpy(), jcache.v)


def test_decode_step_attention_matches_jax():
    """One token at a time over a [2, 16, 4, 16] cache (JAX's
    ``test_ops.py`` shapes): every output and the final cache are JAX's,
    and the outputs together are the full causal attention."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 8, h, 16)).astype(np.float32)
               for h in (8, 4, 4))
    zeros = np.zeros((2, 16, 4, 16), np.float32)
    cache = attention.KVCache(k=torch.from_numpy(zeros),
                              v=torch.from_numpy(zeros),
                              length=torch.zeros((), dtype=torch.int32))
    jcache = j_attention.KVCache(k=jnp.asarray(zeros), v=jnp.asarray(zeros),
                                 length=jnp.zeros((), jnp.int32))
    outs = []
    for t in range(8):
        sl = slice(t, t + 1)
        out, cache = attention.decode_step_attention(
            torch.from_numpy(q[:, sl]), cache, torch.from_numpy(k[:, sl]),
            torch.from_numpy(v[:, sl]))
        jout, jcache = j_attention.decode_step_attention(
            jnp.asarray(q[:, sl]), jcache, jnp.asarray(k[:, sl]),
            jnp.asarray(v[:, sl]))
        _close(out.numpy(), jout)
        outs.append(out)
    assert int(cache.length) == 8
    _close(cache.k.numpy(), jcache.k)
    _close(cache.v.numpy(), jcache.v)
    full = attention.causal_attention(*(torch.from_numpy(a)
                                        for a in (q, k, v)))
    _close(torch.cat(outs, dim=1).numpy(), full.numpy())


@pytest.mark.parametrize("tied", [False, True])
def test_memory_bytes_matches_jax(tied):
    """The bytes of the same bf16 tree and of its int8 quantization (a tied
    model's head copy included) are JAX's."""
    jcfg = dataclasses.replace(j_llama.LlamaConfig.tiny(), tie_embeddings=tied)
    tree = _tree(jcfg)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    params = llama.params_from_jax(tree, "cpu", torch.bfloat16)
    assert quant.memory_bytes(params) == j_quant.memory_bytes(jparams)
    jq = j_quant.quantize_params(jparams, tied_head_copy=tied)
    q = quant.quantize_params(params, tied_head_copy=tied)
    assert quant.memory_bytes(q) == j_quant.memory_bytes(jq)
    assert quant.memory_bytes(q) < quant.memory_bytes(params)


def test_ce_chunk_knob_matches_jax(monkeypatch):
    """``DSTACK_TPU_CE_CHUNK=8``, read at the call: the chunk is 8 and the
    loss is JAX's; ``"x"`` and ``"0"`` raise JAX's ValueErrors."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    head = rng.standard_normal((16, 40)).astype(np.float32)
    targets = rng.integers(0, 40, (2, 32))
    mask = (rng.random((2, 32)) < 0.8).astype(np.float32)
    monkeypatch.setenv("DSTACK_TPU_CE_CHUNK", "8")
    assert loss.ce_chunk() == 8
    got = loss.chunked_cross_entropy(
        torch.from_numpy(x), torch.from_numpy(head),
        torch.from_numpy(targets), torch.from_numpy(mask))
    want = j_loss.chunked_cross_entropy(
        jnp.asarray(x), jnp.asarray(head), jnp.asarray(targets, jnp.int32),
        jnp.asarray(mask))
    assert abs(float(got) - float(want)) <= RTOL * abs(float(want))
    for raw in ("x", "0"):
        monkeypatch.setenv("DSTACK_TPU_CE_CHUNK", raw)
        with pytest.raises(ValueError) as jerr:
            j_loss.chunked_cross_entropy(
                jnp.asarray(x), jnp.asarray(head),
                jnp.asarray(targets, jnp.int32))
        with pytest.raises(ValueError) as err:
            loss.chunked_nll_sum(torch.from_numpy(x), torch.from_numpy(head),
                                 torch.from_numpy(targets))
        assert str(err.value) == str(jerr.value)


def test_full_span_paged_decode_matches_jax(monkeypatch):
    """``DSTACK_TPU_RAGGED_DECODE=0`` around the engines' construction: the
    port's paged engine reads every block-table column in every window
    (the ragged one a bucket of 8 of 32), and the engines at 0 give the
    ragged engine's greedy tokens, and JAX's."""
    jcfg = dataclasses.replace(j_llama.LlamaConfig.tiny(), dtype=jnp.float32)
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    tree = _tree(jcfg)
    kw = dict(batch_size=2, max_len=256, paged=True, kv_block_size=8)
    prompts = [[1, 5, 9, 2, 7], list(range(3, 30))]
    monkeypatch.setenv("DSTACK_TPU_RAGGED_DECODE", "0")
    full = t_engine.InferenceEngine(
        cfg, params=llama.params_from_jax(tree, "cpu", torch.float32),
        device="cpu", **kw)
    jeng = j_engine.InferenceEngine(
        jcfg, params=jax.tree.map(jnp.asarray, tree), **kw)
    monkeypatch.delenv("DSTACK_TPU_RAGGED_DECODE")
    ragged = t_engine.InferenceEngine(
        cfg, params=llama.params_from_jax(tree, "cpu", torch.float32),
        device="cpu", **kw)
    spans = {}
    for engine in (full, ragged):
        seen = spans[id(engine)] = []

        def spy(run=engine._do_window, seen=seen, **args):
            seen.append(args["nbk"])
            return run(**args)

        engine._do_window = spy
    outs = []
    for engine, make in ((full, t_engine.Request), (jeng, j_engine.Request),
                         (ragged, t_engine.Request)):
        reqs = [make(tokens=list(p), max_new_tokens=STEPS) for p in prompts]
        for r in reqs:
            engine.submit(r)
        for _ in range(200):
            if all(r.done.is_set() for r in reqs):
                break
            engine.step()
        outs.append([r.output for r in reqs])
    assert set(spans[id(full)]) == {32}
    assert max(spans[id(ragged)]) == 8
    assert outs[0] == outs[1] == outs[2]
