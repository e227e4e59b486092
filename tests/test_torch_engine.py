"""The port's serving engine against the JAX package's, on the tiny config.

Both sides run ``LlamaConfig.tiny`` in float32 on the CPU with the same
weights: numpy draws from a seed in the JAX package's stacked layout and
scales (``init_params``), as jax arrays on one side and through
``params_from_jax`` on the other.
Greedy tokens must be EQUAL: the two engines compute the same function in
the same dtype and only the order of float32 sums can differ, far below
the gap between a greedy token's logit and the runner-up's on this model.
The paged JAX reference is forced onto its Pallas kernel (interpret mode),
so the port's paged path is held to the kernel it replaces.

The file builds three JAX engines (dense, paged, paged int8) and no other
JAX program it can avoid: both prompts fall in one prefill bucket, so each
engine compiles one prefill and one decode window.  The engine's tests
that need no JAX program are in ``test_torch_engine_options.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.models.llama import LlamaConfig as JConfig
from dstack_tpu.models.llama import init_params as j_init
from dstack_tpu.serving import engine as j_engine
from dstack_tpu_torch.models.llama import LlamaConfig, params_from_jax
from dstack_tpu_torch.serving import engine as t_engine

PROMPTS = [[1, 5, 9, 2, 7], list(range(3, 30))]  # both in the 32 bucket
NEW_TOKENS = 8
ENGINE_KW = dict(batch_size=2, max_len=64)
PAGED_KW = dict(paged=True, kv_block_size=8)

# tiny shapes gain nothing from intra-op threads, and the suite runs
# several test processes at once
torch.set_num_threads(1)


def _np_params(jcfg, seed=0):
    """``init_params``'s tree (shapes, fan-in scales, unit norms), drawn
    with numpy."""
    rng = np.random.default_rng(seed)
    d, f, n = jcfg.hidden_size, jcfg.intermediate_size, jcfg.num_layers

    def dense(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)

    tree = {
        "embed": dense((jcfg.vocab_size, d), d),
        "layers": {
            "attn_norm": np.ones((n, d), np.float32),
            "wq": dense((n, d, jcfg.q_dim), d),
            "wk": dense((n, d, jcfg.kv_dim), d),
            "wv": dense((n, d, jcfg.kv_dim), d),
            "wo": dense((n, jcfg.q_dim, d), jcfg.q_dim),
            "mlp_norm": np.ones((n, d), np.float32),
            "w_gate": dense((n, d, f), d),
            "w_up": dense((n, d, f), d),
            "w_down": dense((n, f, d), f),
        },
        "final_norm": np.ones((d,), np.float32),
    }
    if not jcfg.tie_embeddings:
        tree["lm_head"] = dense((d, jcfg.vocab_size), d)
    return tree


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32)
    np_tree = _np_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_tree)
    assert (jax.tree.structure(jparams) == jax.tree.structure(
        jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), jcfg))))
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    return jcfg, jparams, cfg, params_from_jax(np_tree, "cpu", torch.float32)


def _run(engine, request_cls, prompts=PROMPTS, n=NEW_TOKENS):
    reqs = [request_cls(tokens=list(p), max_new_tokens=n) for p in prompts]
    for r in reqs:
        engine.submit(r)
    for _ in range(200):
        if all(r.done.is_set() for r in reqs):
            break
        engine.step()
    assert all(r.done.is_set() for r in reqs)
    return [r.output for r in reqs]


def _port_tokens(weights, **kw):
    _, _, cfg, params = weights
    engine = t_engine.InferenceEngine(cfg, params=params, device="cpu",
                                      **ENGINE_KW, **kw)
    return _run(engine, t_engine.Request)


def _jax_tokens(weights, **kw):
    jcfg, jparams, _, _ = weights
    engine = j_engine.InferenceEngine(jcfg, params=jparams, **ENGINE_KW, **kw)
    return _run(engine, j_engine.Request)


def test_params_from_jax_round_trip(weights):
    _, jparams, _, params = weights
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == 12
    for path, leaf in flat_j:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape  # no transpose
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_prompt_forward_matches_jax(weights):
    """Last-position logits and every layer's K/V of a padded prompt.
    Tolerance 1e-4: f32 through two layers of 128-wide matmuls, summed in
    another order on each side."""
    jcfg, jparams, cfg, params = weights
    padded = np.zeros((32,), np.int32)
    padded[:11] = np.arange(11) * 7 % 512
    # one compiled program instead of op-by-op dispatch
    j_logits, j_ks, j_vs = jax.jit(
        j_engine._prompt_forward, static_argnums=(1, 3, 4))(
        jparams, jcfg, jnp.asarray(padded), 11, 32)
    t_logits, t_ks, t_vs = t_engine._prompt_forward(
        params, cfg, torch.from_numpy(padded.astype(np.int64)), 11, 32)
    assert tuple(t_ks.shape) == j_ks.shape == (2, 1, 32, 4, 16)
    for got, want in ((t_logits, j_logits), (t_ks, j_ks), (t_vs, j_vs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)


@pytest.fixture(scope="module")
def dense_tokens(weights):
    return _jax_tokens(weights)


def test_dense_greedy_matches_jax(weights, dense_tokens):
    assert _port_tokens(weights) == dense_tokens


def test_paged_greedy_matches_jax_kernel(weights, monkeypatch):
    monkeypatch.setenv("DSTACK_TPU_PAGED_ATTN_KERNEL", "1")
    want = _jax_tokens(weights, **PAGED_KW)
    assert _port_tokens(weights, **PAGED_KW) == want


def test_paged_int8_kv_greedy_matches_jax_kernel(weights, monkeypatch):
    monkeypatch.setenv("DSTACK_TPU_PAGED_ATTN_KERNEL", "1")
    want = _jax_tokens(weights, kv_quantize="int8", **PAGED_KW)
    assert _port_tokens(weights, kv_quantize="int8", **PAGED_KW) == want


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chunked_prefill_matches_whole_prompt(weights, dense_tokens, paged):
    """Chunks of 8 (the long prompt takes 4 chunks, interleaved with the
    short prompt's decode windows) give the whole-prompt tokens, which the
    dense test holds to the JAX engine."""
    kw = dict(PAGED_KW) if paged else {}
    assert _port_tokens(weights, prefill_chunk=8, **kw) == dense_tokens
