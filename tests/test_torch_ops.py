"""The port's plain ops against the JAX package's, on the same numpy inputs.

Everything runs in float32 on the CPU.  Tolerances: 1e-6 absolute where
both sides do the same float32 elementwise work (only the order of a sum
or the libm of cos/sin can differ, a few ulps at these magnitudes); exact
equality where the code is host numpy on both sides or integer output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.ops import rmsnorm as j_rmsnorm
from dstack_tpu.ops import rotary as j_rotary
from dstack_tpu.serving import quant as j_quant
from dstack_tpu_torch.models.llama import LlamaConfig
from dstack_tpu_torch.ops import rmsnorm, rotary
from dstack_tpu_torch.serving import quant
from dstack_tpu_torch.serving.engine import InferenceEngine

ATOL = 1e-6

# tiny shapes gain nothing from intra-op threads, and the suite runs
# several test processes at once
torch.set_num_threads(1)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_rms_norm_matches_jax():
    x, w = _rand(0, 2, 5, 32), _rand(1, 32)
    want = np.asarray(j_rmsnorm.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    got = rmsnorm.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_rms_norm_keeps_input_dtype():
    x = torch.from_numpy(_rand(2, 3, 8)).to(torch.bfloat16)
    out = rmsnorm.rms_norm(x, torch.ones(8, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("scaled", [False, True])
def test_rope_frequencies_match_jax_exactly(scaled):
    # host numpy on both sides: bit-identical tables
    j_sc = j_rotary.RopeScaling() if scaled else None
    t_sc = rotary.RopeScaling() if scaled else None
    want = j_rotary.rope_frequencies(64, 500_000.0, j_sc)
    got = rotary.rope_frequencies(64, 500_000.0, t_sc)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scaled", [False, True])
def test_apply_rope_matches_jax(scaled):
    x = _rand(3, 2, 7, 4, 16)
    positions = np.random.default_rng(4).integers(0, 64, (2, 7))
    j_sc = j_rotary.RopeScaling() if scaled else None
    t_sc = rotary.RopeScaling() if scaled else None
    want = np.asarray(j_rotary.apply_rope(
        jnp.asarray(x), jnp.asarray(positions),
        jnp.asarray(j_rotary.rope_frequencies(16, 10_000.0, j_sc))))
    got = rotary.apply_rope(
        torch.from_numpy(x), torch.from_numpy(positions),
        torch.from_numpy(rotary.rope_frequencies(16, 10_000.0, t_sc))).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_apply_rope_uses_split_halves():
    # position 1, one frequency pair: (x1, x2) -> (x1 cos - x2 sin,
    # x2 cos + x1 sin) with x1 the first HALF of the head dim
    x = torch.tensor([[[[1.0, 0.0]]]])
    inv = torch.tensor([np.pi / 2], dtype=torch.float32)
    out = rotary.apply_rope(x, torch.tensor([[1]]), inv)
    np.testing.assert_allclose(out.numpy().ravel(), [0.0, 1.0], atol=1e-6)


def test_quantize_kv_matches_jax():
    x = _rand(5, 3, 4, 2, 16) * 3
    jq, js = j_quant.quantize_kv(jnp.asarray(x))
    tq, ts = quant.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=0, rtol=1e-7)
    want = np.asarray(j_quant.dequantize_kv(jq, js, jnp.float32))
    got = quant.dequantize_kv(tq, ts, torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_quantize_weight_and_qmatmul_match_jax():
    w, x = _rand(6, 2, 32, 24), _rand(7, 5, 32)
    jw = j_quant.quantize_weight(jnp.asarray(w))
    tw = quant.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tw["q"].numpy(), np.asarray(jw["q"]))
    np.testing.assert_allclose(tw["s"].numpy(), np.asarray(jw["s"]),
                               atol=0, rtol=1e-7)
    jw0 = {"q": jw["q"][0], "s": jw["s"][0]}
    tw0 = {"q": tw["q"][0], "s": tw["s"][0]}
    want = np.asarray(j_quant.qmatmul(jnp.asarray(x), jw0, jnp.float32,
                                      preferred=jnp.float32))
    got = quant.qmatmul(torch.from_numpy(x), tw0, torch.float32,
                        preferred=torch.float32).numpy()
    # a 32-term f32 dot: association differences only
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_quantize_params_covers_layers_and_tied_head():
    layers = {name: torch.from_numpy(_rand(i, 2, 8, 8))
              for i, name in enumerate(quant._LAYER_WEIGHTS)}
    layers["attn_norm"] = torch.ones(2, 8)
    params = {"embed": torch.from_numpy(_rand(9, 16, 8)), "layers": layers}
    out = quant.quantize_params(params, tied_head_copy=True)
    for name in quant._LAYER_WEIGHTS:
        assert out["layers"][name]["q"].dtype == torch.int8
    assert out["layers"]["attn_norm"] is layers["attn_norm"]
    assert out["lm_head"]["q"].shape == (8, 16)
    assert out["embed"] is params["embed"]


def _sampler_reference(logits, temps, top_ps, top_ks, uniform):
    """numpy transcription of the JAX engine's _sample_on_device with its
    uniform draws handed in."""
    k = uniform.shape[-1]
    idx = np.argsort(-logits, axis=-1, kind="stable")[:, :k]
    vals = np.take_along_axis(logits, idx, axis=-1)
    scaled = vals / np.maximum(temps, 1e-6)[:, None]
    rank = np.arange(k)[None, :]
    scaled = np.where((top_ks[:, None] <= 0) | (rank < top_ks[:, None]),
                      scaled, -np.inf)
    e = np.exp(scaled - scaled.max(-1, keepdims=True))
    probs = e / e.sum(-1, keepdims=True)
    keep = (np.cumsum(probs, -1) - probs) < top_ps[:, None]
    masked = np.where(keep, scaled, -np.inf)
    gumbel = -np.log(-np.log(np.clip(uniform, 1e-20, 1.0)) + 1e-20)
    choice = np.argmax(masked + gumbel, axis=-1)
    sampled = idx[np.arange(len(idx)), choice]
    return np.where(temps > 0, sampled, idx[:, 0])


def test_sampler_matches_reference_with_fed_noise():
    engine = InferenceEngine(LlamaConfig.tiny(dtype=torch.float32),
                             batch_size=4, max_len=64, device="cpu")
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((4, 512)).astype(np.float32) * 3
    temps = np.array([0.0, 0.7, 1.0, 1.3], np.float32)
    top_ps = np.array([1.0, 0.9, 0.5, 1.0], np.float32)
    top_ks = np.array([0, 0, 20, 5], np.int64)
    uniform = rng.random((4, 512)).astype(np.float32)
    got = engine._sample_on_device(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(top_ps), torch.from_numpy(top_ks),
        torch.from_numpy(uniform)).numpy()
    want = _sampler_reference(logits, temps, top_ps, top_ks, uniform)
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.argmax(logits[0])  # greedy row is argmax
