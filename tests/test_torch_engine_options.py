"""The port's serving engine on its own, on the tiny config on the CPU:
the options it refuses, seeded sampling, decode through the kernel
wrapper, the default device, and ``params_from_jax`` on bf16 and int8
leaves.

No JAX program runs here (the engine's parity with the JAX package is
``test_torch_engine.py``).  These tests are apart from it so that the
file of JAX engines holds few tests: xdist (``--dist loadfile``) starts
files with the most tests first, and the JAX compiles then stay out of
the suite's first half-minute, where it runs the dtlint scan-speed
guard.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.models.llama import LlamaConfig as j_config
from dstack_tpu.serving import engine as j_engine
from dstack_tpu_torch.models.llama import LlamaConfig, params_from_jax
from dstack_tpu_torch.serving import engine as t_engine

PROMPTS = [[1, 5, 9, 2, 7], list(range(3, 30))]
ENGINE_KW = dict(batch_size=2, max_len=64, device="cpu")
PAGED_KW = dict(paged=True, kv_block_size=8)
CFG = LlamaConfig.tiny(dtype=torch.float32)

# tiny shapes gain nothing from intra-op threads, and the suite runs
# several test processes at once
torch.set_num_threads(1)


def _run(engine, temperature=0.0, n=6):
    reqs = [t_engine.Request(tokens=list(p), max_new_tokens=n,
                             temperature=temperature) for p in PROMPTS]
    for r in reqs:
        engine.submit(r)
    for _ in range(200):
        if all(r.done.is_set() for r in reqs):
            break
        engine.step()
    assert all(r.done.is_set() for r in reqs)
    return [r.output for r in reqs]


def test_params_from_jax_bf16_and_int8_leaves():
    """A bf16 leaf (numpy's ``jnp.bfloat16`` dtype, as ``np.asarray`` of a
    bf16 jax array gives it) and an int8 ``{"q", "s"}`` quantized weight."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((2, 8, 4)).astype(jnp.bfloat16)
    qw = {"q": rng.integers(-127, 128, (2, 8, 4)).astype(np.int8),
          "s": rng.random((2, 4)).astype(np.float32)}
    out = params_from_jax({"w": w, "qw": qw}, "cpu", torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["w"].float().numpy(),
                                  w.astype(np.float32))
    assert out["qw"]["q"].dtype == torch.int8
    np.testing.assert_array_equal(out["qw"]["q"].numpy(), qw["q"])
    assert out["qw"]["s"].dtype == torch.float32
    np.testing.assert_array_equal(out["qw"]["s"].numpy(), qw["s"])


def test_sampled_decode_is_seed_deterministic():
    def sample(seed):
        engine = t_engine.InferenceEngine(CFG, rng_seed=seed, **ENGINE_KW,
                                          **PAGED_KW)
        return _run(engine, temperature=1.0)

    assert sample(3) == sample(3)


def test_paged_engine_decodes_through_the_kernel_wrapper(monkeypatch):
    """Every decode step calls paged_decode_attention once per layer."""
    calls = []
    real = t_engine.paged_decode_attention

    def spy(*args, **kw):
        calls.append(args[3].shape)
        return real(*args, **kw)

    monkeypatch.setattr(t_engine, "paged_decode_attention", spy)
    engine = t_engine.InferenceEngine(CFG, **ENGINE_KW, **PAGED_KW)
    _run(engine, n=8)
    assert len(calls) == CFG.num_layers * engine.decode_steps > 0


def test_engine_without_device_raises_when_cuda_is_missing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_engine.InferenceEngine(LlamaConfig.tiny())


@pytest.mark.parametrize("kw, head_dim", [
    (dict(kv_quantize="fp8"), 16),
    (dict(paged=True, kv_block_size=12), 16),
    (dict(prefill_chunk=0), 16),
    (dict(prefix_cache=True), 16),
    (dict(speculation="ngram", **PAGED_KW), 16),
    (dict(speculation="eagle"), 16),
    (dict(kv_quantize="int4"), 15),
], ids=["bad-kv", "block-size", "chunk", "prefix-cache-dense",
        "speculation-paged", "speculation-unknown", "int4-odd-head-dim"])
def test_engine_rejects_unsupported_options(kw, head_dim):
    """Each refusal is the JAX engine's too (its checks run before it
    builds any JAX program)."""
    shape = dict(num_heads=4, num_kv_heads=2, head_dim=head_dim)
    with pytest.raises(ValueError):
        t_engine.InferenceEngine(dataclasses.replace(CFG, **shape),
                                 **ENGINE_KW, **kw)
    with pytest.raises(ValueError):
        j_engine.InferenceEngine(dataclasses.replace(j_config.tiny(), **shape),
                                 batch_size=2, max_len=64, **kw)


def test_pick_window_matches_jax():
    pick = t_engine.InferenceEngine._pick_window
    j_pick = j_engine.InferenceEngine._pick_window
    t_self = type("E", (), {"DECODE_WINDOWS": (8, 32, 64),
                            "WINDOW_DISPATCH_COST_STEPS": 8})()
    for remaining in range(1, 130):
        assert pick(t_self, remaining) == j_pick(t_self, remaining)
