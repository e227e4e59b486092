"""The port's checkpoints, HF import and train telemetry against the JAX
package's, on the CPU.

A snapshot written by either package restores in the other, bitwise
(bf16 params and moments, AdamW's count, the step); a JAX run snapshotted
at step 2 continues in the port beside JAX's own step 3; both packages
import the same ``transformers``-written checkpoint; both telemetries
expose the same samples.  Seven tests, the JAX states built once per
module: the file stays out of the early window of the dtlint scan guard
(see ROADMAP.md, "The port's tests stay light").

Tolerances (f32, as ``test_torch_train.py`` states them): the resumed
step's loss to 2e-6 relative; parameters after it within 2 * lr (an
element whose gradient is rounding noise may move by lr either way), and
99.9% of them within 1e-6.  Logits against ``transformers`` within 2e-3,
as the JAX package's own import test holds its logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.models import checkpoint as j_ckpt
from dstack_tpu.models import llama as j_llama
from dstack_tpu.models import train as j_train
from dstack_tpu.telemetry.training import TrainTelemetry as JTrainTelemetry
from dstack_tpu_torch.models import checkpoint as ckpt
from dstack_tpu_torch.models import llama, train
from dstack_tpu_torch.telemetry.training import TrainTelemetry

torch.set_num_threads(1)

LR = 1e-3
LOSS_RTOL = 2e-6
PARAM_ATOL = 2 * LR
CLOSE_ATOL, CLOSE_SHARE = 1e-6, 0.999
SEQ, BATCH = 16, 2
LAYOUTS = pytest.mark.parametrize("unstacked", [False, True],
                                  ids=["stacked", "unstacked"])


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch_fn(vocab):
    def fn(step):
        r = np.random.default_rng(100 + step)
        return {"tokens": r.integers(0, vocab, (BATCH, SEQ + 1),
                                     dtype=np.int32)}

    return fn


def _raw(x) -> bytes:
    """The bytes of a leaf, torch or numpy (bf16 included)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


@pytest.fixture(scope="module")
def jax_states():
    """Per layout, a JAX ``tiny`` bf16 TrainState whose AdamW moments are
    drawn at random and whose count and step are 3 (no train step is
    compiled for it)."""
    jcfg = j_llama.LlamaConfig.tiny()
    jopt = j_train.default_optimizer()
    out = {}
    for unstacked in (False, True):
        st = j_train.create_state(jax.random.PRNGKey(0), jcfg, jopt,
                                  unstacked=unstacked)
        rng = np.random.default_rng(1)

        def rand(a, positive=False):
            x = rng.standard_normal(a.shape).astype(np.float32)
            return jnp.asarray(np.abs(x) if positive else x).astype(a.dtype)

        adam = st.opt_state[1][0]
        adam = adam._replace(
            count=jnp.int32(3), mu=jax.tree.map(rand, adam.mu),
            nu=jax.tree.map(lambda a: rand(a, True), adam.nu))
        opt_state = (st.opt_state[0], (adam,) + tuple(st.opt_state[1][1:]))
        out[unstacked] = (j_train.TrainState(params=st.params,
                                             opt_state=opt_state,
                                             step=jnp.int32(3)), jopt)
    return jcfg, out


@LAYOUTS
def test_jax_snapshot_restores_in_the_port(tmp_path, jax_states, unstacked):
    """Bitwise: the params as ``params_from_jax`` gives them, AdamW's
    moments as its exp_avg/exp_avg_sq, the count as its step."""
    _, states = jax_states
    state, _ = states[unstacked]
    j_ckpt.write_snapshot(tmp_path, j_ckpt.snapshot_train_state(state), 3,
                          process_index=0, num_processes=1)
    cfg = llama.LlamaConfig.tiny()
    opt = train.default_optimizer()
    got, step = ckpt.read_snapshot(
        tmp_path, train.state_template(cfg, opt, unstacked=unstacked),
        device="cpu")
    assert step == 3 and got.step == 3
    adam = state.opt_state[1][0]
    want = [llama.params_from_jax(_np_tree(tree), "cpu", torch.bfloat16)
            for tree in (state.params, adam.mu, adam.nu)]
    assert len(llama.tree_leaves(got.params)) == len(
        llama.tree_leaves(want[0]))

    def same(p, w, m, v):
        s = got.opt_state.state[p]
        return (p.dtype == torch.bfloat16 and p.requires_grad
                and torch.equal(p, w) and torch.equal(s["exp_avg"], m)
                and torch.equal(s["exp_avg_sq"], v)
                and s["step"].dtype == torch.float32
                and s["step"].item() == 3.0)

    # tree_map pairs the leaves by key (JAX's trees come back key-sorted)
    assert all(llama.tree_leaves(llama.tree_map(same, got.params, *want)))


@LAYOUTS
def test_port_snapshot_restores_in_jax(tmp_path, unstacked):
    """A port state after one CPU step, read by JAX's ``read_snapshot``
    against a JAX template: the same paths and shapes, every leaf's bytes
    equal."""
    cfg = llama.LlamaConfig.tiny()
    opt = train.default_optimizer()
    state = train.create_state(0, cfg, opt, unstacked=unstacked,
                               device="cpu")
    batch = _batch_fn(cfg.vocab_size)(0)
    state, _ = train.make_train_step(cfg, opt)(
        state, {"tokens": torch.from_numpy(batch["tokens"])})
    ckpt.write_snapshot(tmp_path, ckpt.snapshot_train_state(state), 1)
    template = j_train.state_template(j_llama.LlamaConfig.tiny(),
                                      j_train.default_optimizer(),
                                      unstacked=unstacked)
    jstate, step = j_ckpt.read_snapshot(tmp_path, template)
    assert step == 1
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate)
    mine = ckpt.state_leaves(state)
    assert [jax.tree_util.keystr(k) for k, _ in flat] == [p for p, _ in mine]
    for (kp, jleaf), (_, leaf) in zip(flat, mine):
        jleaf = np.asarray(jleaf)
        assert list(jleaf.shape) == list(leaf.shape)
        assert _raw(jleaf) == _raw(leaf), jax.tree_util.keystr(kp)
    assert int(jstate.opt_state[1][0].count) == 1 and int(jstate.step) == 1


def test_port_continues_a_jax_run(tmp_path):
    """JAX trains 2 steps and publishes; the port resumes that snapshot and
    takes step 3 beside JAX's own resumed step 3."""
    jcfg = j_llama.LlamaConfig.tiny(dtype=jnp.float32)
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    batch_fn = _batch_fn(cfg.vocab_size)
    jopt = j_train.default_optimizer(lr=LR)
    first = j_train.run_train_loop(
        jcfg, jopt, batch_fn, steps=2, checkpoint_dir=tmp_path,
        rng=jax.random.PRNGKey(0))
    assert first.status == "completed"
    opt = train.default_optimizer(lr=LR)
    state, start = train.resume_train_state(tmp_path, cfg, opt, device="cpu")
    assert start == 2 and state.step == 2
    step_fn = train.make_train_step(cfg, opt, remat=False)
    state, metrics = step_fn(
        state, {"tokens": torch.from_numpy(batch_fn(2)["tokens"])})
    assert metrics["step"] == 3
    resumed = j_train.run_train_loop(
        jcfg, jopt, batch_fn, steps=3, checkpoint_dir=tmp_path,
        rng=jax.random.PRNGKey(0))
    assert resumed.resumed_from == 2 and len(resumed.losses) == 1
    np.testing.assert_allclose(metrics["loss"].item(), resumed.losses[0],
                               rtol=LOSS_RTOL)

    def delta(got, want):
        assert got.shape == want.shape
        return np.abs(got.detach().numpy() - want).ravel()

    diff = np.concatenate(llama.tree_leaves(llama.tree_map(
        delta, state.params, _np_tree(resumed.state.params))))
    assert diff.max() <= PARAM_ATOL, diff.max()
    assert np.mean(diff <= CLOSE_ATOL) >= CLOSE_SHARE


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    """A tiny HF Llama checkpoint written by transformers itself, and its
    logits on two rows (the JAX package's import fixture)."""
    transformers = pytest.importorskip("transformers")
    conf = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=256, rope_theta=10_000.0,
        rms_norm_eps=1e-5, tie_word_embeddings=False,
        attn_implementation="eager")
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(conf).eval()
    path = tmp_path_factory.mktemp("hf-ckpt")
    model.save_pretrained(path, safe_serialization=True)
    tokens = [[1, 17, 99, 4, 64, 23, 8], [2, 5, 5, 100, 42, 7, 12]]
    with torch.no_grad():
        ref_logits = model(torch.tensor(tokens)).logits.numpy()
    return path, tokens, ref_logits


def test_hf_import_matches_jax_and_transformers(hf_checkpoint):
    path, tokens, ref_logits = hf_checkpoint
    jcfg, jparams = j_ckpt.load_hf_llama(path, dtype=jnp.float32)
    cfg, params = ckpt.load_hf_llama(path, dtype=torch.float32, device="cpu")
    assert dataclasses.asdict(cfg) == {
        **dataclasses.asdict(jcfg), "dtype": torch.float32}
    want = llama.params_from_jax(_np_tree(jparams), "cpu", torch.float32)
    assert sorted(params) == sorted(want)
    assert all(llama.tree_leaves(llama.tree_map(torch.equal, params, want)))
    with torch.no_grad():
        logits = llama.forward(params, torch.tensor(tokens), cfg).numpy()
    assert logits.shape == ref_logits.shape
    np.testing.assert_allclose(logits, ref_logits, atol=2e-3, rtol=2e-3)


def test_train_telemetry_samples_match_jax():
    """The same record_step sequence gives the same samples: names,
    labels, values and types (MFU against one stated peak)."""
    calls = [(0.5, 1024, True), (0.1, 1024, False), (0.02, 2048, False),
             (3.0, 512, False), (0.3, 0, False)]
    tels = [cls(num_params=1_000_000, peak_flops=1e12, log_every=2)
            for cls in (JTrainTelemetry, TrainTelemetry)]
    for tel in tels:
        for wall, tokens, recompiled in calls:
            tel.record_step(wall, tokens, recompiled=recompiled)

    def rows(tel):
        return [(s.name, sorted(s.labels.items()), s.value, s.type)
                for s in tel.prometheus_samples()]

    assert rows(tels[1]) == rows(tels[0])
    assert tels[1].stats() == tels[0].stats()
