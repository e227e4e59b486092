"""The port's checkpointing, train telemetry and HF import on the CPU, with
no JAX program: the single-host cases of the JAX package's
``tests/chaos/test_train_chaos.py`` and ``tests/compute/
test_checkpoint.py`` held by the port, its own snapshots of a training
state (bitwise round trips, moments and AdamW step counts included), and
its safetensors reader against files the ``safetensors`` package writes.
The snapshot format shared with the JAX package is held against JAX in
``test_torch_checkpoint_jax.py``.
"""

import dataclasses
import hashlib
import json
import os
import signal

import numpy as np
import pytest
import torch

from dstack_tpu_torch.models import checkpoint as ckpt
from dstack_tpu_torch.models import llama, train
from dstack_tpu_torch.ops.rotary import RopeScaling
from dstack_tpu_torch.parallel import distributed as dist
from dstack_tpu_torch.telemetry.exposition import parse, render
from dstack_tpu_torch.telemetry.training import TrainTelemetry

torch.set_num_threads(1)

SEQ = 17   # tokens per row (+1 for the target shift)
BATCH = 4


def _cfg_opt():
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(dtype=torch.float32),
                              num_layers=1)
    return cfg, train.default_optimizer(lr=1e-3)


def _batch_fn(cfg):
    def fn(step):
        r = np.random.default_rng(step)
        return {"tokens": torch.from_numpy(r.integers(
            0, cfg.vocab_size, (BATCH, SEQ + 1), dtype=np.int64))}

    return fn


class SimulatedHostLoss(Exception):
    """Injection hook payload: the moral equivalent of a host vanishing."""


def _kill_at(step_to_kill):
    def hook(step, metrics):
        if step == step_to_kill:
            raise SimulatedHostLoss(f"host lost at step {step}")

    return hook


def _assert_states_equal(got, want):
    """Bitwise, leaf by leaf, under the snapshot's paths."""
    g, w = ckpt.state_leaves(got), ckpt.state_leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b), path


# -- snapshot mechanics ------------------------------------------------------


def test_snapshot_publish_is_atomic_and_partial_dirs_invisible(tmp_path):
    state = {"w": torch.arange(12.0).reshape(3, 4),
             "step": torch.tensor(7, dtype=torch.int32)}
    ckpt.write_snapshot(tmp_path, ckpt.snapshot_train_state(state), 7)
    assert ckpt.latest_snapshot_step(tmp_path) == 7

    # a torn write = staging dir that never got published; it must be
    # invisible to readers and to the LATEST pointer
    torn = tmp_path / "step_00000009.tmp"
    torn.mkdir()
    (torn / "host_00000.npz").write_bytes(b"garbage")
    assert ckpt.latest_snapshot_step(tmp_path) == 7
    # ...and a bare (manifest-less) step dir is not a published step either
    (tmp_path / "step_00000011").mkdir()
    assert ckpt.latest_snapshot_step(tmp_path) == 7

    restored, step = ckpt.read_snapshot(tmp_path, state)
    assert step == 7
    assert torch.equal(restored["w"], torch.arange(12.0).reshape(3, 4))
    assert int(restored["step"]) == 7


def test_keep_last_k_prunes_old_steps(tmp_path):
    state = {"w": torch.ones((2, 2))}
    for step in (2, 4, 6, 8):
        ckpt.write_snapshot(tmp_path, ckpt.snapshot_train_state(state), step,
                            keep_last=2)
    assert ckpt.list_snapshot_steps(tmp_path) == [6, 8]
    assert ckpt.latest_snapshot_step(tmp_path) == 8


def test_async_checkpointer_queue_is_bounded_latest_wins(tmp_path):
    """If the writer falls behind, older pending snapshots drop (training
    never stalls on checkpoint I/O) and the newest still publishes."""
    state = {"w": torch.ones((2, 2))}
    cp = ckpt.AsyncCheckpointer(tmp_path, keep_last=10, every_steps=1)
    # stall the writer so the bounded queue actually fills
    cp._ensure_thread = lambda: None
    for step in (1, 2, 3, 4):
        cp.save(state, step)
    assert cp.dropped >= 1
    del cp.__dict__["_ensure_thread"]  # let the real writer run
    cp.save(state, 5, block=True)
    cp.close()
    assert cp.last_published == 5
    steps = set(ckpt.list_snapshot_steps(tmp_path))
    assert 5 in steps and 1 not in steps
    assert set(cp.copy_seconds) == {1, 2, 3, 4, 5}
    assert 5 in cp.write_seconds and cp.snapshot_bytes == 16


def test_read_snapshot_refuses_missing_host_shard(tmp_path):
    """A manifest that records two hosts with one host file left must
    refuse to restore (the survivors could cover a leaf only in part)."""
    state = {"w": torch.arange(8.0).reshape(2, 4)}
    snap = ckpt.snapshot_train_state(state)
    ckpt.stage_snapshot(tmp_path, snap, 3, process_index=0)
    ckpt.stage_snapshot(tmp_path, snap, 3, process_index=1)
    ckpt.publish_snapshot(tmp_path, snap["meta"], 3, num_processes=2)
    _, step = ckpt.read_snapshot(tmp_path, state)
    assert step == 3

    (tmp_path / "step_00000003" / "host_00001.npz").unlink()
    with pytest.raises(ValueError, match="refusing a partial restore"):
        ckpt.read_snapshot(tmp_path, state)


def test_read_snapshot_reassembles_a_leaf_split_across_hosts(tmp_path):
    """A multi-host writer (the JAX package's, sharded) stores each host's
    part of a leaf with its placement: the parts are put back together,
    and a step whose files leave a leaf uncovered is refused."""
    w = torch.arange(8.0).reshape(2, 4)
    meta = [{"path": "['w']", "shape": [2, 4], "dtype": "float32"}]
    for i in range(2):
        part = {"meta": meta, "blobs": {"0/0": {
            "index": [[i, i + 1], [0, 4]], "data": w[i:i + 1].clone()}}}
        ckpt.stage_snapshot(tmp_path, part, 3, process_index=i)
    ckpt.publish_snapshot(tmp_path, meta, 3, num_processes=2)
    got, _ = ckpt.read_snapshot(tmp_path, {"w": torch.zeros(2, 4)})
    assert torch.equal(got["w"], w)

    two = meta + [{"path": "['v']", "shape": [1], "dtype": "float32"}]
    ckpt.stage_snapshot(tmp_path, {"meta": two, "blobs": {"0/0": {
        "index": [[0, 2], [0, 4]], "data": w}}}, 4)
    ckpt.publish_snapshot(tmp_path, two, 4)
    with pytest.raises(ValueError, match="missing data"):
        ckpt.read_snapshot(tmp_path, {"w": w, "v": torch.zeros(1)})


def test_manifest_records_per_shard_checksums(tmp_path):
    state = {"w": torch.arange(12.0).reshape(3, 4)}
    ckpt.write_snapshot(tmp_path, ckpt.snapshot_train_state(state), 5)
    step_dir = tmp_path / "step_00000005"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    assert manifest["format"] == 1 and manifest["num_processes"] == 1
    assert set(manifest["checksums"]) == {"host_00000.npz"}
    want = hashlib.sha256(
        (step_dir / "host_00000.npz").read_bytes()).hexdigest()
    assert manifest["checksums"]["host_00000.npz"] == want
    ckpt.verify_snapshot_checksums(step_dir)


def test_read_snapshot_verify_refuses_corrupt_shard(tmp_path):
    state = {"w": torch.arange(12.0).reshape(3, 4)}
    ckpt.write_snapshot(tmp_path, ckpt.snapshot_train_state(state), 5)
    shard = tmp_path / "step_00000005" / "host_00000.npz"
    data = bytearray(shard.read_bytes())
    data[len(data) // 2] ^= 0xFF
    shard.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="refusing a corrupt shard"):
        ckpt.read_snapshot(tmp_path, state, verify=True)


def test_verify_refuses_unrecorded_shard(tmp_path):
    state = {"w": torch.arange(4.0)}
    ckpt.write_snapshot(tmp_path, ckpt.snapshot_train_state(state), 5)
    step_dir = tmp_path / "step_00000005"
    (step_dir / "host_00009.npz").write_bytes(b"stray")
    with pytest.raises(ValueError, match="never recorded"):
        ckpt.verify_snapshot_checksums(step_dir)


def test_verify_tolerates_pre_checksum_manifest(tmp_path):
    state = {"w": torch.arange(6.0).reshape(2, 3)}
    ckpt.write_snapshot(tmp_path, ckpt.snapshot_train_state(state), 5)
    manifest_path = tmp_path / "step_00000005" / "manifest.json"
    manifest = json.loads(manifest_path.read_text())
    del manifest["checksums"]
    # an OLD manifest, rewritten through the atomic path
    ckpt.write_file_atomic(manifest_path, json.dumps(manifest).encode())
    restored, step = ckpt.read_snapshot(tmp_path, state, verify=True)
    assert step == 5
    assert torch.equal(restored["w"], torch.arange(6.0).reshape(2, 3))


def test_read_snapshot_refuses_a_template_of_another_shape(tmp_path):
    ckpt.write_snapshot(tmp_path, ckpt.snapshot_train_state(
        {"w": torch.ones((2, 3))}), 1)
    with pytest.raises(ValueError, match="does not match the template"):
        ckpt.read_snapshot(tmp_path, {"w": torch.ones((3, 2))})
    with pytest.raises(ValueError, match="does not match the template"):
        ckpt.read_snapshot(tmp_path, {"w": torch.ones((2, 3),
                                                      dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.read_snapshot(tmp_path, {"w": torch.ones((2, 3)),
                                      "v": torch.ones(1)})


def test_preemption_guard_partial_install_restores_handlers():
    before = signal.getsignal(signal.SIGTERM)
    guard = ckpt.PreemptionGuard(signals=(signal.SIGTERM, 0))  # 0 = invalid
    guard.install()
    assert signal.getsignal(signal.SIGTERM) is before
    guard.uninstall()  # degraded to manual-trigger mode: a no-op
    assert signal.getsignal(signal.SIGTERM) is before
    guard.trigger()  # the manual surface still works
    assert guard.preempted


def test_close_surfaces_writer_errors(tmp_path, monkeypatch):
    cp = ckpt.AsyncCheckpointer(tmp_path, every_steps=1)

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "stage_snapshot", boom)
    cp.save({"w": torch.ones((2,))}, 1)
    with pytest.raises(RuntimeError, match="checkpoint writer failed"):
        cp.close()


def test_snapshot_is_a_copy_the_next_in_place_step_cannot_reach(tmp_path):
    """The port's step updates the state in place: the host copy taken at
    save time must keep the saved values after the tensors change."""
    w = torch.arange(6.0)
    cp = ckpt.AsyncCheckpointer(tmp_path, every_steps=1)
    cp._ensure_thread = lambda: None  # hold the write back
    cp.save({"w": w}, 1)
    w.mul_(-1)
    del cp.__dict__["_ensure_thread"]
    cp.save({"w": w}, 2, block=True)
    cp.close()
    one, _ = ckpt.read_snapshot(tmp_path, {"w": w}, 1)
    two, _ = ckpt.read_snapshot(tmp_path, {"w": w}, 2)
    assert torch.equal(one["w"], torch.arange(6.0))
    assert torch.equal(two["w"], -torch.arange(6.0))


def test_interrupted_save_preserves_previous_checkpoint(tmp_path,
                                                        monkeypatch):
    """A preemption mid-save never corrupts the only checkpoint: the write
    goes to a scratch dir published by rename only once complete."""
    path = tmp_path / "ckpt"
    v1 = {"w": torch.arange(6.0).reshape(2, 3),
          "step": torch.tensor(1, dtype=torch.int32)}
    ckpt.save_train_state(path, v1)

    def torn_write(staging, snapshot, process_index):
        (staging / "_TORN").write_text("partial")
        raise RuntimeError("preempted mid-checkpoint-write")

    monkeypatch.setattr(ckpt, "_write_host_file", torn_write)
    v2 = {"w": torch.zeros((2, 3)), "step": torch.tensor(2, dtype=torch.int32)}
    with pytest.raises(RuntimeError, match="preempted"):
        ckpt.save_train_state(path, v2)
    monkeypatch.undo()

    assert not (path / "_TORN").exists()
    restored = ckpt.restore_train_state(path, v1)
    assert torch.equal(restored["w"], torch.arange(6.0).reshape(2, 3))
    assert int(restored["step"]) == 1
    # a crash inside the publish's rename window: only <path>.prev-* left
    os.rename(path, path.with_name("ckpt.prev-1"))
    restored = ckpt.restore_train_state(path, v1)
    assert torch.equal(restored["w"], torch.arange(6.0).reshape(2, 3))


@pytest.mark.parametrize("unstacked", [False, True],
                         ids=["stacked", "unstacked"])
def test_train_state_round_trip_is_bitwise(tmp_path, unstacked):
    """Params, AdamW moments and its step count come back bitwise (bf16
    kept as its 2-byte words), on the device the caller names, from a
    template with no storage; the restored state's next step matches the
    original's."""
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), num_layers=2)
    opt = train.default_optimizer(lr=1e-3)
    batch_fn = _batch_fn(cfg)
    state = train.create_state(0, cfg, opt, unstacked=unstacked,
                               device="cpu")
    step_fn = train.make_train_step(cfg, opt, remat=False)
    for i in range(2):
        state, _ = step_fn(state, batch_fn(i))
    ckpt.save_train_state(tmp_path / "c", state)
    template = train.state_template(cfg, opt, unstacked=unstacked)
    assert all(t.device.type == "meta"
               for t in llama.tree_leaves(template.params))
    restored = ckpt.restore_train_state(tmp_path / "c", template,
                                        device="cpu")
    assert restored.step == 2
    assert restored.opt_state.state[llama.tree_leaves(
        restored.params)[0]]["step"].item() == 2.0
    _assert_states_equal(restored, state)
    paths = [p for p, _ in ckpt.state_leaves(restored)]
    assert paths[0] == ".params['embed']" and paths[-1] == ".step"
    assert ".opt_state[1][0].count" in paths
    _, want = step_fn(state, batch_fn(2))
    _, got = step_fn(restored, batch_fn(2))
    assert got["loss"].item() == want["loss"].item()
    _assert_states_equal(restored, state)


# -- kill / resume -----------------------------------------------------------


def test_kill_mid_train_step_resumes_from_last_published(tmp_path):
    """Hard kill at step 5 with checkpoints every 2 steps: the run resumes
    from published step 4 — not 5 (unpublished), not 0 — and the resumed
    losses are the uninterrupted run's (the CPU step is deterministic)."""
    cfg, opt = _cfg_opt()
    batch_fn = _batch_fn(cfg)
    ckpt_dir = tmp_path / "ckpt"
    with pytest.raises(SimulatedHostLoss):
        train.run_train_loop(
            cfg, opt, batch_fn, steps=8, checkpoint_dir=ckpt_dir,
            checkpoint_every=2, generator=0, on_step=_kill_at(5),
            device="cpu")
    assert ckpt.latest_snapshot_step(ckpt_dir) == 4  # 5 never published

    res = train.run_train_loop(
        cfg, opt, batch_fn, steps=8, checkpoint_dir=ckpt_dir,
        checkpoint_every=2, generator=0, device="cpu")
    assert res.resumed_from == 4
    assert res.step == 8 and res.status == "completed"
    assert res.state.step == 8
    assert len(res.losses) == 4  # steps 5..8 executed, not replayed
    assert res.checkpointer.last_published == 8

    baseline = train.run_train_loop(cfg, opt, batch_fn, steps=8,
                                    generator=0, device="cpu")
    assert baseline.checkpointer is None and baseline.resumed_from is None
    np.testing.assert_allclose(res.losses, baseline.losses[4:], rtol=1e-6)


def test_sigterm_publishes_emergency_snapshot(tmp_path):
    """A real SIGTERM mid-run: the guard trips, the loop flushes a snapshot
    of the current step synchronously and reports preempted; the snapshot
    is that state, bitwise."""
    cfg, opt = _cfg_opt()
    ckpt_dir = tmp_path / "ckpt"

    def send_sigterm(step, metrics):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    with ckpt.PreemptionGuard() as guard:
        res = train.run_train_loop(
            cfg, opt, _batch_fn(cfg), steps=50, checkpoint_dir=ckpt_dir,
            checkpoint_every=1000,  # periodic cadence never fires
            generator=0, guard=guard, on_step=send_sigterm, device="cpu")
    assert signal.getsignal(signal.SIGTERM) is before
    assert res.status == "preempted"
    assert 3 <= res.step <= 4  # signal lands on step 3's check or the next
    assert ckpt.latest_snapshot_step(ckpt_dir) == res.step
    state, start = train.resume_train_state(ckpt_dir, cfg, opt,
                                            device="cpu")
    assert start == res.step
    _assert_states_equal(state, res.state)


def test_resume_needs_a_snapshot_or_a_generator(tmp_path):
    cfg, opt = _cfg_opt()
    with pytest.raises(ValueError, match="no generator"):
        train.resume_train_state(tmp_path, cfg, opt, device="cpu")
    state, start = train.resume_train_state(tmp_path, cfg, opt, generator=0,
                                            device="cpu")
    assert start == 0 and state.step == 0


def test_restores_and_imports_need_cuda_unless_the_cpu_is_named(
        tmp_path, monkeypatch):
    """A resume and an HF import go onto the card by default: without one
    they raise instead of landing on the CPU."""
    cfg, opt = _cfg_opt()
    state = train.create_state(0, cfg, opt, device="cpu")
    ckpt.write_snapshot(tmp_path / "s", ckpt.snapshot_train_state(state), 1)
    hf = llama.LlamaConfig.tiny(tie_embeddings=True)
    _write_hf(tmp_path / "hf", hf, tie=True, shards=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.resume_train_state(tmp_path / "s", cfg, opt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ckpt.load_hf_llama(tmp_path / "hf")
    restored, start = train.resume_train_state(tmp_path / "s", cfg, opt,
                                               device="cpu")
    assert start == 1 and llama.tree_leaves(
        restored.params)[0].device.type == "cpu"


def test_resume_env_contract_roundtrip(monkeypatch):
    monkeypatch.delenv(dist.RESUME_ATTEMPT_ENV, raising=False)
    assert dist.resume_info() is None

    monkeypatch.setenv(dist.RESUME_ATTEMPT_ENV, "2")
    monkeypatch.setenv(dist.RESUME_REASON_ENV, "interrupted_by_no_capacity")
    monkeypatch.setenv(dist.CHECKPOINT_DIR_ENV, "/data/ckpt")
    monkeypatch.delenv(dist.RESUME_FROM_ENV, raising=False)
    assert dist.resume_info() == {"attempt": 2, "resume_from": "/data/ckpt",
                                  "reason": "interrupted_by_no_capacity"}
    # explicit RESUME_FROM wins over the checkpoint-dir echo
    monkeypatch.setenv(dist.RESUME_FROM_ENV, "/data/ckpt-override")
    assert dist.resume_info()["resume_from"] == "/data/ckpt-override"
    # the attempt scopes the staging dir
    assert ckpt._staging_dirname(4) == "step_00000004.tmp-a2"


# -- train telemetry ---------------------------------------------------------


def _step_flops(cfg, experts=1):
    """Model operations of a step at [BATCH, SEQ]: 6 per weight a token
    multiplies (attention, ``experts`` experts' MLPs and the router, the
    head; not the embedding lookup, not the norms) and causal attention's
    14 * head_dim per kept (query, key) pair, query head and layer."""
    d = cfg.hidden_size
    per_layer = (2 * d * cfg.q_dim + 2 * d * cfg.kv_dim
                 + 3 * d * cfg.intermediate_size * experts
                 + d * getattr(cfg, "num_experts", 0))
    weights = cfg.num_layers * per_layer + d * cfg.vocab_size
    pairs = BATCH * SEQ * (SEQ + 1) // 2
    return (6 * weights * BATCH * SEQ
            + 14 * cfg.head_dim * pairs * cfg.num_heads * cfg.num_layers)


def test_train_telemetry_counts_times_and_exposes_strictly():
    cfg, opt = _cfg_opt()
    tel = TrainTelemetry(log_every=0)
    step = train.make_train_step(cfg, opt, telemetry=tel)
    state = train.create_state(0, cfg, opt, device="cpu")
    batch_fn = _batch_fn(cfg)
    losses = [step(state, batch_fn(i))[1]["loss"].item() for i in range(3)]
    assert tel.steps_total.value == 3
    assert tel.tokens_total.value == 3 * BATCH * SEQ
    assert tel.recompiles_total.value == 0  # no compile cache in the port
    assert tel.step_seconds.count == 3
    assert tel.tokens_per_sec.value > 0
    assert tel.mfu.value == pytest.approx(
        _step_flops(cfg) * tel.tokens_per_sec.value / (BATCH * SEQ) / 989e12)
    assert losses[-1] < losses[0]
    text = "\n".join(render(tel.prometheus_samples()))
    names = {s.name for s in parse(text, strict=True)}
    for required in ("dstack_train_steps_total", "dstack_train_tokens_total",
                     "dstack_train_recompiles_total",
                     "dstack_train_step_seconds_bucket",
                     "dstack_train_tokens_per_sec", "dstack_train_mfu"):
        assert required in names, required
    assert tel.stats()


def test_train_telemetry_mfu_counts_the_active_experts_and_attention():
    """An MoE step's MFU counts the ``experts_per_token`` experts a token
    passes through and causal attention, not every expert."""
    from dstack_tpu_torch.models import moe

    cfg = moe.MoEConfig.tiny_moe(dtype=torch.float32)
    opt = train.default_optimizer(lr=1e-3)
    tel = TrainTelemetry(log_every=0)
    step = tel.wrap(moe.make_train_step(cfg, opt), cfg)
    state = moe.create_state(0, cfg, opt, device="cpu")
    batch_fn = _batch_fn(cfg)
    for i in range(2):
        step(state, batch_fn(i))
    tokens = BATCH * SEQ
    flops = _step_flops(cfg, experts=cfg.experts_per_token)
    assert tel.mfu.value == pytest.approx(
        flops * tel.tokens_per_sec.value / tokens / 989e12)
    # all four experts' weights, as 6 * num_params() counted them, are
    # more than the two a token passes through and attention's pairs
    assert flops < 6 * cfg.num_params() * tokens
    assert tel.steps_total.value == 2


# -- Hugging Face import -----------------------------------------------------


def test_safetensors_reader_matches_the_safetensors_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    tensors = {
        "a.bf16": torch.randn((3, 5), generator=g).to(torch.bfloat16),
        "b.f16": torch.randn((7,), generator=g).to(torch.float16),
        "c.f32": torch.randn((4, 2, 3), generator=g),
        "d.scalar": torch.tensor(2.5),
        "e.odd": torch.randn((1, 3), generator=g).to(torch.bfloat16),
    }
    path = tmp_path / "x.safetensors"
    st.save_file(tensors, str(path), metadata={"format": "pt"})
    got = ckpt.read_safetensors(path)
    assert set(got) == set(tensors)
    for name, want in tensors.items():
        assert got[name].dtype == want.dtype, name
        assert got[name].shape == want.shape, name
        assert torch.equal(got[name], want), name
    st.save_file({"ids": torch.arange(4)}, str(tmp_path / "i.safetensors"))
    with pytest.raises(ValueError, match="I64"):
        ckpt.read_safetensors(tmp_path / "i.safetensors")


def _write_hf(path, cfg, tie, seed=0, shards=2):
    """A synthetic HF Llama checkpoint (safetensors package, [out, in]
    weights) in ``shards`` files, and its tensors."""
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(seed)
    d, f = cfg.hidden_size, cfg.intermediate_size

    def r(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)

    t = {"model.embed_tokens.weight": r(cfg.vocab_size, d),
         "model.norm.weight": r(d)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        t.update({
            p + "input_layernorm.weight": r(d),
            p + "post_attention_layernorm.weight": r(d),
            p + "self_attn.q_proj.weight": r(cfg.q_dim, d),
            p + "self_attn.k_proj.weight": r(cfg.kv_dim, d),
            p + "self_attn.v_proj.weight": r(cfg.kv_dim, d),
            p + "self_attn.o_proj.weight": r(d, cfg.q_dim),
            p + "mlp.gate_proj.weight": r(f, d),
            p + "mlp.up_proj.weight": r(f, d),
            p + "mlp.down_proj.weight": r(d, f),
        })
    if not tie:
        t["lm_head.weight"] = r(cfg.vocab_size, d)
    path.mkdir(parents=True, exist_ok=True)
    names = sorted(t)
    for k in range(shards):
        st.save_file({n: t[n] for n in names[k::shards]},
                     str(path / f"model-{k + 1:05d}-of-{shards:05d}"
                         ".safetensors"))
    (path / "config.json").write_text(json.dumps({
        "vocab_size": cfg.vocab_size, "hidden_size": d,
        "intermediate_size": f, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_eps,
        "max_position_embeddings": cfg.max_seq_len,
        "tie_word_embeddings": tie,
        "rope_scaling": {"rope_type": "llama3", "factor": 32.0,
                         "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                         "original_max_position_embeddings": 8192}}))
    return t


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_load_hf_llama_transposes_stacks_and_casts(tmp_path, tie):
    want_cfg = llama.LlamaConfig.tiny(
        tie_embeddings=tie, rope_scaling=RopeScaling(32.0, 1.0, 4.0, 8192))
    t = _write_hf(tmp_path, want_cfg, tie)
    cfg, params = ckpt.load_hf_llama(tmp_path, device="cpu")
    assert cfg == want_cfg
    assert list(params) == ["embed", "layers", "final_norm"] + (
        [] if tie else ["lm_head"])
    assert torch.equal(params["embed"], t["model.embed_tokens.weight"])
    assert torch.equal(params["final_norm"], t["model.norm.weight"])
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj", "attn_norm": "input_layernorm",
             "mlp_norm": "post_attention_layernorm"}
    for key, hf in names.items():
        w = params["layers"][key]
        assert w.shape[0] == cfg.num_layers and w.is_contiguous()
        for i in range(cfg.num_layers):
            src = t[f"model.layers.{i}.{hf}.weight"]
            assert torch.equal(w[i], src if src.dim() == 1 else src.T), key
    if not tie:
        assert torch.equal(params["lm_head"], t["lm_head.weight"].T)
    cfg32, p32 = ckpt.load_hf_llama(tmp_path, dtype=torch.float32,
                                    device="cpu")
    assert cfg32.dtype == torch.float32
    assert torch.equal(p32["layers"]["wq"][1],
                       t["model.layers.1.self_attn.q_proj.weight"].T.float())


def test_config_from_hf_defaults_and_refusals(tmp_path):
    base = {"vocab_size": 32, "hidden_size": 16, "intermediate_size": 32,
            "num_hidden_layers": 1, "num_attention_heads": 2}
    (tmp_path / "config.json").write_text(json.dumps(base))
    cfg = ckpt.config_from_hf(tmp_path)
    # absent keys take transformers' defaults, not the Llama-3 ones
    assert (cfg.num_kv_heads, cfg.head_dim, cfg.rope_theta, cfg.rms_eps,
            cfg.rope_scaling, cfg.tie_embeddings) == (2, 8, 10_000.0, 1e-6,
                                                      None, False)
    (tmp_path / "config.json").write_text(json.dumps(
        {**base, "rope_scaling": {"type": "yarn", "factor": 4.0}}))
    with pytest.raises(ValueError, match="unsupported rope_scaling"):
        ckpt.config_from_hf(tmp_path)
    with pytest.raises(FileNotFoundError, match="safetensors"):
        ckpt.load_hf_llama(tmp_path, cfg=cfg, device="cpu")
