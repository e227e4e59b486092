"""The training slice's parts on the CPU: the loss, the optimizer, plain
attention, parameter trees and the data loader against the JAX package's
(small JAX programs only), and the port's own remat modes, train loop
and refusals.  Whole-model parity with JAX is in ``test_torch_train.py``.

Tolerances are stated at each test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dstack_tpu.models import data as j_data
from dstack_tpu.models import llama as j_llama
from dstack_tpu.models import train as j_train
from dstack_tpu.ops import attention as j_attention
from dstack_tpu.ops import loss as j_loss
from dstack_tpu_torch.models import data, llama, train
from dstack_tpu_torch.ops import flash_attention as fa
from dstack_tpu_torch.ops import loss
from dstack_tpu_torch.ops.attention import causal_attention
from dstack_tpu_torch.parallel import mesh as mesh_lib

torch.set_num_threads(1)

SEQ, BATCH, STEPS = 128, 2, 3
#: the two shapes of test_torch_train.py: head_dim 16 and 64, seq 128
CONFIGS = {
    "tiny": dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                 num_layers=2, num_heads=8, num_kv_heads=4, head_dim=16,
                 max_seq_len=256),
    "d64": dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                max_seq_len=256),
}


def _batches(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
            for _ in range(STEPS)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _loss_and_grads(name, remat):
    """Loss and gradients of one batch from a port init (seed 0)."""
    cfg = llama.LlamaConfig(dtype=torch.float32, **CONFIGS[name])
    params = llama.unstack_params(llama.init_params(
        cfg, "cpu", torch.Generator().manual_seed(0)))
    leaves = llama.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.from_numpy(_batches(cfg.vocab_size)[0])
    x = llama.backbone(params, tokens[:, :-1], cfg, remat=remat)
    value = loss.chunked_cross_entropy(x, llama.output_head(params, cfg),
                                       tokens[:, 1:])
    return value, torch.autograd.grad(value, leaves)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("remat", ["full", "selective", "wide"])
def test_remat_equals_none(name, remat):
    """Recomputing in the backward changes nothing but the order of a few
    gradient sums: 1e-6 on O(1e-2) gradients."""
    want_loss, want = _loss_and_grads(name, False)
    got_loss, got = _loss_and_grads(name, remat)
    assert got_loss.item() == pytest.approx(want_loss.item(), rel=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("remat,fwd_per_layer",
                         [(False, 1), ("full", 2), ("selective", 2),
                          ("wide", 2)])
def test_remat_recomputes_the_attention_forward(remat, fwd_per_layer,
                                                monkeypatch):
    """What the launch counts on the card rest on: one attention forward
    per layer, a second one in the backward under remat, one backward."""
    calls = {"fwd": 0, "bwd": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fa, "flash_attention_fwd_plain",
                        counting("fwd", fa.flash_attention_fwd_plain))
    monkeypatch.setattr(fa, "flash_attention_bwd_plain",
                        counting("bwd", fa.flash_attention_bwd_plain))
    _loss_and_grads("tiny", remat)
    layers = CONFIGS["tiny"]["num_layers"]
    assert calls == {"fwd": fwd_per_layer * layers, "bwd": layers}


REMAT_NAME_CASES = [("qkv",), ("mlp_mid",), ("qkv", "proj", "attn_out")]


@pytest.mark.parametrize("names", REMAT_NAME_CASES,
                         ids=["-".join(n) for n in REMAT_NAME_CASES])
def test_remat_names_match_jax_gradients(names, monkeypatch):
    """Remat as a tuple of checkpoint names: the loss and gradients of one
    batch against JAX's ``backbone(remat=names)`` from one JAX init (f32
    sums in another order: the loss to 2e-6 relative, gradients of O(1e-2)
    to 2e-6), and the attention recomputed in the backward (two flash
    forwards per layer, one backward), as under the named modes."""
    name = "tiny"
    jcfg = j_llama.LlamaConfig(dtype=jnp.float32, **CONFIGS[name])
    cfg = llama.LlamaConfig(dtype=torch.float32, **CONFIGS[name])
    jparams = j_llama.unstack_params(j_llama.init_params(
        jax.random.PRNGKey(0), jcfg))
    tokens = _batches(cfg.vocab_size)[0]

    def jloss(params):
        x = j_llama.backbone(params, jnp.asarray(tokens[:, :-1]), jcfg,
                             remat=names)
        return j_loss.chunked_cross_entropy(
            x, j_llama.output_head(params, jcfg), jnp.asarray(tokens[:, 1:]))

    want, wgrads = jax.value_and_grad(jloss)(jparams)
    calls = {"fwd": 0, "bwd": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fa, "flash_attention_fwd_plain",
                        counting("fwd", fa.flash_attention_fwd_plain))
    monkeypatch.setattr(fa, "flash_attention_bwd_plain",
                        counting("bwd", fa.flash_attention_bwd_plain))
    params = llama.params_from_jax(_np_tree(jparams), "cpu", torch.float32)
    leaves = llama.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    x = llama.backbone(params, torch.from_numpy(tokens[:, :-1]), cfg,
                       remat=names)
    got = loss.chunked_cross_entropy(x, llama.output_head(params, cfg),
                                     torch.from_numpy(tokens[:, 1:]))
    grads = torch.autograd.grad(got, leaves)
    layers = cfg.num_layers
    assert calls == {"fwd": 2 * layers, "bwd": layers}
    assert got.item() == pytest.approx(float(want), rel=2e-6)
    want_grads = llama.tree_leaves(llama.params_from_jax(
        _np_tree(wgrads), "cpu", torch.float32))
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-6, rtol=0)


def test_run_train_loop_completes_with_the_steps_losses():
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(dtype=torch.float32),
                              num_layers=1)
    batches = _batches(cfg.vocab_size)

    def batch_fn(step):
        return {"tokens": torch.from_numpy(batches[step])}

    opt = train.default_optimizer()
    result = train.run_train_loop(
        cfg, opt, batch_fn, steps=STEPS, unstacked=True, remat="full",
        generator=3, device="cpu")
    assert result.status == "completed" and result.step == STEPS
    state = train.create_state(torch.Generator().manual_seed(3), cfg, opt,
                               unstacked=True, device="cpu")
    step_fn = train.make_train_step(cfg, opt, remat="full")
    want = [step_fn(state, batch_fn(i))[1]["loss"].item()
            for i in range(STEPS)]
    assert result.losses == want
    assert result.losses[-1] < result.losses[0]


def test_training_entry_points_need_cuda_unless_the_cpu_is_named(
        monkeypatch):
    """The state goes on the card by default: without one, create_state and
    run_train_loop raise instead of training on the CPU; a generator on
    another device than the state's is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(dtype=torch.float32),
                              num_layers=1)
    opt = train.default_optimizer()
    for gen in (0, torch.Generator().manual_seed(0)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.create_state(gen, cfg, opt)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.run_train_loop(cfg, opt, lambda s: None, steps=1,
                                 generator=gen)
    with pytest.raises(ValueError, match="generator is on cpu"):
        train.create_state(torch.Generator(), cfg, opt, device="meta")
    seeded = train.create_state(5, cfg, opt, device="cpu")
    drawn = train.create_state(torch.Generator().manual_seed(5), cfg, opt,
                               device="cpu")
    for a, b in zip(llama.tree_leaves(seeded.params),
                    llama.tree_leaves(drawn.params)):
        assert a.device.type == "cpu" and torch.equal(a, b)


class _MeshShape:
    """What the refusals read of a DeviceMesh (its axis names and sizes),
    before any collective: no process group is needed."""

    mesh_dim_names = mesh_lib.AXIS_ORDER

    def __init__(self, **sizes):
        spec = mesh_lib.MeshSpec(**sizes)
        self.shape = tuple(spec.sizes[a] for a in mesh_lib.AXIS_ORDER)


def test_not_yet_ported_arguments_raise():
    """Every entry point refuses what stays refused: the JAX package's own
    refusals (seq together with stage; unstacked layers under stage;
    Ulysses with heads that do not split over seq x tensor); remat names
    must be the layer's.  MoE under seq or stage is no longer among them:
    its ranks there are replicas, as in the JAX package's MoE."""
    from dstack_tpu_torch.models import moe

    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    opt = train.default_optimizer()
    tokens = torch.zeros((1, 8), dtype=torch.long)
    both = {"mesh": _MeshShape(seq=2, stage=2), "policy":
            llama.ShardingPolicy(seq_axis="seq", stage_axis="stage")}
    ulysses = {"mesh": _MeshShape(seq=8), "policy": llama.ShardingPolicy(
        seq_axis="seq", seq_scheme="ulysses")}
    for kw, err, match in ((both, NotImplementedError, "can't be combined"),
                           (ulysses, ValueError, "seq_scheme='ulysses'")):
        with pytest.raises(err, match=match):
            train.make_train_step(cfg, opt, **kw)
        with pytest.raises(err, match=match):
            train.run_train_loop(cfg, opt, lambda s: None, steps=1,
                                 generator=torch.Generator(), **kw)
        with pytest.raises(err, match=match):
            train.state_template(cfg, opt, **kw)
        with pytest.raises(err, match=match):
            llama.backbone({}, tokens, cfg, **kw)
    stage = {"mesh": _MeshShape(stage=2),
             "policy": llama.ShardingPolicy(stage_axis="stage")}
    with pytest.raises(NotImplementedError, match="stacked"):
        train.create_state(0, cfg, opt, unstacked=True, **stage)
    with pytest.raises(NotImplementedError, match="stacked"):
        train.state_template(cfg, opt, unstacked=True, **stage)
    with pytest.raises(NotImplementedError, match="stacked"):
        train.run_train_loop(cfg, opt, lambda s: None, steps=1,
                             generator=0, unstacked=True, **stage)
    moe_cfg = moe.MoEConfig.tiny_moe(dtype=torch.float32)
    for mesh, policy in ((_MeshShape(seq=2), llama.ShardingPolicy(
            seq_axis="seq")), (_MeshShape(stage=2), llama.ShardingPolicy(
                stage_axis="stage"))):
        assert callable(moe.make_train_step(moe_cfg, opt, mesh=mesh,
                                            policy=policy))
        layout = moe.ExpertLayout(mesh, policy, moe_cfg, "expert")
        assert layout.seq is None and layout.stage is None
    for remat in ("sometimes", ("qkv", "logits")):
        with pytest.raises(ValueError, match="remat"):
            train.make_train_step(cfg, opt, remat=remat)


@pytest.mark.parametrize("clip", [1e-3, 1e3], ids=["clipped", "unclipped"])
def test_adamw_matches_optax(clip):
    """Three updates of a small tree, optax's clip and adamw against the
    port's clip and torch's fused AdamW: the same f32 arithmetic up to the
    order of its operations (the norm to 1e-6 relative, params to 1e-6)."""
    rng = np.random.default_rng(11)
    tree = {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": [rng.standard_normal(3).astype(np.float32)]}
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), tree) for _ in range(3)]
    jopt = j_train.default_optimizer(lr=1e-2, grad_clip=clip)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    topt = train.default_optimizer(lr=1e-2, grad_clip=clip)
    tparams = llama.tree_map(torch.from_numpy, jax.tree.map(np.copy, tree))
    tstate = topt.init(tparams)
    for g in grads:
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                      jparams)
        jparams = optax.apply_updates(jparams, updates)
        # the update clips the gradients it is given in place; a 2-D one
        # comes as a transposed view, as a tied head's gradient does
        tgrads = [torch.tensor(x) for x in llama.tree_leaves(g)]
        tgrads = [t.T.contiguous().T if t.dim() == 2 else t for t in tgrads]
        norm = topt.update(llama.tree_leaves(tparams), tgrads, tstate)
        assert norm.item() == pytest.approx(
            float(optax.global_norm(jax.tree.map(jnp.asarray, g))), rel=1e-6)
    for got, want in zip(llama.tree_leaves(tparams),
                         llama.tree_leaves(jparams)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("with_mask,chunk", [(False, 512), (True, 48)],
                         ids=["whole", "masked_chunk48"])
def test_chunked_cross_entropy_value_and_grads_match_jax(with_mask, chunk):
    """Chunk 48 does not divide 128 and shrinks to 32 on both sides."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, SEQ, 32)).astype(np.float32)
    head = rng.standard_normal((32, 64)).astype(np.float32) * 0.3
    targets = rng.integers(0, 64, (2, SEQ)).astype(np.int32)
    mask = (rng.random((2, SEQ)) < 0.7).astype(np.int32) if with_mask \
        else None

    def jfn(x, head):
        return j_loss.chunked_cross_entropy(
            x, head, jnp.asarray(targets),
            None if mask is None else jnp.asarray(mask), chunk=chunk)

    want, (wdx, wdh) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    tx, th = (torch.from_numpy(a).requires_grad_() for a in (x, head))
    got = loss.chunked_cross_entropy(
        tx, th, torch.from_numpy(targets),
        None if mask is None else torch.from_numpy(mask), chunk=chunk)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(wdx), atol=1e-7,
                               rtol=0)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(wdh), atol=1e-7,
                               rtol=0)
    assert loss._pick_chunk(SEQ, chunk) == j_loss._pick_chunk(SEQ, chunk)


def test_f32_logits_backward_is_the_f32_matmul_grad_in_bf16():
    """The card's bf16 logits path: its forward needs torch.mm's
    out_dtype (CUDA only, held to an f32 matmul by chip_smoke.py); its
    backward is plain matmuls, checked here against autograd of the f32
    matmul of the same bf16 values, to bf16 rounding (2**-7 relative)."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(
        np.float32)).to(torch.bfloat16)
    head = torch.from_numpy(rng.standard_normal((16, 24)).astype(
        np.float32)).to(torch.bfloat16)
    grad = torch.from_numpy(rng.standard_normal((2, 3, 24)).astype(
        np.float32))
    ctx = type("Ctx", (), {"saved_tensors": (x, head)})()
    dx, dhead = loss._MmF32.backward(ctx, grad)
    x32, h32 = (t.float().requires_grad_() for t in (x, head))
    (x32 @ h32).backward(grad)
    assert dx.dtype == dhead.dtype == torch.bfloat16
    for got, want in ((dx, x32.grad), (dhead, h32.grad)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                                   atol=2 ** -7 * want.abs().max().item(),
                                   rtol=0)


def test_cross_entropy_loss_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = np.array([[1, 1, 0, 1, 0], [0, 1, 1, 1, 1]], np.int32)
    for m in (None, mask):
        want = j_train.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(targets),
            None if m is None else jnp.asarray(m))
        got = train.cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if m is None else torch.from_numpy(m))
        assert got.item() == pytest.approx(float(want), rel=1e-6)


def test_causal_attention_with_positions_matches_jax():
    """The non-fused route: custom positions and a valid length (exact f32
    arithmetic on both sides up to the order of sums)."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 6, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 8)).astype(np.float32)
    qpos = np.array([[3, 4, 5, 6, 7, 8], [0, 1, 2, 3, 4, 5]], np.int32)
    kpos = np.arange(9, dtype=np.int32)[None, :]
    valid = np.array([9, 6], np.int32)
    want = j_attention.causal_attention(
        *map(jnp.asarray, (q, k, v)), q_positions=jnp.asarray(qpos),
        kv_positions=jnp.asarray(kpos), kv_valid_length=jnp.asarray(valid))
    got = causal_attention(
        *map(torch.from_numpy, (q, k, v)),
        q_positions=torch.from_numpy(qpos), kv_positions=torch.from_numpy(kpos),
        kv_valid_length=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_params_from_jax_round_trips_unstacked_trees():
    jcfg = j_llama.LlamaConfig(dtype=jnp.float32, **CONFIGS["tiny"])
    tcfg = llama.LlamaConfig(dtype=torch.float32, **CONFIGS["tiny"])
    stacked = _np_tree(j_llama.init_params(jax.random.PRNGKey(1), jcfg))
    unstacked = _np_tree(j_llama.unstack_params(stacked))
    got = llama.params_from_jax(unstacked, "cpu", torch.float32)
    assert isinstance(got["layers"], list)
    assert len(got["layers"]) == tcfg.num_layers
    for a, b in zip(llama.tree_leaves(got), llama.tree_leaves(unstacked)):
        np.testing.assert_array_equal(a.numpy(), b)
    restacked = llama.stack_params(got)
    for a, b in zip(llama.tree_leaves(restacked), llama.tree_leaves(stacked)):
        np.testing.assert_array_equal(a.numpy(), b)
    again = llama.unstack_params(restacked)
    for a, b in zip(llama.tree_leaves(again), llama.tree_leaves(got)):
        assert torch.equal(a, b)


def test_num_params_and_8b_fit_match_jax():
    for name in ("llama3_1b", "llama3_8b", "tiny"):
        want = getattr(j_llama.LlamaConfig, name)().num_params()
        assert getattr(llama.LlamaConfig, name)().num_params() == want
    jfit, tfit = (j_llama.LlamaConfig.llama3_8b_fit(),
                  llama.LlamaConfig.llama3_8b_fit())
    for field in dataclasses.fields(tfit):
        if field.name != "dtype":
            assert getattr(tfit, field.name) == getattr(jfit, field.name)


def _datasets(tmp_path):
    rng = np.random.default_rng(9)
    shards = [rng.integers(0, 1000, n).astype(np.uint16) for n in (700, 333)]
    paths = []
    for i, shard in enumerate(shards):
        path = tmp_path / f"shard{i}.bin"
        shard.tofile(path)
        paths.append(path)
    return (j_data.TokenDataset.from_files(paths, seq_len=16),
            data.TokenDataset.from_files(paths, seq_len=16))


def test_data_loader_host_batch_matches_jax(tmp_path):
    jds, tds = _datasets(tmp_path)
    assert len(tds) == len(jds)
    for index in (0, len(tds) // 2, len(tds) - 1):
        np.testing.assert_array_equal(tds.window(index), jds.window(index))
    for proc in range(2):
        jl = j_data.DataLoader(jds, global_batch=8, seed=4,
                               process_index=proc, num_processes=2)
        tl = data.DataLoader(tds, global_batch=8, seed=4,
                             process_index=proc, num_processes=2)
        for step in (0, 1, tl.steps_per_epoch, 2 * tl.steps_per_epoch + 1):
            np.testing.assert_array_equal(tl.host_batch(step),
                                          jl.host_batch(step))


def test_data_loader_batches_yield_each_step_in_order(tmp_path):
    _, tds = _datasets(tmp_path)
    loader = data.DataLoader(tds, global_batch=4, seed=2, device="cpu")
    it = loader.batches(step=3)
    for step in range(3, 6):
        batch = next(it)["tokens"]
        assert batch.dtype == torch.int32 and batch.device.type == "cpu"
        np.testing.assert_array_equal(batch.numpy(), loader.host_batch(step))
    with pytest.raises(ValueError, match="process_index"):
        data.DataLoader(tds, global_batch=4, process_index=2,
                        num_processes=2)
