"""The port's sequence and pipeline parallelism against the JAX package's,
on the CPU.

One gloo world of four ranks is spawned once for the module (each rank a
process formed by ``parallel.distributed.initialize`` from the control
plane's variables, one CPU thread each); it runs every sharded part and
rank 0 hands the results back.  The JAX side runs once per module on the
conftest's virtual CPU devices, its Pallas kernels in interpret mode.
The tiny config in f32 (JAX's own choice for its pipeline on the CPU,
whose bf16 psum crashes there) at 128 tokens.

What runs in the world:
- ``ring_attention_sharded`` and ``ulysses_attention_sharded``, forward
  and gradients, at ``seq=4`` and ``seq=2 x tensor=2``;
- ``pipeline_layers`` on a tanh layer at ``stage=4`` (M=4 and M=8),
  forward and gradients, and the Llama forward at ``stage=2 x fsdp=2``;
- three train steps from one JAX init: ring at ``seq=4`` (unstacked),
  Ulysses at ``seq=2 x fsdp=2`` (stacked, remat "selective"), the
  pipeline at ``stage=2 x fsdp=2`` (M=2, remat "selective"), each rank
  feeding its rows and stripe of the global batch (``rank_tokens``);
- an ``AsyncCheckpointer`` snapshot of the pipelined state by four
  ranks; then two of the ranks form a world of two and restore it onto
  ``shrink_spec``'s mesh (stage=2 kept).

Tolerances (f32), as ``test_torch_parallel.py``'s:
- ``LOSS_RTOL`` 1e-5 relative on losses and grad norms;
- ``PARAM_ATOL`` 2 * lr * steps on parameters, all but a few elements
  within 1e-6;
- ``ATTN_ATOL`` 2e-6 on attention outputs and gradients (the flash plain
  versions against JAX's kernels at head_dim 16, and ring's f32 blocks
  against JAX's, summed in another order);
- ``PIPE_ATOL`` on the tanh pipeline: 1e-6 on its output, 1e-5 on the
  gradients (JAX's tests hold its pipeline to the plain scan so); 1e-5
  on the pipelined Llama logits;
- snapshots bitwise.
"""

import dataclasses
import multiprocessing
import os
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dstack_tpu.models import checkpoint as j_ckpt
from dstack_tpu.models import llama as j_llama
from dstack_tpu.models import train as j_train
from dstack_tpu.ops.ring_attention import ring_attention_sharded as j_ring
from dstack_tpu.ops.ulysses import ulysses_attention_sharded as j_ulysses
from dstack_tpu.parallel import mesh as j_mesh
from dstack_tpu.parallel.pipeline import pipeline_layers as j_pipeline
from dstack_tpu_torch.models import checkpoint as ckpt
from dstack_tpu_torch.models import llama, train
from dstack_tpu_torch.models.data import rank_tokens
from dstack_tpu_torch.ops.ring_attention import ring_attention_sharded
from dstack_tpu_torch.ops.ulysses import ulysses_attention_sharded
from dstack_tpu_torch.parallel import distributed as dist_lib
from dstack_tpu_torch.parallel import mesh as mesh_lib
from dstack_tpu_torch.parallel.pipeline import pipeline_layers
from tests.test_torch_parallel import _free_ports

CFG = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
           num_layers=4, num_heads=8, num_kv_heads=4, head_dim=16,
           max_seq_len=256)
SEQ, BATCH, STEPS, LR = 128, 4, 3, 3e-4
LOSS_RTOL = 1e-5
PARAM_ATOL = 2 * LR * STEPS
CLOSE_ATOL, CLOSE_SHARE = 1e-6, 0.999
ATTN_ATOL = 2e-6
PIPE_ATOL = {"y": 1e-6, "dws": 1e-5, "dx": 1e-5}
LLAMA_ATOL = 1e-5
WORLD = 4
#: attention cases: (mesh sizes), each with both schemes
ATTN_MESHES = {"seq4": dict(seq=4), "seq2_tensor2": dict(seq=2, tensor=2)}
ATTN_FNS = {"ring": (ring_attention_sharded, j_ring),
            "ulysses": (ulysses_attention_sharded, j_ulysses)}
#: the tanh pipeline: (layers, batch, seq, width), microbatch counts
TOY = (8, 8, 4, 8)
TOY_MICRO = (4, 8)
#: train runs: mesh sizes, policy, unstacked, remat (the port's and JAX's)
TRAIN = {
    "ring": (dict(seq=4), dict(seq_axis="seq"), True, False),
    "ulysses": (dict(seq=2, fsdp=2),
                dict(seq_axis="seq", seq_scheme="ulysses"), False,
                "selective"),
    "pipeline": (dict(stage=2, fsdp=2),
                 dict(stage_axis="stage", num_microbatches=2), False,
                 "selective"),
}
#: the pipelined Llama forward
FWD_MESH, FWD_POLICY = dict(stage=2, fsdp=2), dict(stage_axis="stage",
                                                   num_microbatches=2)


def _cfg():
    return llama.LlamaConfig(dtype=torch.float32, **CFG)


def _np(x):
    return x.detach().numpy().copy()


def _batches():
    rng = np.random.default_rng(7)
    return [rng.integers(0, CFG["vocab_size"], (BATCH, SEQ + 1)).astype(
        np.int32) for _ in range(STEPS)]


def _attn_inputs():
    rng = np.random.default_rng(3)
    hq, hkv, d = CFG["num_heads"], CFG["num_kv_heads"], CFG["head_dim"]
    return {n: rng.standard_normal((2, SEQ, h, d)).astype(np.float32)
            for n, h in (("q", hq), ("k", hkv), ("v", hkv), ("do", hq))}


def _toy_inputs():
    layers, batch, seq, width = TOY
    rng = np.random.default_rng(5)
    return {"ws": (rng.standard_normal((layers, width, width))
                   * 0.3).astype(np.float32),
            "x": rng.standard_normal((batch, seq, width)).astype(np.float32),
            "do": rng.standard_normal((batch, seq, width)).astype(
                np.float32)}


# -- the world ----------------------------------------------------------------


def _full(x):
    from torch.distributed.tensor import DTensor

    return _np(x.full_tensor() if isinstance(x, DTensor) else x)


def _full_leaves(state):
    """(path, whole numpy leaf) of a sharded state (a collective)."""
    return [(path, _full(x)) for path, x in ckpt.state_leaves(state)]


def _replicas_agree(leaves) -> bool:
    """Whether every rank assembled the same whole leaves: a replicated
    block (over seq, stage or data) must be equal on all its holders,
    whichever one a snapshot or ``full_tensor`` takes."""
    import torch.distributed as dist

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, [x for _, x in leaves])
    return all(np.array_equal(a, b) for other in every
               for a, b in zip(every[0], other))


def _join(world: int, port: int, rank: int):
    os.environ.update(DSTACK_MASTER_NODE_IP="127.0.0.1",
                      DSTACK_NODES_NUM="1", DSTACK_NODE_RANK="0",
                      DSTACK_GPUS_PER_NODE=str(world), LOCAL_RANK=str(rank),
                      DSTACK_COORDINATOR_PORT=str(port))
    os.environ.pop("DSTACK_GPUS_NUM", None)
    assert dist_lib.initialize(device="cpu")


def _attention(inputs, out):
    """Each scheme on DTensors made from plain local blocks (as the model
    calls them: a DTensor leaf's backward would run DTensor ops, whose
    sharding propagation over the seven axes takes minutes)."""
    spec = (llama.ShardingPolicy().batch_axes, "seq", "tensor", None)
    for mname, sizes in ATTN_MESHES.items():
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(**sizes), "cpu")

        def block(x):
            return mesh_lib.local_block(torch.from_numpy(x), spec,
                                        mesh).contiguous()

        def whole(local, x):
            return _full(mesh_lib.distribute(local, spec, mesh, x.shape))

        for fname, (fn, _) in ATTN_FNS.items():
            local = {n: block(inputs[n]).requires_grad_(True) for n in "qkv"}
            o = fn(mesh, *(mesh_lib.distribute(local[n], spec, mesh,
                                               inputs[n].shape)
                           for n in "qkv"))
            (o.to_local() * block(inputs["do"])).sum().backward()
            got = {"o": _full(o), "placed": tuple(
                o.placements) == mesh_lib.placements(spec, mesh)}
            for n in "qkv":
                got[f"d{n}"] = whole(local[n].grad, inputs[n])
            out[f"attn_{fname}_{mname}"] = got


def _toy_pipeline(inputs, out):
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(stage=WORLD), "cpu")
    for m in TOY_MICRO:
        ws = torch.from_numpy(inputs["ws"]).requires_grad_(True)
        x = torch.from_numpy(inputs["x"]).requires_grad_(True)
        y = pipeline_layers(lambda c, w: torch.tanh(c @ w), ws, x,
                            mesh=mesh, num_microbatches=m)
        (y * torch.from_numpy(inputs["do"])).sum().backward()
        # each stage's slice of the layers' gradient, whole on every rank
        dws = _sum_over_ranks(ws.grad)
        out[f"toy_m{m}"] = {"y": _np(y), "dws": _np(dws), "dx": _np(x.grad)}


def _sum_over_ranks(x):
    """``x`` summed over every rank (each stage holds its layers' rows of
    the stacked gradient, zeros elsewhere)."""
    import torch.distributed as dist

    x = x.clone()
    dist.all_reduce(x)
    return x


def _llama_forward(inputs, out):
    cfg = _cfg()
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(**FWD_MESH), "cpu")
    policy = llama.ShardingPolicy(**FWD_POLICY)
    params = llama.params_from_jax(inputs["init"][False], "cpu",
                                   torch.float32)
    state = train.state_from_params(params, cfg, train.default_optimizer(),
                                    mesh=mesh, policy=policy)
    tokens = rank_tokens(torch.from_numpy(inputs["fwd_tokens"]), mesh,
                         policy)
    with torch.no_grad():
        logits = llama.forward(state.params, tokens.long(), cfg, mesh=mesh,
                               policy=policy)
    parts = [torch.empty_like(logits) for _ in range(WORLD)]
    import torch.distributed as dist

    dist.all_gather(parts, logits)
    # ranks 0/1 (stage 0) and 2/3 (stage 1) hold fsdp rows 0 and 1
    out["llama_forward"] = {"stage_rows": [_np(p) for p in parts]}


def _train(inputs, out):
    import torch.distributed as dist

    cfg, opt = _cfg(), train.default_optimizer(lr=LR)
    for name, (sizes, pol, unstacked, remat) in TRAIN.items():
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(**sizes), "cpu")
        policy = llama.ShardingPolicy(**pol)
        params = llama.params_from_jax(inputs["init"][unstacked], "cpu",
                                       torch.float32)
        state = train.state_from_params(params, cfg, opt, mesh=mesh,
                                        policy=policy)
        step_fn = train.make_train_step(cfg, opt, mesh=mesh, policy=policy,
                                        remat=remat)
        losses, norms = [], []
        for b in inputs["batches"]:
            state, metrics = step_fn(state, {"tokens": rank_tokens(
                torch.from_numpy(b), mesh, policy)})
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
        leaves = _full_leaves(state)
        out[name] = {"losses": losses, "norms": norms, "leaves": leaves,
                     "replicas_agree": _replicas_agree(leaves)}
        if name == "pipeline":
            cp = ckpt.AsyncCheckpointer(inputs["port_dir"], every_steps=1)
            cp.save(state, STEPS, block=True)
            cp.close()
            dist.barrier()


def _four_ranks(rank, inputs, out):
    import torch.distributed as dist

    out["backend"] = dist.get_backend()
    _attention(inputs["attn"], out)
    _toy_pipeline(inputs["toy"], out)
    _llama_forward(inputs, out)
    _train(inputs, out)


def _two_ranks(rank, inputs, out):
    cfg = _cfg()
    spec = mesh_lib.shrink_spec(mesh_lib.MeshSpec(**TRAIN["pipeline"][0]), 2)
    mesh = mesh_lib.build_mesh(spec, "cpu")
    policy = llama.ShardingPolicy(**TRAIN["pipeline"][1])
    template = train.state_template(cfg, train.default_optimizer(),
                                    mesh=mesh, policy=policy)
    state, step = ckpt.read_snapshot(inputs["port_dir"], template,
                                     device="cpu")
    placed = llama.map_with_specs(
        lambda sp, p: tuple(p.placements) == mesh_lib.placements(sp, mesh),
        llama.specs_for(state.params, cfg, policy), state.params)
    out["shrunk"] = {"sizes": spec.sizes, "step": step,
                     "leaves": _full_leaves(state),
                     "placements_ok": all(llama.tree_leaves(placed))}


def _world_main(rank, ports, inputs, queue):
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = {}
    try:
        _join(WORLD, ports[0], rank)
        _four_ranks(rank, inputs, out)
        dist.destroy_process_group()
        if rank < 2:
            _join(2, ports[1], rank)
            _two_ranks(rank, inputs, out)
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the test process
        queue.put((rank, {"error": traceback.format_exc()}))
        return
    queue.put((rank, out if rank == 0 else {}))


# -- the JAX side and the world, once per module --------------------------------


def _jmesh(sizes):
    spec = j_mesh.MeshSpec(**sizes)
    return j_mesh.build_mesh(spec, jax.devices()[:spec.num_devices])


def _jax_attention(inputs):
    out = {}
    q, k, v, do = (jnp.asarray(inputs[n]) for n in ("q", "k", "v", "do"))
    for mname, sizes in ATTN_MESHES.items():
        jmesh = _jmesh(sizes)
        for fname, (_, jfn) in ATTN_FNS.items():
            o, vjp = jax.vjp(jax.jit(lambda q, k, v: jfn(jmesh, q, k, v)),
                             q, k, v)
            dq, dk, dv = vjp(do)
            out[f"attn_{fname}_{mname}"] = {
                n: np.asarray(x) for n, x in (("o", o), ("dq", dq),
                                              ("dk", dk), ("dv", dv))}
    return out


def _jax_toy(inputs):
    out = {}
    jmesh = _jmesh(dict(stage=WORLD))
    ws = jax.device_put(jnp.asarray(inputs["ws"]),
                        NamedSharding(jmesh, P("stage")))
    x, do = jnp.asarray(inputs["x"]), jnp.asarray(inputs["do"])

    def layer_fn(c, w):
        return jnp.tanh(c @ w), None

    for m in TOY_MICRO:
        y, vjp = jax.vjp(jax.jit(lambda ws, x: j_pipeline(
            layer_fn, ws, x, mesh=jmesh, num_microbatches=m)), ws, x)
        dws, dx = vjp(do)
        out[f"toy_m{m}"] = {"y": np.asarray(y), "dws": np.asarray(dws),
                            "dx": np.asarray(dx)}
    return out


def _place(jmesh, tree, specs):
    return jax.tree.map(lambda w, sp: jax.device_put(
        jnp.asarray(w), NamedSharding(jmesh, sp)), tree, specs,
        is_leaf=lambda v: isinstance(v, P))


def _jax_forward(jcfg, init, tokens):
    jmesh = _jmesh(FWD_MESH)
    policy = j_llama.ShardingPolicy(**FWD_POLICY)
    params = jax.tree.map(
        lambda w, sp: jax.device_put(jnp.asarray(w),
                                     NamedSharding(jmesh, sp)),
        init, j_llama.param_specs(jcfg, policy),
        is_leaf=lambda v: not isinstance(v, dict))
    return np.asarray(jax.jit(lambda p, t: j_llama.forward(
        p, t, jcfg, mesh=jmesh, policy=policy))(params, jnp.asarray(tokens)))


def _jax_train(jcfg, init, batches, sizes, pol, remat):
    jmesh = _jmesh(sizes)
    policy = j_llama.ShardingPolicy(**pol)
    opt = j_train.default_optimizer(lr=LR)
    params = jax.tree.map(jnp.asarray, init)
    state = j_train.TrainState(params=params, opt_state=opt.init(params),
                               step=jnp.zeros((), jnp.int32))
    specs = j_train.state_specs(jcfg, opt, policy)
    state = jax.device_put(state, jax.tree.map(
        lambda s: NamedSharding(jmesh, s), specs,
        is_leaf=lambda x: isinstance(x, P)))
    step_fn = j_train.make_train_step(jcfg, opt, mesh=jmesh, policy=policy,
                                      remat=remat)
    losses, norms = [], []
    for b in batches:
        state, metrics = step_fn(state, {"tokens": jnp.asarray(b)})
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return {"losses": losses, "norms": norms, "state": state}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("context")
    jcfg = j_llama.LlamaConfig(dtype=jnp.float32, **CFG)
    init = jax.tree.map(np.asarray, j_llama.init_params(
        jax.random.PRNGKey(0), jcfg))
    batches = _batches()
    fwd_tokens = np.random.default_rng(9).integers(
        0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    attn, toy = _attn_inputs(), _toy_inputs()
    want = {**_jax_attention(attn), **_jax_toy(toy),
            "llama_forward": _jax_forward(jcfg, init, fwd_tokens)}
    for name, (sizes, pol, _, remat) in TRAIN.items():
        want[name] = _jax_train(jcfg, init, batches, sizes, pol,
                                remat is not False)

    inputs = {"init": {False: init, True: jax.tree.map(
        np.asarray, j_llama.unstack_params(init))}, "batches": batches,
        "fwd_tokens": fwd_tokens, "attn": attn, "toy": toy,
        "port_dir": str(tmp / "port_snapshot")}
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    ports = _free_ports(2)
    procs = [ctx.Process(target=_world_main, args=(r, ports, inputs, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        # a timeout, not a hang: a rank that issues its collectives in
        # another order than its peers deadlocks here
        results = dict(queue.get(timeout=300) for _ in range(WORLD))
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    errors = [r["error"] for r in results.values() if "error" in r]
    assert not errors, "\n".join(errors)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return {"jax": want, "port": results[0], "inputs": inputs, "jcfg": jcfg}


def _assert_close(got, want):
    assert [g.shape for g in got] == [w.shape for w in want]
    diff = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    assert diff.max() <= PARAM_ATOL, diff.max()
    assert np.mean(diff <= CLOSE_ATOL) >= CLOSE_SHARE, np.mean(
        diff <= CLOSE_ATOL)


@pytest.mark.parametrize("scheme", list(ATTN_FNS))
@pytest.mark.parametrize("mesh", list(ATTN_MESHES))
def test_context_parallel_attention_matches_jax(world, scheme, mesh):
    """Ring and Ulysses attention over DTensors on the mesh: the output
    (placed as q) and dq, dk, dv against JAX's shard_map versions."""
    key = f"attn_{scheme}_{mesh}"
    got, want = world["port"][key], world["jax"][key]
    assert got["placed"]
    for name in ("o", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[name], want[name], atol=ATTN_ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("m", TOY_MICRO)
def test_pipeline_layers_match_jax(world, m):
    """The GPipe schedule on a tanh layer at stage=4: the output on every
    stage and the gradients of the stacked weights and of the input
    against JAX's pipeline_layers (whose gradients JAX's tests hold to
    the plain scan)."""
    got, want = world["port"][f"toy_m{m}"], world["jax"][f"toy_m{m}"]
    assert world["port"]["backend"] == "gloo"
    for name, atol in PIPE_ATOL.items():
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=0,
                                   err_msg=name)


def test_pipelined_llama_forward_matches_jax(world):
    """llama.forward at stage=2 x fsdp=2 (two microbatches, the fused
    attention's plain versions inside the schedule): every rank's rows of
    the f32 logits against JAX's pipelined forward; both stages return
    the same logits."""
    got = world["port"]["llama_forward"]["stage_rows"]
    want = world["jax"]["llama_forward"]
    rows = want.shape[0] // 2
    for rank, part in enumerate(got):
        fsdp = rank % 2
        np.testing.assert_allclose(part, want[fsdp * rows:(fsdp + 1) * rows],
                                   atol=LLAMA_ATOL, rtol=0)


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_steps_match_jax(world, name):
    """Three steps on four gloo ranks from one JAX init: the global loss
    and grad norm, and the parameters after them, against JAX's step on
    the same MeshSpec and policy; every rank holds the same state (the
    replicas of a weight over seq or stage got the same gradient)."""
    port, jax_run = world["port"][name], world["jax"][name]
    assert port["replicas_agree"]
    for key in ("losses", "norms"):
        np.testing.assert_allclose(port[key], jax_run[key], rtol=LOSS_RTOL)
    got = [x for path, x in port["leaves"] if path.startswith(".params")]
    jparams = jax_run["state"].params
    if TRAIN[name][2]:
        jparams = j_llama.unstack_params(jparams)
    _assert_close(got, [np.asarray(x) for x in jax.tree.leaves(jparams)])


def test_stage_sharded_snapshot_reads_in_jax_and_on_a_shrunk_mesh(world):
    """The pipelined state's snapshot (stacked layers sharded over stage,
    the rest over fsdp) by four ranks: JAX's read_snapshot gives every
    leaf bitwise; two ranks restore it onto shrink_spec's mesh (stage=2
    kept, fsdp=1), placed by param_specs, bitwise."""
    leaves = world["port"]["pipeline"]["leaves"]
    template = j_train.state_template(world["jcfg"],
                                      j_train.default_optimizer(lr=LR))
    jstate, step = j_ckpt.read_snapshot(world["inputs"]["port_dir"],
                                        template)
    assert step == STEPS
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate)
    assert [jax.tree_util.keystr(k) for k, _ in flat] == [p for p, _ in
                                                         leaves]
    for (kp, jleaf), (_, leaf) in zip(flat, leaves):
        jleaf = np.asarray(jleaf)
        assert jleaf.dtype == leaf.dtype and jleaf.tobytes() == \
            leaf.tobytes(), jax.tree_util.keystr(kp)
    shrunk = world["port"]["shrunk"]
    assert shrunk["sizes"]["stage"] == 2 and shrunk["sizes"]["fsdp"] == 1
    assert shrunk["step"] == STEPS and shrunk["placements_ok"]
    for (path, got), (_, want) in zip(shrunk["leaves"], leaves):
        assert got.tobytes() == want.tobytes(), path
