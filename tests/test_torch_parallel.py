"""The port's sharded training against the JAX package's, on the CPU.

One gloo world of four ranks is spawned once for the module (each rank a
process formed by ``parallel.distributed.initialize`` from the control
plane's variables, one CPU thread each); it runs every sharded part and
rank 0 hands the results back.  The JAX side runs once per module on the
conftest's 8 virtual CPU devices, its Pallas kernels in interpret mode.
The tiny config in f32 at 128 tokens, so that the fused attention route
(its plain versions on the CPU) runs under ``flash_attention_sharded``.

What runs in the world:
- three train steps on ``MeshSpec(fsdp=2, tensor=2)`` (unstacked, remat
  "selective") and ``MeshSpec(data=2, fsdp=2)`` (stacked, no remat) from
  one JAX init, each rank feeding its stripe of the global batch;
- ``create_state`` on a mesh against the unsharded one;
- ``flash_attention_sharded`` forward and backward;
- an ``AsyncCheckpointer`` snapshot of the first run's state by four ranks;
- a run killed after step 5 (snapshots every 2 steps) and an
  uninterrupted one on ``MeshSpec.auto(4)``; then two of the ranks form a
  new world of two, resume the killed run on ``shrink_spec(spec, 2)``, and
  read a JAX snapshot of sharded state.

Tolerances (f32):
- ``LOSS_RTOL`` 1e-5 relative on losses and grad norms: the collectives
  and the sharded matmuls sum in another order (1.6e-7 seen);
- ``PARAM_ATOL`` 2 * lr * steps on parameters, all but a few elements
  within 1e-6 (as in ``test_torch_train.py``: Adam moves an element whose
  gradient is rounding noise by up to lr a step either way);
- ``FLASH_ATOL`` 2e-6: the plain versions against JAX's kernels at
  head_dim 16 (``test_torch_flash.py``);
- snapshots bitwise.
"""

import multiprocessing
import os
import socket
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
from dstack_tpu.ops import flash_attention as j_flash
from dstack_tpu.parallel import mesh as j_mesh
from dstack_tpu_torch.models import checkpoint as ckpt
from dstack_tpu_torch.models import llama, train
from dstack_tpu_torch.ops import flash_attention as fa
from dstack_tpu_torch.parallel import distributed as dist_lib
from dstack_tpu_torch.parallel import mesh as mesh_lib

CFG = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
           num_layers=2, num_heads=8, num_kv_heads=4, head_dim=16,
           max_seq_len=256)
SEQ, BATCH, STEPS, LR = 128, 4, 3, 3e-4
LOSS_RTOL = 1e-5
PARAM_ATOL = 2 * LR * STEPS
CLOSE_ATOL, CLOSE_SHARE = 1e-6, 0.999
FLASH_ATOL = 2e-6
WORLD = 4
#: the two sharded train runs: (mesh sizes, unstacked, the port's remat)
SPECS = {"fsdp2_tensor2": (dict(fsdp=2, tensor=2), True, "selective"),
         "data2_fsdp2": (dict(data=2, fsdp=2), False, False)}
#: the killed run: snapshots every 2 steps, killed after step 5
KILL_STEPS, KILL_AFTER, KILL_EVERY, KILL_SEED = 6, 5, 2, 11


class SimulatedHostLoss(Exception):
    pass


def _free_ports(n: int) -> tuple:
    """``n`` distinct free ports (all bound at once while chosen)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return tuple(s.getsockname()[1] for s in socks)
    finally:
        for s in socks:
            s.close()


def _batches():
    rng = np.random.default_rng(7)
    return [rng.integers(0, CFG["vocab_size"], (BATCH, SEQ + 1)).astype(
        np.int32) for _ in range(STEPS)]


def _kill_batch(step):
    rng = np.random.default_rng(100 + step)
    return rng.integers(0, CFG["vocab_size"], (BATCH, SEQ + 1)).astype(
        np.int32)


def _cfg():
    return llama.LlamaConfig(dtype=torch.float32, **CFG)


def _np(x):
    return x.detach().numpy().copy()


# -- the world ----------------------------------------------------------------


def _stripe(mesh, rows):
    index, count = mesh_lib.batch_stripe(
        mesh_lib.mesh_sizes(mesh), mesh_lib.mesh_coordinate(mesh),
        llama.ShardingPolicy().batch_axes)
    n = rows.shape[0] // count
    return torch.from_numpy(rows[index * n:(index + 1) * n])


def _full_leaves(state):
    """(path, whole numpy leaf) of a sharded state (a collective)."""
    from torch.distributed.tensor import DTensor

    return [(path, _np(x.full_tensor() if isinstance(x, DTensor) else x))
            for path, x in ckpt.state_leaves(state)]


def _join(world: int, port: int, rank: int):
    os.environ.update(DSTACK_MASTER_NODE_IP="127.0.0.1",
                      DSTACK_NODES_NUM="1", DSTACK_NODE_RANK="0",
                      DSTACK_GPUS_PER_NODE=str(world), LOCAL_RANK=str(rank),
                      DSTACK_COORDINATOR_PORT=str(port))
    os.environ.pop("DSTACK_GPUS_NUM", None)
    assert dist_lib.initialize(device="cpu")


def _four_ranks(rank, inputs, out):
    import torch.distributed as dist

    cfg, opt = _cfg(), train.default_optimizer(lr=LR)
    out["backend"] = dist.get_backend()
    # create_state: each rank's blocks of the unsharded draw
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(fsdp=2, tensor=2), "cpu")
    sharded = train.create_state(5, cfg, opt, mesh=mesh, unstacked=True,
                                 device="cpu")
    whole = train.create_state(5, cfg, opt, unstacked=True, device="cpu")
    specs = llama.specs_for(whole.params, cfg)
    same = llama.map_with_specs(
        lambda sp, s, w: torch.equal(mesh_lib.local_tensor(s),
                                     mesh_lib.local_block(w.detach(), sp,
                                                          mesh)),
        specs, sharded.params, whole.params)
    bad = torch.tensor(float(not all(llama.tree_leaves(same))))
    dist.all_reduce(bad)
    out["create_state_mismatched_ranks"] = int(bad)
    del sharded, whole

    for name, (sizes, unstacked, remat) in SPECS.items():
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(**sizes), "cpu")
        params = llama.params_from_jax(inputs["init"][unstacked], "cpu",
                                       torch.float32)
        state = train.state_from_params(params, cfg, opt, mesh=mesh)
        step_fn = train.make_train_step(cfg, opt, mesh=mesh, remat=remat)
        losses, norms = [], []
        for b in inputs["batches"]:
            state, metrics = step_fn(state, {"tokens": _stripe(mesh, b)})
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
        out[name] = {"losses": losses, "norms": norms,
                     "leaves": _full_leaves(state)}
        if name == "fsdp2_tensor2":
            cp = ckpt.AsyncCheckpointer(inputs["port_dir"], every_steps=1)
            cp.save(state, STEPS, block=True)
            cp.close()
            dist.barrier()

    # flash_attention_sharded on the first mesh's layout
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(fsdp=2, tensor=2), "cpu")
    spec = (llama.ShardingPolicy().batch_axes, None, "tensor", None)

    def dt(x):
        local = mesh_lib.local_block(torch.from_numpy(x), spec,
                                     mesh).contiguous()
        return mesh_lib.distribute(local, spec, mesh,
                                   x.shape).requires_grad_(True)

    q, k, v = (dt(inputs["flash"][n]) for n in "qkv")
    o = fa.flash_attention_sharded(mesh, q, k, v)
    do = mesh_lib.local_block(torch.from_numpy(inputs["flash"]["do"]),
                              spec, mesh)
    (o.to_local() * do).sum().backward()
    out["flash"] = {n: _np(x.full_tensor()) for n, x in
                    (("o", o), ("dq", q.grad), ("dk", k.grad),
                     ("dv", v.grad))}
    out["flash_placements"] = tuple(o.placements) == mesh_lib.placements(
        spec, mesh)

    # a run killed after step 5, and the uninterrupted run
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec.auto(WORLD), "cpu")

    def kill(step, metrics):
        if step == KILL_AFTER:
            raise SimulatedHostLoss(f"host lost at step {step}")

    def batch_fn(step):
        return {"tokens": _stripe(mesh, _kill_batch(step))}

    try:
        train.run_train_loop(cfg, opt, batch_fn, steps=KILL_STEPS,
                             generator=KILL_SEED, device="cpu", mesh=mesh,
                             unstacked=True, remat=False,
                             checkpoint_dir=inputs["kill_dir"],
                             checkpoint_every=KILL_EVERY, on_step=kill)
        out["killed"] = False
    except SimulatedHostLoss:
        out["killed"] = True
    dist.barrier()
    out["published_after_kill"] = ckpt.latest_snapshot_step(
        inputs["kill_dir"])
    baseline = train.run_train_loop(cfg, opt, batch_fn, steps=KILL_STEPS,
                                    generator=KILL_SEED, device="cpu",
                                    mesh=mesh, unstacked=True, remat=False)
    out["baseline_losses"] = baseline.losses


def _two_ranks(rank, inputs, out):
    cfg, opt = _cfg(), train.default_optimizer(lr=LR)
    spec = mesh_lib.shrink_spec(mesh_lib.MeshSpec.auto(WORLD), 2)
    mesh = mesh_lib.build_mesh(spec, "cpu")
    out["shrunk"] = spec.sizes

    def batch_fn(step):
        return {"tokens": _stripe(mesh, _kill_batch(step))}

    res = train.run_train_loop(cfg, opt, batch_fn, steps=KILL_STEPS,
                               generator=KILL_SEED, device="cpu", mesh=mesh,
                               unstacked=True, remat=False,
                               checkpoint_dir=inputs["kill_dir"],
                               checkpoint_every=KILL_EVERY)
    out["resumed"] = {"from": res.resumed_from, "step": res.step,
                      "state_step": res.state.step, "losses": res.losses}
    # a JAX snapshot of sharded (stacked) state onto this mesh
    template = train.state_template(cfg, train.default_optimizer(),
                                    mesh=mesh)
    state, step = ckpt.read_snapshot(inputs["jax_dir"], template,
                                     device="cpu")
    placed = llama.map_with_specs(
        lambda sp, p: tuple(p.placements) == mesh_lib.placements(sp, mesh),
        llama.specs_for(state.params, cfg), state.params)
    out["jax_read"] = {"step": step, "leaves": _full_leaves(state),
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


def _jax_sharded_run(jcfg, init, batches, sizes):
    spec = j_mesh.MeshSpec(**sizes)
    jmesh = j_mesh.build_mesh(spec, jax.devices()[:spec.num_devices])
    opt = j_train.default_optimizer(lr=LR)
    params = jax.tree.map(jnp.asarray, init)
    state = j_train.TrainState(params=params, opt_state=opt.init(params),
                               step=jnp.zeros((), jnp.int32))
    specs = j_train.state_specs(jcfg, opt)
    state = jax.device_put(state, jax.tree.map(
        lambda s: NamedSharding(jmesh, s), specs,
        is_leaf=lambda x: isinstance(x, P)))
    step_fn = j_train.make_train_step(jcfg, opt, mesh=jmesh, remat=False)
    losses, norms = [], []
    for b in batches:
        state, metrics = step_fn(state, {"tokens": jnp.asarray(b)})
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return {"losses": losses, "norms": norms, "state": state}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    jcfg = j_llama.LlamaConfig(dtype=jnp.float32, **CFG)
    init = jax.tree.map(np.asarray, j_llama.init_params(
        jax.random.PRNGKey(0), jcfg))
    batches = _batches()
    jax_runs = {name: _jax_sharded_run(jcfg, init, batches, sizes)
                for name, (sizes, _, _) in SPECS.items()}
    # a JAX snapshot of the first run's sharded state
    jax_dir = tmp / "jax_snapshot"
    j_ckpt.write_snapshot(
        jax_dir, j_ckpt.snapshot_train_state(jax_runs["fsdp2_tensor2"][
            "state"]), STEPS, process_index=0, num_processes=1)
    # JAX's flash_attention_sharded on the same layout
    rng = np.random.default_rng(3)
    hq, hkv, d = CFG["num_heads"], CFG["num_kv_heads"], CFG["head_dim"]
    flash_in = {n: rng.standard_normal((BATCH, SEQ, h, d)).astype(np.float32)
                for n, h in (("q", hq), ("k", hkv), ("v", hkv), ("do", hq))}
    jmesh = j_mesh.build_mesh(j_mesh.MeshSpec(fsdp=2, tensor=2),
                              jax.devices()[:4])
    o, vjp = jax.vjp(lambda q, k, v: j_flash.flash_attention_sharded(
        jmesh, q, k, v), *(jnp.asarray(flash_in[n]) for n in "qkv"))
    dq, dk, dv = vjp(jnp.asarray(flash_in["do"]))
    jax_flash = {n: np.asarray(x) for n, x in
                 (("o", o), ("dq", dq), ("dk", dk), ("dv", dv))}

    # the port's unsharded steps from the same init, in each layout
    inits = {False: init, True: jax.tree.map(
        np.asarray, j_llama.unstack_params(init))}
    unsharded = {}
    for unstacked, tree in inits.items():
        cfg, opt = _cfg(), train.default_optimizer(lr=LR)
        state = train.state_from_params(
            llama.params_from_jax(tree, "cpu", torch.float32), cfg, opt)
        step_fn = train.make_train_step(cfg, opt, remat=False)
        run = unsharded[unstacked] = {"losses": [], "norms": []}
        for b in batches:
            state, metrics = step_fn(state, {"tokens": torch.from_numpy(b)})
            run["losses"].append(metrics["loss"].item())
            run["norms"].append(metrics["grad_norm"].item())
        run["params"] = [_np(x) for path, x in ckpt.state_leaves(state)
                         if path.startswith(".params")]

    inputs = {"init": inits, "batches": batches, "flash": flash_in,
              "jax_dir": str(jax_dir), "port_dir": str(tmp / "port_snapshot"),
              "kill_dir": str(tmp / "killed")}
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    ports = _free_ports(2)
    procs = [ctx.Process(target=_world_main, args=(r, ports, inputs, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
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
    return {"jax": jax_runs, "jax_flash": jax_flash, "unsharded": unsharded,
            "port": results[0], "inputs": inputs, "jcfg": jcfg}


def _assert_close(got, want):
    assert [g.shape for g in got] == [w.shape for w in want]
    diff = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    assert diff.max() <= PARAM_ATOL, diff.max()
    assert np.mean(diff <= CLOSE_ATOL) >= CLOSE_SHARE, np.mean(
        diff <= CLOSE_ATOL)


@pytest.mark.parametrize("name", list(SPECS))
def test_sharded_train_steps_match_jax_and_unsharded(world, name):
    """Three steps on 4 gloo ranks: the global loss and grad norm against
    JAX's sharded step on the same MeshSpec and the port's unsharded
    step; the parameters against both."""
    port, jax_run = world["port"][name], world["jax"][name]
    unstacked = SPECS[name][1]
    unsharded = world["unsharded"][unstacked]
    assert world["port"]["backend"] == "gloo"
    for key in ("losses", "norms"):
        np.testing.assert_allclose(port[key], jax_run[key], rtol=LOSS_RTOL)
        np.testing.assert_allclose(port[key], unsharded[key], rtol=LOSS_RTOL)
    # snapshot order is JAX's flatten order (dict keys sorted)
    got = [x for path, x in port["leaves"] if path.startswith(".params")]
    jparams = jax_run["state"].params
    if unstacked:
        jparams = j_llama.unstack_params(jparams)
    _assert_close(got, [np.asarray(x) for x in jax.tree.leaves(jparams)])
    _assert_close(got, unsharded["params"])


def test_create_state_holds_each_rank_slice_of_the_unsharded_init(world):
    """Every rank's blocks equal, bitwise, its blocks of the unsharded
    create_state from the same seed."""
    assert world["port"]["create_state_mismatched_ranks"] == 0


def test_flash_attention_sharded_matches_jax(world):
    got, want = world["port"]["flash"], world["jax_flash"]
    assert world["port"]["flash_placements"]
    for name in ("o", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[name], want[name], atol=FLASH_ATOL,
                                   rtol=0, err_msg=name)


def test_four_rank_port_snapshot_reads_in_jax(world):
    """Four host files, each block written once (by its owner), read by
    JAX's read_snapshot against an unstacked JAX template: every leaf's
    bytes equal the port's state."""
    step_dir = os.path.join(world["inputs"]["port_dir"], f"step_{STEPS:08d}")
    files = sorted(f for f in os.listdir(step_dir) if f.startswith("host_"))
    assert files == [f"host_{r:05d}.npz" for r in range(WORLD)]
    leaves = world["port"]["fsdp2_tensor2"]["leaves"]
    written = 0
    for f in files:
        with np.load(os.path.join(step_dir, f)) as z:
            written += sum(z[k].nbytes for k in z.files if k != "__index__")
    assert written == sum(x.nbytes for _, x in leaves)
    template = j_train.state_template(
        world["jcfg"], j_train.default_optimizer(lr=LR), unstacked=True)
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


def test_jax_snapshot_of_sharded_state_reads_onto_two_port_ranks(world):
    """JAX's state, sharded over fsdp=2 x tensor=2 devices, read onto the
    port's shrunk mesh of two ranks: placed as param_specs there, and
    every leaf's bytes equal."""
    got = world["port"]["jax_read"]
    assert got["step"] == STEPS and got["placements_ok"]
    flat, _ = jax.tree_util.tree_flatten_with_path(
        world["jax"]["fsdp2_tensor2"]["state"])
    assert [jax.tree_util.keystr(k) for k, _ in flat] == [
        p for p, _ in got["leaves"]]
    for (kp, jleaf), (_, leaf) in zip(flat, got["leaves"]):
        assert np.asarray(jleaf).tobytes() == leaf.tobytes(), \
            jax.tree_util.keystr(kp)


def test_kill_mid_run_resumes_on_shrunk_mesh(world):
    """The JAX chaos story on the port: a 4-rank FSDP run dies after step
    5 with step 4 published; two survivors re-mesh with shrink_spec, resume
    from step 4 and take steps 5-6 with the uninterrupted run's losses."""
    port = world["port"]
    assert port["killed"] and port["published_after_kill"] == 4
    assert port["shrunk"] == mesh_lib.shrink_spec(
        mesh_lib.MeshSpec.auto(WORLD), 2).sizes
    resumed = port["resumed"]
    assert resumed["from"] == 4 and resumed["step"] == KILL_STEPS
    assert resumed["state_step"] == KILL_STEPS
    np.testing.assert_allclose(resumed["losses"],
                               port["baseline_losses"][4:], rtol=LOSS_RTOL)
