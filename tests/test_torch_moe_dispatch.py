"""The port's MoE training with ``expert`` among the batch axes (the tokens
travel to the experts' ranks) and under ``seq`` and ``stage`` (replicas),
against the JAX package's, on the CPU.

One gloo world of four ranks is spawned once for the module, as in
``test_torch_moe_parallel.py``; each rank hands its results back.  The
JAX side is its unsharded jitted step on the whole batch (what its
sharded step computes: under ``jit`` the reference routes the global
batch), and for the first run also its own sharded step on 4 of the
suite's 8 virtual devices.  ``tiny_moe`` in f32 at 128 tokens a row,
four rows, capacity factor 0.75: tokens ARE dropped (asserted), so the
capacity slots must be taken in the global order for the losses to
agree.

The runs, three steps each (mesh, policy, unstacked, the port's remat):
1. ``data=2 x expert=2``, batch over (data, expert), stacked, no remat;
2. ``expert=2 x tensor=2``, batch over (data, fsdp, expert), remat;
3. ``fsdp=2 x expert=2``, batch over (fsdp, expert), unstacked, remat;
4. ``seq=2 x expert=2`` with ``seq_axis="seq"``: seq ranks are replicas;
5. ``stage=2 x data=2`` with ``stage_axis="stage"``, unstacked: stage
   ranks are replicas, and the layers need not be stacked.

Tolerances (f32):
- ``LOSS_RTOL`` 1e-5 relative on the cross entropy, the aux loss and the
  grad norm: the collectives and the sharded products sum in another
  order;
- ``PARAM_ATOL`` 2 * lr * steps on parameters, all but 0.1% of the
  elements within 1e-6 (Adam moves an element whose gradient is rounding
  noise by up to lr a step either way);
- ``GRAD_RTOL``: a rank's expert gradients of the first step within 1e-4
  of the largest magnitude of JAX's gradient of that leaf.
"""

import dataclasses
import multiprocessing
import os
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dstack_tpu.models import llama as j_llama
from dstack_tpu.models import moe as j_moe
from dstack_tpu.models import train as j_train
from dstack_tpu.ops.loss import chunked_cross_entropy as j_chunked_ce
from dstack_tpu.parallel import mesh as j_mesh
from dstack_tpu_torch.models import llama, moe, train
from dstack_tpu_torch.models.data import rank_tokens
from dstack_tpu_torch.parallel import distributed as dist_lib
from dstack_tpu_torch.parallel import mesh as mesh_lib
from tests.test_torch_moe_parallel import (_KeptCount, _free_port,
                                          _sharded_state)

SEQ, BATCH, STEPS, LR = 128, 4, 3, 3e-4
CAPACITY_FACTOR = 0.75
LOSS_RTOL = 1e-5
PARAM_ATOL = 2 * LR * STEPS
CLOSE_ATOL, CLOSE_SHARE = 1e-6, 0.999
GRAD_RTOL = 1e-4
WORLD = 4
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")
#: (mesh sizes, policy, unstacked, the port's remat)
RUNS = {
    "data2_expert2": (dict(data=2, expert=2),
                      dict(batch_axes=("data", "expert")), False, False),
    "expert2_tensor2": (dict(expert=2, tensor=2),
                        dict(batch_axes=("data", "fsdp", "expert")), False,
                        True),
    "fsdp2_expert2": (dict(fsdp=2, expert=2),
                      dict(batch_axes=("fsdp", "expert")), True, True),
    "seq2_expert2": (dict(seq=2, expert=2), dict(seq_axis="seq"), False,
                     True),
    "stage2_data2": (dict(stage=2, data=2), dict(stage_axis="stage"), True,
                     False),
}
#: the run whose placement and gradients are checked leaf by leaf
PLACED = "data2_expert2"


def _cfg():
    return moe.MoEConfig.tiny_moe(dtype=torch.float32,
                                  capacity_factor=CAPACITY_FACTOR)


def _np(x):
    return x.detach().numpy().copy()


@dataclasses.dataclass(frozen=True)
class _Recording(train.AdamW):
    """AdamW that keeps a copy of each step's gradients (before clipping,
    in tree_leaves order) in ``seen``."""

    seen: list = dataclasses.field(default_factory=list)

    def update(self, params, grads, opt_state):
        grads = list(grads)
        self.seen.append([g.detach().clone() for g in grads])
        return super().update(params, grads, opt_state)


def _whole_params(state, unstacked):
    """The whole (stacked) numpy parameter tree of a sharded state (a
    collective)."""
    full = llama.tree_map(lambda p: p.full_tensor().detach(), state.params)
    if unstacked:
        full = llama.stack_params(full)
    return llama.tree_map(_np, full)


def _placement(state, mesh, first):
    """This rank's expert leaves' shapes, its expert gradients of the
    first step (``first``), and whether its other gradients equal those
    of the other rank of its ``expert`` group (bitwise)."""
    import torch.distributed as dist

    seen = iter(first)
    grads = llama.tree_map(lambda _: next(seen), state.params)
    layers = grads["layers"]
    others = [g for k, g in layers.items() if k not in EXPERT_LEAVES] + [
        g for k, g in grads.items() if k != "layers"]
    flat = torch.cat([g.reshape(-1) for g in others])
    both = [torch.empty_like(flat) for _ in range(2)]
    dist.all_gather(both, flat, group=mesh.get_group("expert"))
    return {"coord": mesh_lib.mesh_coordinate(mesh),
            "shapes": {k: tuple(mesh_lib.local_tensor(
                state.params["layers"][k]).shape) for k in EXPERT_LEAVES},
            "expert_grads": {k: _np(layers[k]) for k in EXPERT_LEAVES},
            "others_equal": bool(torch.equal(both[0], both[1])),
            "others_nonzero": bool(flat.abs().max() > 0)}


def _world_main(rank, port, inputs, queue):
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = {}
    try:
        os.environ.update(DSTACK_MASTER_NODE_IP="127.0.0.1",
                          DSTACK_NODES_NUM="1", DSTACK_NODE_RANK="0",
                          DSTACK_GPUS_PER_NODE=str(WORLD),
                          LOCAL_RANK=str(rank),
                          DSTACK_COORDINATOR_PORT=str(port))
        os.environ.pop("DSTACK_GPUS_NUM", None)
        assert dist_lib.initialize(device="cpu")
        cfg = _cfg()
        for name, (sizes, pol, unstacked, remat) in RUNS.items():
            mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(**sizes), "cpu")
            policy = llama.ShardingPolicy(**pol)
            opt = _Recording(lr=LR)
            tree = inputs["init"][unstacked]
            state = _sharded_state(tree, cfg, opt, mesh, policy)
            step_fn = moe.make_train_step(cfg, opt, mesh=mesh, policy=policy,
                                          remat=remat)
            run = {"losses": [], "auxes": [], "norms": []}
            for i, b in enumerate(inputs["batches"]):
                tokens = rank_tokens(torch.from_numpy(b), mesh,
                                     moe.token_policy(policy))
                with _KeptCount() as kept:
                    state, metrics = step_fn(state, {"tokens": tokens})
                if i == 0:
                    run["tokens_shape"] = tuple(tokens.shape)
                    counts = torch.tensor(kept.counts)
                    dist.all_reduce(counts)
                    run["kept"] = counts.tolist()
                    if name == PLACED:
                        run["placement"] = _placement(state, mesh, opt.seen[0])
                run["losses"].append(metrics["loss"].item())
                run["auxes"].append(metrics["aux_loss"].item())
                run["norms"].append(metrics["grad_norm"].item())
            run["params"] = _whole_params(state, unstacked)
            if rank and name != PLACED:
                run = {}
            elif rank:
                run = {"placement": run["placement"]}
            out[name] = run
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the test process
        queue.put((rank, {"error": traceback.format_exc()}))
        return
    queue.put((rank, out))


def _jax_runs(jcfg, batches):
    """JAX's unsharded jitted steps on the whole batch (losses, aux
    losses, grad norms, the first step's gradients, the parameters after
    the steps) and its sharded steps on ``RUNS[PLACED]``'s mesh."""
    def loss(p, batch):
        x, a = j_moe.backbone(p, batch[:, :-1], jcfg, remat=True)
        return (j_chunked_ce(x, j_moe.llama.output_head(p, jcfg),
                             batch[:, 1:]) + jcfg.router_aux_weight * a)

    grad_fn = jax.jit(jax.grad(loss))
    opt = j_train.default_optimizer(lr=LR)
    state = j_moe.create_state(jax.random.PRNGKey(0), jcfg, opt)
    step_fn = j_moe.make_train_step(jcfg, opt)
    ref = {"losses": [], "auxes": [], "norms": []}
    for i, b in enumerate(batches):
        grads = grad_fn(state.params, jnp.asarray(b))
        if i == 0:
            ref["grads"] = jax.tree.map(np.asarray, grads)
        ref["norms"].append(float(optax.global_norm(grads)))
        state, metrics = step_fn(state, {"tokens": jnp.asarray(b)})
        ref["losses"].append(float(metrics["loss"]))
        ref["auxes"].append(float(metrics["aux_loss"]))
    ref["final"] = jax.tree.map(np.asarray, state.params)

    sizes, pol, _, _ = RUNS[PLACED]
    spec = j_mesh.MeshSpec(**sizes)
    jmesh = j_mesh.build_mesh(spec, jax.devices()[:spec.num_devices])
    policy = j_llama.ShardingPolicy(**pol)
    state = j_moe.create_state(jax.random.PRNGKey(0), jcfg, opt, mesh=jmesh,
                               policy=policy)
    step_fn = j_moe.make_train_step(jcfg, opt, mesh=jmesh, policy=policy,
                                    remat=False)
    sharded = {"losses": [], "auxes": []}
    for b in batches:
        tokens = jax.device_put(jnp.asarray(b), NamedSharding(
            jmesh, P(policy.batch_axes, None)))
        state, metrics = step_fn(state, {"tokens": tokens})
        sharded["losses"].append(float(metrics["loss"]))
        sharded["auxes"].append(float(metrics["aux_loss"]))
    sharded["final"] = jax.tree.map(np.asarray, state.params)
    return ref, sharded


@pytest.fixture(scope="module")
def world():
    jcfg = j_moe.MoEConfig.tiny_moe(dtype=jnp.float32,
                                   capacity_factor=CAPACITY_FACTOR)
    init = jax.tree.map(np.asarray,
                        j_moe.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, jcfg.vocab_size, (BATCH, SEQ + 1)).astype(
        np.int32) for _ in range(STEPS)]
    ref, sharded = _jax_runs(jcfg, batches)

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    inputs = {"init": {False: init, True: jax.tree.map(
        np.asarray, j_moe.llama.unstack_params(init))}, "batches": batches}
    port = _free_port()
    procs = [ctx.Process(target=_world_main, args=(r, port, inputs, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=400) for _ in range(WORLD))
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    errors = [r["error"] for r in results.values() if "error" in r]
    assert not errors, "\n".join(errors)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return {"jax": ref, "jax_sharded": sharded, "port": results[0],
            "placement": [results[r][PLACED]["placement"]
                          for r in range(WORLD)]}


def _assert_params_close(got, want, label):
    got, want = llama.tree_leaves(got), llama.tree_leaves(want)
    assert [g.shape for g in got] == [w.shape for w in want], label
    diff = np.concatenate([np.abs(g - w).ravel()
                           for g, w in zip(got, want)])
    assert diff.max() <= PARAM_ATOL, (label, diff.max())
    assert np.mean(diff <= CLOSE_ATOL) >= CLOSE_SHARE, (
        label, np.mean(diff <= CLOSE_ATOL))


@pytest.mark.parametrize("name", list(RUNS))
def test_moe_dispatch_steps_match_jax(world, name):
    """Three steps on 4 gloo ranks with tokens dropped by capacity: the
    global cross entropy, aux loss and grad norm against JAX's step on the
    whole batch (``LOSS_RTOL``), and the parameters after the steps
    (``PARAM_ATOL``); the first run also against JAX's own sharded step
    on the same mesh and policy.  Every rank fed its rows of the batch
    with whole sequences (``moe.token_policy``)."""
    got = world["port"][name]
    sizes, pol, _, _ = RUNS[name]
    stripes = np.prod([sizes.get(a, 1) for a in llama.ShardingPolicy(
        **pol).batch_axes])
    assert got["tokens_shape"] == (BATCH // stripes, SEQ + 1)
    wants = [("jax", world["jax"])]
    if name == PLACED:
        wants.append(("jax sharded", world["jax_sharded"]))
    for label, want in wants:
        for key in ("losses", "auxes", "norms"):
            if key in want:
                np.testing.assert_allclose(
                    got[key], want[key], rtol=LOSS_RTOL, atol=0,
                    err_msg=f"{name} vs {label}: {key}")
        _assert_params_close(got["params"], want["final"],
                             f"{name} vs {label}")


def test_the_capacity_drops_tokens(world):
    """The routing under test drops assignments in every run: at capacity
    factor 0.75 the first step's forward keeps fewer than the batch makes,
    summed over every rank's stripe."""
    for name in RUNS:
        kept, made = world["port"][name]["kept"]
        assert 0 < kept < made, (name, kept, made)


def test_expert_leaves_stay_on_their_ranks(world):
    """Under ``data=2 x expert=2`` with ``expert`` among the batch axes,
    no expert stack is gathered over ``expert``: each rank holds E/2 of
    the experts, and its expert gradients of the first step are JAX's for
    those experts (``GRAD_RTOL``), summed over the stripes of the whole
    batch; every other gradient is equal (bitwise) on the two ranks of an
    ``expert`` group, summed over ``expert`` too."""
    cfg = _cfg()
    n = RUNS[PLACED][0]["expert"]
    per = cfg.num_experts // n
    for place in world["placement"]:
        first = place["coord"]["expert"] * per
        for k in EXPERT_LEAVES:
            full = world["jax"]["grads"]["layers"][k]
            assert place["shapes"][k] == (full.shape[0], per,
                                          *full.shape[2:]), k
            want = full[:, first:first + per]
            np.testing.assert_allclose(
                place["expert_grads"][k], want, rtol=0,
                atol=GRAD_RTOL * np.abs(full).max(),
                err_msg=f"rank {place['coord']} {k}")
        assert place["others_equal"] and place["others_nonzero"], place[
            "coord"]
