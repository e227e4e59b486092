"""The port's expert-parallel MoE training against the JAX package's, on the
CPU.

One gloo world of four ranks is spawned once for the module (each rank a
process formed by ``parallel.distributed.initialize`` from the control
plane's variables, one CPU thread each); rank 0 hands the results back.
The JAX side is its unsharded jitted step on the whole batch, which is
what its sharded step computes: under ``jit`` the reference routes the
global batch.  ``tiny_moe`` in f32 at 128 tokens a row (both sides on
their fused attention route, the JAX kernels in interpret mode), four
rows, and a capacity factor of 0.75, at which tokens ARE dropped (the
test asserts it): so each rank must take its capacity slots in the
global (choice, stripe, token) order, and the load-balancing loss must
be the global batch's, for the losses to agree.

What runs in the world:
- three steps on ``MeshSpec(fsdp=2, expert=2)`` (unstacked, remat), on
  ``MeshSpec(data=2, expert=2)`` (stacked, no remat), each rank feeding
  its stripe of the global batch, and on ``MeshSpec(expert=2, tensor=2)``
  (stacked, remat: every rank the whole batch, its experts' half of the
  ffn columns, its half of the heads);
- ``moe.create_state`` on a mesh against the unsharded one.

Tolerances (f32):
- ``LOSS_RTOL`` 1e-5 relative on the cross entropy, the aux loss and the
  grad norm: the collectives and the sharded products sum in another
  order;
- ``PARAM_ATOL`` 2 * lr * steps on parameters, all but a few elements
  within 1e-6 (Adam moves an element whose gradient is rounding noise by
  up to lr a step either way, as in ``test_torch_moe.py``).
"""

import multiprocessing
import os
import socket
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dstack_tpu.models import moe as j_moe
from dstack_tpu.models import train as j_train
from dstack_tpu.ops.loss import chunked_cross_entropy as j_chunked_ce
from dstack_tpu_torch.models import checkpoint as ckpt
from dstack_tpu_torch.models import llama, moe, train
from dstack_tpu_torch.parallel import distributed as dist_lib
from dstack_tpu_torch.parallel import mesh as mesh_lib

SEQ, BATCH, STEPS, LR = 128, 4, 3, 3e-4
CAPACITY_FACTOR = 0.75
LOSS_RTOL = 1e-5
PARAM_ATOL = 2 * LR * STEPS
CLOSE_ATOL, CLOSE_SHARE = 1e-6, 0.999
WORLD = 4
#: the sharded runs: (mesh sizes, unstacked, the port's remat)
SPECS = {"fsdp2_expert2": (dict(fsdp=2, expert=2), True, True),
         "data2_expert2": (dict(data=2, expert=2), False, False),
         "expert2_tensor2": (dict(expert=2, tensor=2), False, True)}


def _cfg():
    return moe.MoEConfig.tiny_moe(dtype=torch.float32,
                                  capacity_factor=CAPACITY_FACTOR)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _np(x):
    return x.detach().numpy().copy()


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


def _sharded_state(tree, cfg, opt, mesh):
    """Step 0 of training the whole numpy ``tree`` on ``mesh``: each rank
    keeps its blocks, placed by ``moe.param_specs``."""
    params = llama.params_from_jax(tree, "cpu", torch.float32)
    specs = moe.specs_for(params, cfg, llama.ShardingPolicy(), "expert")
    local = llama.map_with_specs(
        lambda sp, p: mesh_lib.local_block(p, sp, mesh).clone(), specs,
        params)
    return train._fresh_state(local, opt, unstacked=False, sharded=(
        moe.param_specs(cfg), moe.init_params(cfg, "meta", None), mesh))


class _KeptCount:
    """Within ``with``: the assignments each ``moe._route`` call keeps and
    makes, summed over the calls of the first forward of each layer."""

    def __enter__(self):
        self.route, self.counts, self.seen = moe._route, [0.0, 0.0], 0

        def count(logits, k, capacity, token_mask=None, layout=None):
            out = self.route(logits, k, capacity, token_mask, layout)
            if self.seen < _cfg().num_layers:  # the forward, not remat's
                self.counts[0] += float(out[0].sum())
                self.counts[1] += float(logits.shape[0] * k)
            self.seen += 1
            return out

        moe._route = count
        return self

    def __exit__(self, *exc):
        moe._route = self.route


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
        cfg, opt = _cfg(), train.default_optimizer(lr=LR)

        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(fsdp=2, expert=2), "cpu")
        sharded = moe.create_state(5, cfg, opt, mesh=mesh, unstacked=True,
                                   device="cpu")
        whole = moe.create_state(5, cfg, opt, unstacked=True, device="cpu")
        same = llama.map_with_specs(
            lambda sp, s, w: torch.equal(
                mesh_lib.local_tensor(s),
                mesh_lib.local_block(w.detach(), sp, mesh)),
            moe.specs_for(whole.params, cfg, llama.ShardingPolicy(),
                          "expert"), sharded.params, whole.params)
        bad = torch.tensor(float(not all(llama.tree_leaves(same))))
        dist.all_reduce(bad)
        out["create_state_mismatched_ranks"] = int(bad)
        del sharded, whole

        for name, (sizes, unstacked, remat) in SPECS.items():
            mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(**sizes), "cpu")
            state = _sharded_state(inputs["init"][unstacked], cfg, opt, mesh)
            step_fn = moe.make_train_step(cfg, opt, mesh=mesh, remat=remat)
            run = {"losses": [], "auxes": [], "norms": []}
            for i, b in enumerate(inputs["batches"]):
                with _KeptCount() as kept:
                    state, metrics = step_fn(state,
                                             {"tokens": _stripe(mesh, b)})
                if i == 0:
                    # every rank's stripe, counted once per stripe holder
                    counts = torch.tensor(kept.counts)
                    dist.all_reduce(counts)
                    run["kept"] = counts.tolist()
                run["losses"].append(metrics["loss"].item())
                run["auxes"].append(metrics["aux_loss"].item())
                run["norms"].append(metrics["grad_norm"].item())
            leaves = _full_leaves(state)
            if unstacked:
                leaves = None  # the stacked run checks the parameters
            run["leaves"] = leaves
            out[name] = run
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the test process
        queue.put((rank, {"error": traceback.format_exc()}))
        return
    queue.put((rank, out if rank == 0 else {}))


@pytest.fixture(scope="module")
def world():
    jcfg = j_moe.MoEConfig.tiny_moe(dtype=jnp.float32,
                                   capacity_factor=CAPACITY_FACTOR)
    params = j_moe.init_params(jax.random.PRNGKey(0), jcfg)
    init = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, jcfg.vocab_size, (BATCH, SEQ + 1)).astype(
        np.int32) for _ in range(STEPS)]

    def loss(p, batch):
        x, a = j_moe.backbone(p, batch[:, :-1], jcfg, remat=True)
        return (j_chunked_ce(x, j_moe.llama.output_head(p, jcfg),
                             batch[:, 1:]) + jcfg.router_aux_weight * a)

    grad_norm = jax.jit(lambda p, b: optax.global_norm(jax.grad(loss)(p, b)))
    opt = j_train.default_optimizer(lr=LR)
    state = j_moe.create_state(jax.random.PRNGKey(0), jcfg, opt)
    step_fn = j_moe.make_train_step(jcfg, opt)
    ref = {"losses": [], "auxes": [], "norms": []}
    for b in batches:
        ref["norms"].append(float(grad_norm(state.params, jnp.asarray(b))))
        state, metrics = step_fn(state, {"tokens": jnp.asarray(b)})
        ref["losses"].append(float(metrics["loss"]))
        ref["auxes"].append(float(metrics["aux_loss"]))
    ref["final"] = jax.tree.map(np.asarray, state.params)

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
    return {"jax": ref, "port": results[0]}


@pytest.mark.parametrize("name", list(SPECS))
def test_sharded_moe_steps_match_jax(world, name):
    """Three steps on 4 gloo ranks with tokens dropped by capacity: the
    global cross entropy, aux loss and grad norm against JAX's step on the
    whole batch (``LOSS_RTOL``); the stacked run's parameters after the
    steps against JAX's (``PARAM_ATOL``)."""
    got, want = world["port"][name], world["jax"]
    for key in ("losses", "auxes", "norms"):
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                   atol=0, err_msg=f"{name} {key}")
    if got["leaves"] is None:
        return
    params = [x for path, x in got["leaves"] if path.startswith(".params")]
    ref = llama.tree_leaves(want["final"])
    assert [p.shape for p in params] == [r.shape for r in ref]
    diff = np.concatenate([np.abs(p - r).ravel()
                           for p, r in zip(params, ref)])
    assert diff.max() <= PARAM_ATOL, diff.max()
    assert np.mean(diff <= CLOSE_ATOL) >= CLOSE_SHARE


@pytest.mark.parametrize("name", list(SPECS))
def test_the_capacity_drops_tokens(world, name):
    """The routing under test drops assignments: at capacity factor 0.75
    the first step's forward keeps fewer than the batch makes, summed
    over every rank's stripe."""
    kept, made = world["port"][name]["kept"]
    assert 0 < kept < made, (kept, made)


def test_create_state_holds_each_ranks_block(world):
    """``moe.create_state`` on ``MeshSpec(fsdp=2, expert=2)``: every rank's
    leaves are exactly its blocks of the unsharded draw from the same
    seed (the expert stacks its experts' blocks)."""
    assert world["port"]["create_state_mismatched_ranks"] == 0
