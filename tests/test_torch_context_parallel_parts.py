"""Parts of the port's sequence and pipeline parallelism on the CPU, with no
JAX model program: the two new collectives' semantics and adjoints in a
two-rank gloo world, ``ulysses.supports`` and ``pipeline_layers``'
refusals against the JAX package's, the sequence stripe of the data
loader against JAX's sharding of the inputs and targets, the stage's
layers of a sharded init, and the serving engine's refusal.

Everything compared is exact (integers, copies, or sums of a few f32
values taken in one order on both sides).
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
from dstack_tpu.ops import ulysses as j_ulysses
from dstack_tpu.parallel import mesh as j_mesh
from dstack_tpu.parallel.pipeline import pipeline_layers as j_pipeline
from dstack_tpu_torch.models import data, llama
from dstack_tpu_torch.ops import ulysses
from dstack_tpu_torch.parallel import collectives
from dstack_tpu_torch.parallel import distributed as dist_lib
from dstack_tpu_torch.parallel import mesh as mesh_lib
from dstack_tpu_torch.parallel.pipeline import pipeline_layers
from dstack_tpu_torch.serving import engine as t_engine
from tests.test_torch_parallel import _free_ports

torch.set_num_threads(1)


class _Mesh:
    """A DeviceMesh's names, sizes, device type and one rank's coordinate."""

    mesh_dim_names = mesh_lib.AXIS_ORDER
    device_type = "cpu"

    def __init__(self, spec: mesh_lib.MeshSpec, rank: int = 0):
        self.shape = tuple(spec.sizes[a] for a in mesh_lib.AXIS_ORDER)
        self.coord = tuple(int(c) for c in np.unravel_index(rank, self.shape))

    def get_coordinate(self):
        return list(self.coord)

    def size(self, dim):
        return self.shape[dim]


# -- the collectives, in a two-rank world ---------------------------------------


def _x(rank, shape=(2, 6, 4)):
    """Rank-distinct integers as f32 (sums of them are exact)."""
    n = int(np.prod(shape))
    return torch.arange(n, dtype=torch.float32).reshape(shape) + 100 * rank


def _collectives(rank, port, queue):
    torch.set_num_threads(1)
    try:
        os.environ.update(DSTACK_MASTER_NODE_IP="127.0.0.1",
                          DSTACK_NODES_NUM="1", DSTACK_NODE_RANK="0",
                          DSTACK_GPUS_PER_NODE="2", LOCAL_RANK=str(rank),
                          DSTACK_COORDINATOR_PORT=str(port))
        os.environ.pop("DSTACK_GPUS_NUM", None)
        assert dist_lib.initialize(device="cpu")
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(seq=2), "cpu")
        out = {}
        for name, perm in (("ring", [(0, 1), (1, 0)]), ("open", [(0, 1)])):
            x = _x(rank).requires_grad_(True)
            y = collectives.ppermute(x, mesh, "seq", perm)
            (y * _x(rank + 7)).sum().backward()
            out[f"ppermute_{name}"] = (y.detach().numpy(), x.grad.numpy())
        for split, concat in ((1, 0), (2, 1), (0, 2)):
            x = _x(rank).requires_grad_(True)
            y = collectives.all_to_all(x, mesh, "seq", split, concat)
            (y * _x(rank + 7, tuple(y.shape))).sum().backward()
            out[f"all_to_all_{split}{concat}"] = (y.detach().numpy(),
                                                 x.grad.numpy())
        torch.distributed.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the test process
        queue.put((rank, {"error": traceback.format_exc()}))
        return
    queue.put((rank, out))


@pytest.fixture(scope="module")
def two_ranks():
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_ports(1)[0]
    procs = [ctx.Process(target=_collectives, args=(r, port, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        # a timeout, not a hang, if the ranks' collectives do not pair up
        results = dict(queue.get(timeout=120) for _ in range(2))
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    errors = [r["error"] for r in results.values() if "error" in r]
    assert not errors, "\n".join(errors)
    return results


@pytest.mark.parametrize("name,perm", [("ring", [(0, 1), (1, 0)]),
                                       ("open", [(0, 1)])])
def test_ppermute_sends_along_pairs_and_back(two_ranks, name, perm):
    """lax.ppermute's semantics: rank d receives rank s's x for each (s, d)
    and zeros where no pair sends; the gradient goes back along the
    inverse pairs (rank s gets d's output gradient)."""
    ys = [_x(r + 7).numpy() for r in range(2)]
    for rank in range(2):
        y, dx = two_ranks[rank][f"ppermute_{name}"]
        src = [s for s, d in perm if d == rank]
        dst = [d for s, d in perm if s == rank]
        np.testing.assert_array_equal(
            y, _x(src[0]).numpy() if src else np.zeros_like(y))
        np.testing.assert_array_equal(
            dx, ys[dst[0]] if dst else np.zeros_like(dx))


@pytest.mark.parametrize("split,concat", [(1, 0), (2, 1), (0, 2)])
def test_all_to_all_is_the_tiled_swap_and_its_adjoint(two_ranks, split,
                                                      concat):
    """lax.all_to_all(tiled=True): rank j gets part j of every rank's x
    (split along ``split``) concatenated along ``concat`` in rank order;
    the gradient is the inverse swap of the output gradients, which makes
    <all_to_all(x), y> = <x, grad> summed over the ranks."""
    xs = [_x(r).numpy() for r in range(2)]
    inner = 0.0
    for rank in range(2):
        y, dx = two_ranks[rank][f"all_to_all_{split}{concat}"]
        want = np.concatenate([np.split(x, 2, axis=split)[rank]
                               for x in xs], axis=concat)
        np.testing.assert_array_equal(y, want)
        g = _x(rank + 7, y.shape).numpy()
        inner += float((y * g).sum()) - float((xs[rank] * dx).sum())
    gs = [_x(r + 7, two_ranks[r][f"all_to_all_{split}{concat}"][0].shape)
          .numpy() for r in range(2)]
    for rank in range(2):
        want = np.concatenate([np.split(g, 2, axis=concat)[rank]
                               for g in gs], axis=split)
        np.testing.assert_array_equal(
            two_ranks[rank][f"all_to_all_{split}{concat}"][1], want)
    assert inner == 0.0


def test_collectives_refuse_what_they_cannot_do():
    mesh = _Mesh(mesh_lib.MeshSpec(seq=2))
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="no permutation"):
        collectives.ppermute(x, mesh, "seq", [(0, 1), (1, 1)])
    with pytest.raises(ValueError, match="not on an axis"):
        collectives.ppermute(x, mesh, "seq", [(0, 2)])
    with pytest.raises(ValueError, match="does not split"):
        collectives.all_to_all(x, mesh, "seq", 1, 0)


# -- Ulysses and the pipeline's rules against the JAX package's --------------------


@pytest.mark.parametrize("heads,kv", [(32, 8), (8, 4), (24, 6), (64, 8)])
def test_ulysses_supports_matches_jax(heads, kv):
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), num_heads=heads,
                              num_kv_heads=kv)
    jcfg = dataclasses.replace(j_llama.LlamaConfig.tiny(), num_heads=heads,
                               num_kv_heads=kv)
    for n_seq in (1, 2, 3, 4, 8):
        for n_tensor in (1, 2, 4):
            assert ulysses.supports(cfg, n_seq, n_tensor) == \
                j_ulysses.supports(jcfg, n_seq, n_tensor), (n_seq, n_tensor)


@pytest.mark.parametrize("layers,batch,micro", [(6, 8, 4), (8, 6, 4),
                                                (8, 8, 3)])
def test_pipeline_layers_refuses_what_jax_refuses(layers, batch, micro):
    """L % stages and B % microbatches: the same ValueError and message as
    the JAX package's (stage=4)."""
    ws = np.zeros((layers, 4, 4), np.float32)
    x = np.zeros((batch, 2, 4), np.float32)
    jmesh = j_mesh.build_mesh(j_mesh.MeshSpec(stage=4, fsdp=2),
                              jax.devices()[:8])
    with pytest.raises(ValueError) as want:
        j_pipeline(lambda c, w: (c, None), jnp.asarray(ws), jnp.asarray(x),
                   mesh=jmesh, num_microbatches=micro)
    with pytest.raises(ValueError) as got:
        pipeline_layers(lambda c, w: c, torch.from_numpy(ws),
                        torch.from_numpy(x),
                        mesh=_Mesh(mesh_lib.MeshSpec(stage=4, fsdp=2)),
                        num_microbatches=micro)
    assert str(got.value) == str(want.value)


def test_pipeline_layers_on_one_stage_is_the_layer_loop():
    ws = torch.randn(3, 4, 4, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 4, generator=torch.Generator().manual_seed(1))
    want = x
    for w in ws:
        want = torch.tanh(want @ w)
    got = pipeline_layers(lambda c, w: torch.tanh(c @ w), ws, x,
                          mesh=_Mesh(mesh_lib.MeshSpec(fsdp=2)))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- data, init and serving under seq / stage ------------------------------------


@pytest.mark.parametrize("sizes", [dict(seq=2), dict(data=2, seq=2),
                                   dict(fsdp=2, seq=2, tensor=2),
                                   dict(stage=2, fsdp=2)],
                         ids=["seq2", "data2-seq2", "fsdp2-seq2-tensor2",
                              "stage2-fsdp2"])
def test_data_loader_stripe_is_the_rank_block_of_inputs_and_targets(sizes):
    """Under seq each rank reads its rows and its stripe of the sequence
    plus one token: inputs [:, :-1] and targets [:, 1:] of it are the
    blocks JAX's P(batch_axes, seq) sharding of the whole batch's inputs
    and targets gives the rank's device; rank_tokens cuts the same block
    out of a global batch."""
    spec = mesh_lib.MeshSpec(**sizes)
    jmesh = j_mesh.build_mesh(j_mesh.MeshSpec(**sizes),
                              jax.devices()[:spec.num_devices])
    policy = llama.ShardingPolicy(seq_axis="seq")
    seq_len, global_batch = 8, 4
    tokens = np.arange(64 * (seq_len + 1), dtype=np.uint16)
    dataset = data.TokenDataset.from_files([tokens], seq_len=seq_len)
    whole = data.DataLoader(dataset, global_batch, seed=3).host_batch(1)
    sharding = NamedSharding(jmesh, P(policy.batch_axes, "seq"))
    inputs = jax.device_put(whole[:, :-1], sharding)
    targets = jax.device_put(whole[:, 1:], sharding)
    devices = list(jmesh.devices.flat)
    for ins, tgt in zip(inputs.addressable_shards,
                        targets.addressable_shards):
        rank = devices.index(ins.device)
        mesh = _Mesh(spec, rank)
        got = data.DataLoader.on_mesh(dataset, global_batch, mesh,
                                      policy=policy, seed=3).host_batch(1)
        rows, cols = j_ckpt._shard_index(inputs, ins)
        np.testing.assert_array_equal(got[:, :-1], np.asarray(ins.data))
        np.testing.assert_array_equal(got[:, 1:], np.asarray(tgt.data))
        np.testing.assert_array_equal(
            got, data.rank_tokens(whole, mesh, policy))
        assert got.shape == (rows[1] - rows[0], cols[1] - cols[0] + 1)


def test_seq_slice_refuses_a_sequence_that_does_not_split():
    assert data.seq_slice(8, 1, 2) == slice(4, 9)
    with pytest.raises(ValueError, match="not divisible by 3"):
        data.seq_slice(8, 0, 3)
    dataset = data.TokenDataset.from_files(
        [np.arange(64, dtype=np.uint16)], seq_len=6)
    with pytest.raises(ValueError, match="not divisible by 4"):
        data.DataLoader(dataset, 2, seq_count=4)


def test_a_stage_block_of_the_init_is_the_whole_init_s_layers():
    """init_params' block over the stacked layer dim (a pipeline stage's
    layers, with an fsdp block of each) keeps exactly those blocks of the
    unsharded draw from the same generator, and draws as much."""
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(dtype=torch.float32),
                              num_layers=4)
    specs = llama.param_specs(cfg, llama.ShardingPolicy(stage_axis="stage"))
    sizes = mesh_lib.MeshSpec(stage=2, fsdp=2).sizes
    coord = {a: 0 for a in sizes} | {"stage": 1, "fsdp": 1}

    def block(name, shape):
        spec = specs[name] if name in specs else specs["layers"][name]
        return tuple(slice(a, b) for a, b in mesh_lib.shard_index(
            spec, shape, sizes, coord))

    whole_gen = torch.Generator().manual_seed(4)
    whole = llama.init_params(cfg, "cpu", whole_gen)
    part_gen = torch.Generator().manual_seed(4)
    part = llama.init_params(cfg, "cpu", part_gen, block=block)
    llama.map_with_specs(
        lambda sp, p, w: torch.testing.assert_close(
            p, mesh_lib.local_block(w, sp, _Mesh(mesh_lib.MeshSpec(
                stage=2, fsdp=2), rank=3)), rtol=0, atol=0),
        specs, part, whole)
    assert part["layers"]["wq"].shape[0] == 2
    assert torch.equal(whole_gen.get_state(), part_gen.get_state())


def test_serving_refuses_sequence_and_pipeline_axes():
    tiny = llama.LlamaConfig.tiny(dtype=torch.float32)
    for sizes, policy in ((dict(seq=2), dict(seq_axis="seq")),
                          (dict(stage=2), dict(stage_axis="stage"))):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            t_engine.InferenceEngine(
                tiny, mesh=_Mesh(mesh_lib.MeshSpec(**sizes)),
                sharding_policy=llama.ShardingPolicy(
                    batch_axes=(), fsdp_axis=None, **policy),
                batch_size=2, max_len=64)
