"""Parts of the MoE token exchange and of MoE's replicas on the CPU, with no
JAX program: the reduce-scatter that carries a stripe's dispatch to the
experts' ranks, its adjoint and its strided inputs, and the layout's
exchange on both sides of the experts, in a two-rank gloo world; the
layout's axes and the
whole-sequence stripe MoE is fed under ``seq``, on a stand-in mesh.

Everything compared is exact (integers as f32, sums of two of them).
"""

import multiprocessing
import os
import traceback

import numpy as np
import pytest
import torch

from dstack_tpu_torch.models import data, llama, moe
from dstack_tpu_torch.parallel import collectives
from dstack_tpu_torch.parallel import distributed as dist_lib
from dstack_tpu_torch.parallel import mesh as mesh_lib
from tests.test_torch_context_parallel_parts import _Mesh, _x
from tests.test_torch_parallel import _free_ports

torch.set_num_threads(1)

TINY = moe.MoEConfig.tiny_moe(dtype=torch.float32)
DIMS = (0, 1, 2)


def _exchange(rank, port, queue):
    torch.set_num_threads(1)
    try:
        os.environ.update(DSTACK_MASTER_NODE_IP="127.0.0.1",
                          DSTACK_NODES_NUM="1", DSTACK_NODE_RANK="0",
                          DSTACK_GPUS_PER_NODE="2", LOCAL_RANK=str(rank),
                          DSTACK_COORDINATOR_PORT=str(port))
        os.environ.pop("DSTACK_GPUS_NUM", None)
        assert dist_lib.initialize(device="cpu")
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(expert=2), "cpu")
        out = {}
        for dim in DIMS:
            x = _x(rank).requires_grad_(True)
            y = collectives.reduce_scatter(x, dim, mesh, "expert")
            (y * _x(rank + 7, tuple(y.shape))).sum().backward()
            out[f"reduce_scatter_{dim}"] = (y.detach().numpy(),
                                            x.grad.numpy())
        # strided inputs: a transposed tensor's reduce-scatter, and a
        # gather whose gradient comes back transposed (an einsum's does)
        handed, real = [], collectives._reduce_scatter_single

        def spy(out_, inp, group=None):
            handed.append(inp.is_contiguous())
            return real(out_, inp, group=group)

        collectives._reduce_scatter_single = spy
        try:
            x = _x(rank, (2, 6, 4)).requires_grad_(True)
            y = collectives.reduce_scatter(x.transpose(0, 1), 0, mesh,
                                           "expert")
            w = _x(rank, (3, 4)).requires_grad_(True)
            z = collectives.gather(w, 0, mesh, "expert", reduce=True)
            (z.t() * _x(rank + 7, (4, 6))).sum().backward()
        finally:
            collectives._reduce_scatter_single = real
        out["strided"] = (y.detach().numpy(), w.grad.numpy(), handed)
        layout = moe.ExpertLayout(
            mesh, llama.ShardingPolicy(batch_axes=("expert",)), TINY,
            "expert")
        x = _x(rank, (4, 3, 2)).requires_grad_(True)
        mine = layout.dispatch(x)
        back = layout.collect(mine * 10)
        (back * _x(rank + 7, (4, 3, 2))).sum().backward()
        out["layout"] = (mine.detach().numpy(), back.detach().numpy(),
                         x.grad.numpy(), layout.experts(TINY.num_experts))
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
    procs = [ctx.Process(target=_exchange, args=(r, port, queue))
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


@pytest.mark.parametrize("dim", DIMS)
def test_reduce_scatter_sums_parts_and_gathers_back(two_ranks, dim):
    """Rank j gets part j (along ``dim``, in rank order) of the sum of
    every rank's x; the gradient is every rank's output gradient gathered
    along ``dim`` in rank order, which makes <reduce_scatter(x), g> = <x,
    grad> summed over the ranks."""
    xs = [_x(r).numpy() for r in range(2)]
    inner = 0.0
    for rank in range(2):
        y, dx = two_ranks[rank][f"reduce_scatter_{dim}"]
        np.testing.assert_array_equal(
            y, np.split(xs[0] + xs[1], 2, axis=dim)[rank])
        gs = [_x(r + 7, y.shape).numpy() for r in range(2)]
        np.testing.assert_array_equal(dx, np.concatenate(gs, axis=dim))
        inner += float((y * gs[rank]).sum()) - float((xs[rank] * dx).sum())
    assert inner == 0.0


def test_layout_sends_slots_to_their_experts_and_back(two_ranks):
    """``ExpertLayout`` with ``expert`` among the batch axes: rank j holds
    experts [2j, 2j + 2) of the 4, :meth:`dispatch` gives it those
    experts' slots summed over both stripes, and :meth:`collect` gathers
    every expert's outputs back (x10 here) on each rank; the gradient of a
    stripe's dispatch is every rank's gradient of its experts' outputs
    (x10), summed over the two stripes that read them."""
    xs = [_x(r, (4, 3, 2)).numpy() for r in range(2)]
    gs = [_x(r + 7, (4, 3, 2)).numpy() for r in range(2)]
    total = xs[0] + xs[1]
    for rank in range(2):
        mine, back, dx, experts = two_ranks[rank]["layout"]
        assert experts == (2 * rank, 2 * rank + 2)
        np.testing.assert_array_equal(mine, total[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(back, total * 10)
        np.testing.assert_array_equal(dx, (gs[0] + gs[1]) * 10)


def test_reduce_scatter_takes_strided_tensors(two_ranks):
    """A transposed input and a gradient that comes back transposed (as
    the combine einsum's does) reduce-scatter to the right sums, and every
    buffer handed to the collective is contiguous: NCCL reads it as laid
    out contiguously (on four H100s a strided gradient gave a grad norm
    41% off), where gloo copies."""
    xs = [_x(r, (2, 6, 4)).numpy().transpose(1, 0, 2) for r in range(2)]
    gs = [_x(r + 7, (4, 6)).numpy().T for r in range(2)]
    for rank in range(2):
        y, dw, handed = two_ranks[rank]["strided"]
        np.testing.assert_array_equal(
            y, np.split(xs[0] + xs[1], 2, axis=0)[rank])
        np.testing.assert_array_equal(
            dw, np.split(gs[0] + gs[1], 2, axis=0)[rank])
        assert handed == [True, True], handed


def test_reduce_scatter_refuses_a_dim_that_does_not_split():
    with pytest.raises(ValueError, match="does not split"):
        collectives.reduce_scatter(torch.zeros(3, 2),
                                   0, _Mesh(mesh_lib.MeshSpec(expert=2)),
                                   "expert")


@pytest.mark.parametrize("sizes,policy,exchange,model_axes", [
    (dict(data=2, expert=2), dict(batch_axes=("data", "expert")), True,
     []),
    (dict(expert=2, tensor=2), dict(batch_axes=("data", "fsdp", "expert")),
     True, ["tensor"]),
    (dict(fsdp=2, expert=2), {}, False, ["expert"]),
    (dict(seq=2, expert=2), dict(seq_axis="seq"), False, ["expert"]),
    (dict(stage=2, tensor=2), dict(stage_axis="stage"), False, ["tensor"]),
])
def test_expert_layout_axes(sizes, policy, exchange, model_axes):
    """Which axes the MoE layout sums the experts' work over: ``tensor``,
    and ``expert`` only when the tokens stay put; ``seq`` and ``stage``
    are replicas (no seq or stage path, no gradient summed over them)."""
    layout = moe.ExpertLayout(_Mesh(mesh_lib.MeshSpec(**sizes)),
                              llama.ShardingPolicy(**policy), TINY,
                              "expert")
    assert layout.exchange == exchange
    assert layout._model_axes() == model_axes
    assert layout.seq is None and layout.stage is None
    assert layout.token_axes == layout.batch
    assert layout.expert == ("expert" if "expert" in sizes else None)


@pytest.mark.parametrize("rank", range(4))
def test_moe_is_fed_whole_sequences_under_seq(rank):
    """Under ``MeshSpec(seq=2, data=2)`` and ``seq_axis="seq"`` the dense
    step's feeding stripes the sequence, and MoE's (the policy through
    ``moe.token_policy``) gives each rank its rows with every position:
    ``rank_tokens`` and ``DataLoader.on_mesh`` agree on both."""
    mesh = _Mesh(mesh_lib.MeshSpec(seq=2, data=2), rank)
    policy = llama.ShardingPolicy(seq_axis="seq")
    seq, batch = 16, 4
    tokens = np.arange(batch * (seq + 1)).reshape(batch, seq + 1)
    coord = mesh_lib.mesh_coordinate(mesh)
    rows = tokens[2 * coord["data"]:2 * coord["data"] + 2]
    half = seq // 2
    dense_cols = slice(coord["seq"] * half, (coord["seq"] + 1) * half + 1)
    np.testing.assert_array_equal(data.rank_tokens(tokens, mesh, policy),
                                  rows[:, dense_cols])
    fed = moe.token_policy(policy)
    assert fed.seq_axis is None and fed.batch_axes == policy.batch_axes
    np.testing.assert_array_equal(data.rank_tokens(tokens, mesh, fed), rows)
    ds = data.TokenDataset.from_files(
        [np.arange(batch * 3 * (seq + 1), dtype=np.uint16)], seq)
    loader = data.DataLoader.on_mesh(ds, batch, mesh, fed)
    assert (loader.seq_count, loader.num_processes) == (1, 2)
    assert loader.host_batch(0).shape == (2, seq + 1)
