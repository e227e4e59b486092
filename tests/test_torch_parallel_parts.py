"""The sharded slice's parts on the CPU, against the JAX package's own pure
functions: mesh layouts (``MeshSpec.auto``, ``shrink_spec``,
``multislice_spec``), the control plane's process-group variables
(``cluster_env``), sharding specs (``param_specs``, ``unstack_specs``,
``state_specs``), the block each rank holds (JAX's
``addressable_shards`` index) and the batch rows it reads, the
multi-process snapshot barrier, and the refusals that remain.

No process group is formed here (``test_torch_parallel.py`` runs the
sharded path on four gloo ranks): what reads a mesh gets a stand-in with
a DeviceMesh's names, sizes and coordinate.  Everything is exact.
"""

import re

import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import jax
from dstack_tpu.models import checkpoint as j_ckpt
from dstack_tpu.models import llama as j_llama
from dstack_tpu.models import train as j_train
from dstack_tpu.parallel import distributed as j_dist
from dstack_tpu.parallel import mesh as j_mesh
from dstack_tpu_torch.models import checkpoint as ckpt
from dstack_tpu_torch.models import data, llama, train
from dstack_tpu_torch.parallel import distributed as dist_lib
from dstack_tpu_torch.parallel import mesh as mesh_lib

torch.set_num_threads(1)


class _Mesh:
    """A DeviceMesh's names, sizes and one rank's coordinate."""

    mesh_dim_names = mesh_lib.AXIS_ORDER

    def __init__(self, spec: mesh_lib.MeshSpec, rank: int = 0):
        self.shape = tuple(spec.sizes[a] for a in mesh_lib.AXIS_ORDER)
        self.coord = tuple(int(c) for c in np.unravel_index(rank, self.shape))

    def get_coordinate(self):
        return list(self.coord)


AUTO_CASES = [((8,), {}), ((8,), {"tensor": 2}), ((16,), {"data": 2,
                                                          "tensor": 2}),
              ((8,), {"dcn": 2, "seq": 2}), ((12,), {"stage": 3}),
              ((6,), {"tensor": 4})]


@pytest.mark.parametrize("args,kw", AUTO_CASES,
                         ids=[f"{a[0]}-{'-'.join(f'{k}{v}' for k, v in kw.items()) or 'auto'}"
                              for a, kw in AUTO_CASES])
def test_mesh_spec_auto_matches_jax(args, kw):
    try:
        want = j_mesh.MeshSpec.auto(*args, **kw)
    except ValueError:
        with pytest.raises(ValueError, match="not divisible"):
            mesh_lib.MeshSpec.auto(*args, **kw)
        return
    got = mesh_lib.MeshSpec.auto(*args, **kw)
    assert got.sizes == want.sizes and got.num_devices == want.num_devices
    assert mesh_lib.AXIS_ORDER == j_mesh.AXIS_ORDER == got.axis_names()


SHRINK_CASES = [(dict(dcn=2, data=2, fsdp=4, tensor=2, seq=2), 16),
                (dict(dcn=2, data=2, fsdp=4, tensor=2, seq=2), 64),
                (dict(fsdp=4), 2), (dict(data=4, expert=2), 4),
                (dict(data=3, fsdp=2), 6), (dict(tensor=4, fsdp=8), 6),
                (dict(tensor=4, fsdp=8), 0)]


@pytest.mark.parametrize("sizes,n", SHRINK_CASES,
                         ids=[f"{'-'.join(f'{k}{v}' for k, v in s.items())}"
                              f"-to{n}" for s, n in SHRINK_CASES])
def test_shrink_spec_matches_jax(sizes, n):
    """The JAX chaos cases (fold data axes, keep model axes, grow back,
    refuse what cannot host tensor x seq x stage) and a few more."""
    try:
        want = j_mesh.shrink_spec(j_mesh.MeshSpec(**sizes), n)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            mesh_lib.shrink_spec(mesh_lib.MeshSpec(**sizes), n)
        return
    got = mesh_lib.shrink_spec(mesh_lib.MeshSpec(**sizes), n)
    assert got.sizes == want.sizes and got.num_devices == n


@pytest.mark.parametrize("slices", [None, "1", "2"])
def test_multislice_spec_takes_dcn_from_the_env(monkeypatch, slices):
    if slices is None:
        monkeypatch.delenv("MEGASCALE_NUM_SLICES", raising=False)
    else:
        monkeypatch.setenv("MEGASCALE_NUM_SLICES", slices)
    got = mesh_lib.multislice_spec(8, tensor=2)
    assert got.sizes == j_mesh.multislice_spec(8, tensor=2).sizes


_CLUSTER_VARS = ("DSTACK_MASTER_NODE_IP", "DSTACK_NODE_RANK",
                 "DSTACK_NODES_NUM", "DSTACK_GPUS_PER_NODE",
                 "DSTACK_GPUS_NUM", "DSTACK_COORDINATOR_PORT", "LOCAL_RANK")


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"DSTACK_NODES_NUM": "1"}, None),
    ({"DSTACK_NODES_NUM": "1", "DSTACK_GPUS_PER_NODE": "1"}, None),
    ({"DSTACK_NODES_NUM": "4", "DSTACK_NODE_RANK": "2",
      "DSTACK_MASTER_NODE_IP": "10.0.0.1"},
     {"coordinator_ip": "10.0.0.1", "coordinator_port": 8476,
      "num_processes": 4, "process_id": 2, "local_rank": 0}),
    ({"DSTACK_NODES_NUM": "2", "DSTACK_NODE_RANK": "1",
      "DSTACK_GPUS_PER_NODE": "8", "DSTACK_GPUS_NUM": "16",
      "LOCAL_RANK": "3", "DSTACK_COORDINATOR_PORT": "9000",
      "DSTACK_MASTER_NODE_IP": "10.0.0.1"},
     {"coordinator_ip": "10.0.0.1", "coordinator_port": 9000,
      "num_processes": 16, "process_id": 11, "local_rank": 3}),
    ({"DSTACK_NODES_NUM": "1", "DSTACK_GPUS_PER_NODE": "4",
      "DSTACK_MASTER_NODE_IP": "127.0.0.1"},
     {"coordinator_ip": "127.0.0.1", "coordinator_port": 8476,
      "num_processes": 4, "process_id": 0, "local_rank": 0}),
], ids=["unset", "one-node", "one-card", "4-nodes", "2x8-cards",
        "1x4-cards"])
def test_cluster_env(monkeypatch, env, want):
    """One process per card: world = nodes x cards per node, rank = node
    rank x cards per node + LOCAL_RANK.  With one card per node it is the
    JAX package's cluster_env (one process per node)."""
    for name in _CLUSTER_VARS:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    got = dist_lib.cluster_env()
    assert got == want
    if env.get("DSTACK_GPUS_PER_NODE", "1") == "1":
        jax_env = j_dist.cluster_env()
        assert (jax_env is None) == (got is None)
        if got is not None:
            assert {k: got[k] for k in jax_env} == jax_env
    assert dist_lib.DEFAULT_COORDINATOR_PORT == j_dist.DEFAULT_COORDINATOR_PORT


@pytest.mark.parametrize("env,match", [
    ({"DSTACK_NODES_NUM": "2", "DSTACK_GPUS_PER_NODE": "8",
      "DSTACK_GPUS_NUM": "8"}, "DSTACK_GPUS_NUM"),
    ({"DSTACK_NODES_NUM": "1", "DSTACK_GPUS_PER_NODE": "2",
      "LOCAL_RANK": "2", "DSTACK_MASTER_NODE_IP": "h"}, "LOCAL_RANK"),
])
def test_cluster_env_refuses_an_inconsistent_world(monkeypatch, env, match):
    for name in _CLUSTER_VARS:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match=match):
        dist_lib.cluster_env()


def test_initialize_is_a_no_op_for_one_card(monkeypatch):
    """One process on one card forms no group unless forced (the sharded
    path's world size 1 is formed with force=True)."""
    for name in _CLUSTER_VARS:
        monkeypatch.delenv(name, raising=False)
    assert dist_lib.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()


POLICIES = {
    "default": {},
    "no-tensor": {"tensor_axis": None},
    "no-fsdp": {"fsdp_axis": None},
    "stage": {"stage_axis": "stage"},
    "data-fsdp": {"fsdp_axis": "data", "batch_axes": ("dcn", "data")},
}
MODELS = {"tiny": "tiny", "1b": "llama3_1b", "8b": "llama3_8b",
          "untied-tiny": "tiny"}


def _tuple(spec):
    return tuple(spec) if isinstance(spec, P) else spec


def _spec_leaves(tree):
    """A spec tree's leaves in JAX's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _spec_leaves(t)]
    return [tree]


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("policy", list(POLICIES))
def test_specs_equal_jax(model, policy):
    """param_specs, unstack_specs and state_specs entry for entry, in
    snapshot order (params, AdamW's count, mu, nu, step)."""
    kw = {"tie_embeddings": False} if model == "untied-tiny" else {}
    cfg = getattr(llama.LlamaConfig, MODELS[model])(**kw)
    jcfg = getattr(j_llama.LlamaConfig, MODELS[model])(**kw)
    pol = llama.ShardingPolicy(**POLICIES[policy])
    jpol = j_llama.ShardingPolicy(**POLICIES[policy])
    is_p = lambda x: isinstance(x, P)  # noqa: E731
    want = j_llama.param_specs(jcfg, jpol)
    got = llama.param_specs(cfg, pol)
    assert _spec_leaves(got) == [_tuple(p) for p in
                                 jax.tree.leaves(want, is_leaf=is_p)]
    got_u = llama.unstack_specs(got, 3)
    want_u = j_llama.unstack_specs(want, 3)
    assert _spec_leaves(got_u) == [_tuple(p) for p in
                                   jax.tree.leaves(want_u, is_leaf=is_p)]
    if model in ("1b", "8b"):
        return  # state_specs traces the model's init: the tiny ones do
    jopt = j_train.default_optimizer()
    for unstacked in (False, True):
        st = train.state_specs(cfg, train.default_optimizer(), pol,
                               unstacked=unstacked)
        mine = (_spec_leaves(st.params) + [st.opt_state["count"]]
                + _spec_leaves(st.opt_state["mu"])
                + _spec_leaves(st.opt_state["nu"]) + [st.step])
        jst = j_train.state_specs(jcfg, jopt, jpol, unstacked=unstacked)
        assert mine == [_tuple(p) for p in
                        jax.tree.leaves(jst, is_leaf=is_p)]


SHARD_CASES = [
    (dict(fsdp=2, tensor=2), ("tensor", "fsdp"), (8, 6)),
    (dict(fsdp=2, tensor=2), ("fsdp", "tensor"), (4, 8)),
    (dict(data=2, fsdp=2, tensor=2), (None, "fsdp", "tensor"), (2, 4, 6)),
    (dict(dcn=2, data=2, fsdp=2), (("dcn", "data", "fsdp"), None), (8, 3)),
    (dict(data=2, fsdp=2, tensor=2), (("data", "fsdp"), "tensor"), (8, 4)),
    (dict(dcn=2, fsdp=2, tensor=2), (("dcn", "fsdp"), None, "tensor", None),
     (4, 5, 2, 3)),
    (dict(fsdp=4, tensor=2), (None,), (5,)),
]


@pytest.mark.parametrize("sizes,spec,shape", SHARD_CASES,
                         ids=[f"{i}" for i in range(len(SHARD_CASES))])
def test_shard_index_equals_jax_addressable_shards(sizes, spec, shape):
    """Rank r of the port's mesh is device r of JAX's (both row-major over
    AXIS_ORDER); its block under a spec is the index JAX gives that
    device's shard, multi-axis dims major-first."""
    jspec = j_mesh.MeshSpec(**sizes)
    jmesh = j_mesh.build_mesh(jspec, jax.devices()[:jspec.num_devices])
    arr = jax.device_put(np.zeros(shape, np.float32),
                         NamedSharding(jmesh, P(*spec)))
    devices = list(jmesh.devices.flat)
    port_spec = mesh_lib.MeshSpec(**sizes)
    for shard in arr.addressable_shards:
        rank = devices.index(shard.device)
        mesh = _Mesh(port_spec, rank)
        coord = dict(zip(mesh.mesh_dim_names, mesh.coord))
        got = mesh_lib.shard_index(spec, shape, port_spec.sizes, coord)
        assert got == j_ckpt._shard_index(arr, shard), (rank, spec)


@pytest.mark.parametrize("sizes", [dict(fsdp=2, tensor=2),
                                   dict(dcn=2, data=2, fsdp=2),
                                   dict(data=2, tensor=4)],
                         ids=["fsdp2-tensor2", "dcn2-data2-fsdp2",
                              "data2-tensor4"])
def test_data_loader_stripe_is_the_rank_batch_shard(sizes):
    """DataLoader.on_mesh reads the rows JAX's batch sharding (the policy's
    batch axes over dim 0) gives the rank's device: ranks differing only in
    tensor read the same rows."""
    spec = mesh_lib.MeshSpec(**sizes)
    jmesh = j_mesh.build_mesh(j_mesh.MeshSpec(**sizes),
                              jax.devices()[:spec.num_devices])
    batch_axes = llama.ShardingPolicy().batch_axes
    global_batch = 8
    arr = jax.device_put(np.arange(global_batch * 3).reshape(global_batch, 3),
                         NamedSharding(jmesh, P(batch_axes, None)))
    devices = list(jmesh.devices.flat)
    tokens = np.arange(64 * 5, dtype=np.uint16)
    dataset = data.TokenDataset.from_files([tokens], seq_len=4)
    whole = data.DataLoader(dataset, global_batch, seed=3).host_batch(2)
    for shard in arr.addressable_shards:
        rank = devices.index(shard.device)
        rows = j_ckpt._shard_index(arr, shard)[0]
        loader = data.DataLoader.on_mesh(dataset, global_batch,
                                         _Mesh(spec, rank), seed=3)
        np.testing.assert_array_equal(loader.host_batch(2),
                                      whole[rows[0]:rows[1]])


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _Mesh(mesh_lib.MeshSpec(data=2, fsdp=2, tensor=2))
    R = Replicate()
    assert mesh_lib.placements(("tensor", "fsdp"), mesh) == (
        R, R, R, Shard(1), R, R, Shard(0))
    assert mesh_lib.placements((("data", "fsdp"), None), mesh) == (
        R, R, Shard(0), Shard(0), R, R, R)
    with pytest.raises(NotImplementedError, match="mesh order"):
        mesh_lib.placements((("fsdp", "data"),), mesh)
    with pytest.raises(ValueError, match="not a mesh axis"):
        mesh_lib.placements(("model",), mesh)


def test_the_sharded_forward_refuses_what_is_not_ported():
    """What stays refused are the JAX package's own refusals, with its
    messages: seq together with stage, custom positions under either,
    unstacked layers under stage, Ulysses with heads that do not split
    over seq x tensor; and a tensor degree must divide both head counts
    (sizes of 1 run the sharded path)."""
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    stacked = llama.init_params(cfg, "meta", None)
    seq, stage = (llama.ShardingPolicy(seq_axis="seq"),
                  llama.ShardingPolicy(stage_axis="stage"))
    with pytest.raises(NotImplementedError, match="can't be combined"):
        llama.backbone(stacked, tokens, cfg,
                       mesh=_Mesh(mesh_lib.MeshSpec(seq=2, stage=2)),
                       policy=llama.ShardingPolicy(seq_axis="seq",
                                                   stage_axis="stage"))
    for sizes, policy in ((dict(seq=2), seq), (dict(stage=2), stage)):
        with pytest.raises(NotImplementedError, match="custom `positions`"):
            llama.backbone(stacked, tokens, cfg,
                           mesh=_Mesh(mesh_lib.MeshSpec(**sizes)),
                           policy=policy, positions=tokens)
    with pytest.raises(NotImplementedError, match="stacked"):
        llama.backbone(llama.unstack_params(stacked), tokens, cfg,
                       mesh=_Mesh(mesh_lib.MeshSpec(stage=2)), policy=stage)
    for sizes in (dict(seq=8), dict(seq=2, tensor=4)):
        with pytest.raises(ValueError, match="seq_scheme='ulysses'"):
            llama.backbone(stacked, tokens, cfg,
                           mesh=_Mesh(mesh_lib.MeshSpec(**sizes)),
                           policy=llama.ShardingPolicy(
                               seq_axis="seq", seq_scheme="ulysses"))
    with pytest.raises(NotImplementedError, match="num_kv_heads"):
        llama.backbone({}, tokens, cfg,
                       mesh=_Mesh(mesh_lib.MeshSpec(tensor=8)))
    with pytest.raises(ValueError, match="seq_scheme"):
        llama.ShardingPolicy(seq_scheme="tree")


def test_rank_zero_publishes_only_after_every_rank_staged(tmp_path):
    """The filesystem barrier (the JAX multihost test's counterpart): a
    rank that never stages costs the step, never a torn snapshot; once it
    stages, the same step publishes."""
    state = {"w": torch.ones(2, 2)}
    cp = ckpt.AsyncCheckpointer(tmp_path, every_steps=1, process_index=0,
                                num_processes=2, stage_timeout=0.3)
    cp.save(state, 5)
    with pytest.raises(RuntimeError, match="checkpoint writer failed"):
        cp.flush()
    assert ckpt.latest_snapshot_step(tmp_path) is None
    ckpt.stage_snapshot(tmp_path, ckpt.snapshot_train_state(state), 6,
                        process_index=1)
    cp.save(state, 6)
    cp.flush()
    cp.close()
    assert ckpt.latest_snapshot_step(tmp_path) == 6


def test_stale_attempt_staging_never_satisfies_the_barrier(tmp_path):
    """Files staged by a crashed earlier attempt (a 4-rank mesh that died
    mid-staging) neither satisfy a later attempt's barrier nor leak into
    its snapshot."""
    state = {"w": torch.full((2, 2), 7.0)}
    stale = ckpt.snapshot_train_state({"w": torch.zeros(2, 2)})
    for rank in range(4):
        ckpt.stage_snapshot(tmp_path, stale, 4, process_index=rank,
                            attempt=0)
    cp = ckpt.AsyncCheckpointer(tmp_path, every_steps=1, process_index=0,
                                num_processes=2, stage_timeout=0.3,
                                attempt=1)
    cp.save(state, 4)
    with pytest.raises(RuntimeError, match="checkpoint writer failed"):
        cp.flush()
    assert ckpt.latest_snapshot_step(tmp_path) is None
    ckpt.stage_snapshot(tmp_path, ckpt.snapshot_train_state(state), 4,
                        process_index=1, attempt=1)
    cp.save(state, 4)
    cp.flush()
    cp.close()
    restored, step = ckpt.read_snapshot(tmp_path, state)
    assert step == 4 and torch.equal(restored["w"], torch.full((2, 2), 7.0))
    assert len(list((tmp_path / "step_00000004").glob("host_*.npz"))) == 2
