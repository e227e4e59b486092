"""The port's mesh-sharded serving engine against the JAX package's, on the
CPU.

One gloo world of four ranks is spawned once for the module (each rank a
process formed by ``parallel.distributed.initialize`` from the control
plane's variables, one CPU thread each).  Every rank builds each engine
on its mesh; rank 0 drives the requests and closes the engine, the other
ranks run ``engine.follow()`` (the lockstep of serving/lockstep.py),
which checks rank 0's tokens against their own and returns how many
token arrays it checked.  Before the requests, every rank runs the
prompt forward of its shards for the last-token logits.

The references are the JAX package's single-device engines and prompt
forwards on the same weights (numpy draws from a seed through
``params_from_jax``, f32): its own tests hold its mesh engines to them
(``tests/compute/test_serving.py``).  Meshes of two ranks of tensor
parallelism run in the four-rank world as ``MeshSpec(data=2, tensor=2)``:
the serving policy replicates the engine over ``data``.

Tolerances (f32):
- greedy tokens EQUAL: the same function, the sums in another order;
- last-token logits within ``LOGITS_RTOL`` = 1e-5 of the largest logit
  (the row-parallel products and the gathered vocabulary sum in another
  order than one device's products);
- every follower checked every token array rank 0 produced, all equal.

int4 KV is quantized on the CPU bitwise as the JAX package quantizes it,
so even its tokens are equal.
"""

import dataclasses
import multiprocessing
import os
import socket
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.models import moe as j_moe
from dstack_tpu.models.llama import LlamaConfig as JConfig
from dstack_tpu.serving import engine as j_engine
from dstack_tpu.serving.quant import quantize_params as j_quantize
from dstack_tpu_torch.models import moe
from dstack_tpu_torch.models.llama import LlamaConfig, params_from_jax
from dstack_tpu_torch.parallel import distributed as dist_lib
from dstack_tpu_torch.parallel import mesh as mesh_lib
from dstack_tpu_torch.serving import engine as t_engine

WORLD = 4
PROMPTS = [[1, 5, 9, 2, 7], list(range(3, 30))]  # both in the 32 bucket
SPEC_PROMPTS = [[5, 9, 5, 9, 2, 5, 9, 5, 9, 2, 5, 9]]
#: two slots, three prompts: the third waits for a slot and reuses the
#: second's first two blocks of 8 (a prefix-cache hit); the second is
#: prefilled in two chunks of at most 16
PREFIX_PROMPTS = [[1, 5, 9, 2, 7], list(range(3, 30)),
                  list(range(3, 19)) + [40, 41, 42]]
NEW_TOKENS = 8
BUCKET = 32
ENGINE_KW = dict(batch_size=2, max_len=64)
LOGITS_RTOL = 1e-5
#: the engines: (model, mesh sizes, engine options, prompts)
CASES = {
    "tensor4_dense": ("llama", dict(tensor=4), {}, PROMPTS),
    "tensor4_paged": ("llama", dict(tensor=4),
                      dict(paged=True, kv_block_size=8), PROMPTS),
    "tensor2_int8": ("llama", dict(data=2, tensor=2),
                     dict(paged=True, kv_block_size=8, quantize="int8",
                          kv_quantize="int8"), PROMPTS),
    "moe_expert2_tensor2": ("moe", dict(expert=2, tensor=2), {}, PROMPTS),
    "tensor4_speculation": ("llama", dict(tensor=4),
                            dict(speculation="ngram"), SPEC_PROMPTS),
    "tensor2_int4_chunked_prefix": (
        "llama", dict(data=2, tensor=2),
        dict(paged=True, kv_block_size=8, kv_quantize="int4",
             prefill_chunk=16, prefix_cache=True), PREFIX_PROMPTS),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _llama_tree(seed=0):
    """``init_params``' tree of ``LlamaConfig.tiny`` drawn with numpy."""
    cfg = JConfig.tiny()
    rng = np.random.default_rng(seed)
    d, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def dense(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)

    return {
        "embed": dense((cfg.vocab_size, d), d),
        "layers": {
            "attn_norm": np.ones((n, d), np.float32),
            "wq": dense((n, d, cfg.q_dim), d),
            "wk": dense((n, d, cfg.kv_dim), d),
            "wv": dense((n, d, cfg.kv_dim), d),
            "wo": dense((n, cfg.q_dim, d), cfg.q_dim),
            "mlp_norm": np.ones((n, d), np.float32),
            "w_gate": dense((n, d, f), d),
            "w_up": dense((n, d, f), d),
            "w_down": dense((n, f, d), f),
        },
        "final_norm": np.ones((d,), np.float32),
        "lm_head": dense((d, cfg.vocab_size), d),
    }


def _configs():
    """(JAX config, port config) of each model, f32, MoE dropless."""
    return {
        "llama": (dataclasses.replace(JConfig.tiny(), dtype=jnp.float32),
                  LlamaConfig.tiny(dtype=torch.float32)),
        "moe": (j_moe.MoEConfig.tiny_moe(dtype=jnp.float32,
                                         capacity_factor=4.0),
                moe.MoEConfig.tiny_moe(dtype=torch.float32,
                                       capacity_factor=4.0)),
    }


def _padded(prompt):
    padded = np.zeros(BUCKET, np.int64)
    padded[:len(prompt)] = prompt
    return padded


def _drive(engine, prompts):
    reqs = [t_engine.Request(tokens=list(p), max_new_tokens=NEW_TOKENS)
            for p in prompts]
    for r in reqs:
        engine.submit(r)
    for _ in range(200):
        if all(r.done.is_set() for r in reqs):
            break
        engine.step()
    assert all(r.done.is_set() for r in reqs)
    return [r.output for r in reqs]


def _refusals(engine) -> list:
    """What rank 0's mesh engine refuses before any device operation:
    prefill/decode export, and installing a prefill replica's KV."""
    refused = []
    try:
        engine.prefill_export([1, 2, 3])
    except NotImplementedError as e:
        refused.append(str(e))
    try:
        engine.submit(t_engine.Request(tokens=[1, 2, 3], prefill={
            "ks": None, "vs": None, "length": 3, "first_token": 0}))
    except NotImplementedError as e:
        refused.append(str(e))
    return refused


def _rank_case(rank, name, trees, out):
    model, sizes, kw, prompts = CASES[name]
    cfg = _configs()[model][1]
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(**sizes), "cpu")
    engine = t_engine.InferenceEngine(
        cfg, params=params_from_jax(trees[model], "cpu", torch.float32),
        mesh=mesh, **ENGINE_KW, **kw)
    assert engine._hkv == cfg.num_kv_heads // sizes["tensor"]
    # every rank: the prompt forward of its shards
    logits, _, _ = t_engine._prompt_forward(
        engine.params, cfg, torch.from_numpy(_padded(prompts[0])),
        len(prompts[0]), BUCKET, layout=engine._layout)
    if rank == 0:
        if name == "tensor4_dense":
            out["refused"] = _refusals(engine)
        tokens = _drive(engine, prompts)
        leader = engine._leader
        engine.close()
        out[name] = {"tokens": tokens, "logits": logits.numpy(),
                     "checks_sent": leader.checks_sent,
                     "hit_blocks": (engine._alloc.stats["hit_blocks"]
                                    if engine.prefix_cache else None)}
    else:
        out[name] = engine.follow()


def _world_main(rank, port, trees, queue):
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
        for name in CASES:
            _rank_case(rank, name, trees, out)
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the test process
        queue.put((rank, {"error": traceback.format_exc()}))
        return
    queue.put((rank, out))


def _jax_case(name, jtrees):
    model, _, kw, prompts = CASES[name]
    jcfg = _configs()[model][0]
    params = jtrees[model]
    engine = j_engine.InferenceEngine(jcfg, params=params, **ENGINE_KW, **kw)
    reqs = [j_engine.Request(tokens=list(p), max_new_tokens=NEW_TOKENS)
            for p in prompts]
    for r in reqs:
        engine.submit(r)
    for _ in range(200):
        if all(r.done.is_set() for r in reqs):
            break
        engine.step()
    if kw.get("quantize"):
        params = j_quantize(params, tied_head_copy=jcfg.tie_embeddings)
    logits, _, _ = j_engine._prompt_forward(
        params, jcfg, jnp.asarray(_padded(prompts[0]), jnp.int32),
        len(prompts[0]), BUCKET)
    return {"tokens": [r.output for r in reqs], "logits": np.asarray(logits)}


@pytest.fixture(scope="module")
def world():
    jmoe = _configs()["moe"][0]
    trees = {"llama": _llama_tree(),
             "moe": jax.tree.map(np.asarray, j_moe.init_params(
                 jax.random.PRNGKey(0), jmoe))}
    jtrees = {k: jax.tree.map(jnp.asarray, v) for k, v in trees.items()}
    ref = {name: _jax_case(name, jtrees) for name in CASES}

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_world_main, args=(r, port, trees, queue))
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
    return {"jax": ref, "ranks": results}


def _check(world, name):
    got, want = world["ranks"][0][name], world["jax"][name]
    assert got["tokens"] == want["tokens"], name
    scale = np.abs(want["logits"]).max()
    assert np.abs(got["logits"] - want["logits"]).max() <= LOGITS_RTOL * scale
    # every follower ran in lockstep and checked every token array
    assert got["checks_sent"] > 0
    for rank in range(1, WORLD):
        assert world["ranks"][rank][name]["checked"] == got["checks_sent"]


@pytest.mark.parametrize("name", ["tensor4_dense", "tensor4_paged"])
def test_tensor_parallel_greedy_matches_jax(world, name):
    """tensor=4 (one KV head a rank), dense and paged: JAX's tokens, its
    last-token logits, and the same tokens on every rank."""
    _check(world, name)


def test_tensor_parallel_int8_weights_and_kv_match_jax(world):
    """tensor=2 with int8 weights (scales of the whole matrix on the
    row-parallel ``wo``/``w_down``) and int8 paged KV."""
    _check(world, "tensor2_int8")


def test_expert_and_tensor_parallel_moe_matches_jax(world):
    """``tiny_moe`` at expert=2 x tensor=2, dropless: each rank runs two
    of the four experts on half their ffn columns."""
    _check(world, "moe_expert2_tensor2")


def test_tensor_parallel_speculation_matches_jax(world):
    """n-gram speculation at tensor=4: the widened verify forward under
    the mesh gives plain greedy decode's tokens, JAX's."""
    _check(world, "tensor4_speculation")


def test_prefill_export_and_install_are_refused_under_a_mesh(world):
    """Prefill/decode disaggregation is not ported under a mesh: both legs
    raise "not yet ported" on rank 0, before any device operation (the
    engine then serves on, as the tensor4_dense case shows)."""
    refused = world["ranks"][0]["refused"]
    assert len(refused) == 2
    assert all("not yet ported" in r for r in refused), refused


def test_int4_kv_chunked_prefill_and_prefix_hits_match_jax(world):
    """tensor=2 with int4 paged KV, chunked prefill and prefix caching:
    the cache holds each rank's heads packed, chunks and a prefix hit's
    suffix run as lockstep operations, and the tokens are JAX's."""
    _check(world, "tensor2_int4_chunked_prefix")
    assert world["ranks"][0]["tensor2_int4_chunked_prefix"][
        "hit_blocks"] == 2
