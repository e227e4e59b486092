"""The rest of the port's mesh serving against the JAX package's engine, on
the CPU: prefill/decode (PD) export and install under ``tensor`` and
``expert`` meshes, the weights over ``fsdp`` and the batch over ``data``.

One gloo world of four ranks is spawned once for the module, as
``test_torch_mesh_serving.py`` spawns its world.  Every rank builds each
case's engine on its mesh; rank 0 exports prompts, installs prefill
results and drives requests, then closes the engine; the other ranks run
``engine.follow()``, which checks rank 0's tokens against their own.

The references are the JAX package's single-device engines on the same
weights (numpy draws through ``params_from_jax``, f32): its
``prefill_export`` and its colocated greedy tokens.

Tolerances (f32):
- an export's ``ks``/``vs`` within ``EXPORT_RTOL`` = 1e-5 of their
  largest value and its logits within 1e-5 of the largest logit (the
  row-parallel products sum in another order than one device's);
  ``first_token`` and ``length`` equal;
- greedy tokens EQUAL (the same function, the sums in another order);
- every follower checked every token array rank 0 produced, all equal.
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
from dstack_tpu_torch.models import moe
from dstack_tpu_torch.models.llama import (LlamaConfig, ShardingPolicy,
                                           params_from_jax)
from dstack_tpu_torch.parallel import distributed as dist_lib
from dstack_tpu_torch.parallel import mesh as mesh_lib
from dstack_tpu_torch.serving import engine as t_engine

WORLD = 4
PROMPTS = [[1, 5, 9, 2, 7], list(range(3, 30))]  # both in the 32 bucket
PD_PROMPT = [(i * 37 + 11) % 256 for i in range(27)]
NEW_TOKENS = 8
ENGINE_KW = dict(batch_size=2, max_len=64)
PAGED = dict(paged=True, kv_block_size=8)
EXPORT_RTOL = 1e-5
EXPORT_KEYS = {"ks", "vs", "logits", "first_token", "length"}
FSDP_POLICY = dict(batch_axes=("fsdp",), fsdp_axis="fsdp",
                   tensor_axis="tensor")
#: the engines: (model, mesh sizes, policy or None, engine options, what
#: rank 0 does: "pd" exports PD_PROMPT and installs the JAX export, "serve"
#: drives PROMPTS)
CASES = {
    "export_d2t2": ("llama", dict(data=2, tensor=2), None, {}, "pd"),
    "install_t4_paged": ("llama", dict(tensor=4), None, PAGED, "install"),
    "moe_f2e2": ("moe", dict(fsdp=2, expert=2), FSDP_POLICY, {}, "pd"),
    "fsdp2_t2_dense": ("llama", dict(fsdp=2, tensor=2), FSDP_POLICY, {},
                       "serve"),
    "fsdp2_t2_paged": ("llama", dict(fsdp=2, tensor=2), FSDP_POLICY, PAGED,
                       "serve"),
    "fsdp2_t2_int8": ("llama", dict(fsdp=2, tensor=2), FSDP_POLICY,
                      dict(PAGED, quantize="int8"), "serve"),
    "data2_t2_batch": ("llama", dict(data=2, tensor=2),
                       dict(batch_axes=("data",), fsdp_axis=None,
                            tensor_axis="tensor"), PAGED, "serve"),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _llama_tree(seed=0):
    """``init_params``' tree of ``LlamaConfig.tiny`` (untied) drawn with
    numpy."""
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


def _drive(engine, reqs):
    for r in reqs:
        engine.submit(r)
    for _ in range(200):
        if all(r.done.is_set() for r in reqs):
            break
        engine.step()
    assert all(r.done.is_set() for r in reqs)
    return [r.output for r in reqs]


def _installed(export):
    """A decode leg carrying ``export`` (a JAX or a port prefill result)."""
    return t_engine.Request(
        tokens=list(PD_PROMPT), max_new_tokens=NEW_TOKENS,
        prefill={k: export[k] for k in EXPORT_KEYS})


def _as_numpy(export):
    return {k: (np.asarray(v) if k in ("ks", "vs", "logits") else v)
            for k, v in export.items()}


def _rank_case(rank, name, trees, jexports, out):
    model, sizes, policy, kw, role = CASES[name]
    cfg = _configs()[model][1]
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(**sizes), "cpu")
    engine = t_engine.InferenceEngine(
        cfg, params=params_from_jax(trees[model], "cpu", torch.float32),
        mesh=mesh, sharding_policy=policy and ShardingPolicy(**policy),
        **ENGINE_KW, **kw)
    if rank != 0:
        out[name] = engine.follow()
        return
    got = {"wq_shape": tuple(engine.params["layers"]["wq"].shape
                             if not kw.get("quantize")
                             else engine.params["layers"]["wq"]["q"].shape)}
    if role == "pd":
        got["export"] = _as_numpy(engine.prefill_export(
            PD_PROMPT, max_new_tokens=NEW_TOKENS))
        got["tokens"] = _drive(engine, [_installed(jexports[model])])
    elif role == "install":
        # JAX's export, and the port's own from the data x tensor mesh
        got["tokens"] = _drive(engine, [
            _installed(jexports["llama"]),
            _installed(out["export_d2t2"]["export"])])
    else:
        got["tokens"] = _drive(engine, [
            t_engine.Request(tokens=list(p), max_new_tokens=NEW_TOKENS)
            for p in PROMPTS])
    leader = engine._leader
    engine.close()
    got["checks_sent"] = leader.checks_sent
    out[name] = got


def _world_main(rank, port, trees, jexports, queue):
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
            _rank_case(rank, name, trees, jexports, out)
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the test process
        queue.put((rank, {"error": traceback.format_exc()}))
        return
    queue.put((rank, out))


def _jax_tokens(model, jtrees, kw, prompts):
    jcfg = _configs()[model][0]
    engine = j_engine.InferenceEngine(jcfg, params=jtrees[model],
                                      **ENGINE_KW, **kw)
    reqs = [j_engine.Request(tokens=list(p), max_new_tokens=NEW_TOKENS)
            for p in prompts]
    for r in reqs:
        engine.submit(r)
    for _ in range(200):
        if all(r.done.is_set() for r in reqs):
            break
        engine.step()
    return [r.output for r in reqs], engine


@pytest.fixture(scope="module")
def world():
    jmoe = _configs()["moe"][0]
    trees = {"llama": _llama_tree(),
             "moe": jax.tree.map(np.asarray, j_moe.init_params(
                 jax.random.PRNGKey(0), jmoe))}
    jtrees = {k: jax.tree.map(jnp.asarray, v) for k, v in trees.items()}
    ref, jexports = {}, {}
    for model in ("llama", "moe"):
        # the colocated tokens of PD_PROMPT, and the same engine's export
        ref[f"{model}_pd"], engine = _jax_tokens(model, jtrees, {},
                                                 [PD_PROMPT])
        jexports[model] = _as_numpy(engine.prefill_export(
            PD_PROMPT, max_new_tokens=NEW_TOKENS))
    for label, kw in (("dense", {}), ("paged", PAGED),
                      ("int8", dict(PAGED, quantize="int8"))):
        ref[label] = _jax_tokens("llama", jtrees, kw, PROMPTS)[0]

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_world_main,
                         args=(r, port, trees, jexports, queue))
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
    return {"jax": ref, "exports": jexports, "ranks": results}


def _lockstep(world, name):
    """Every follower ran in lockstep and checked every token array."""
    sent = world["ranks"][0][name]["checks_sent"]
    assert sent > 0
    for rank in range(1, WORLD):
        assert world["ranks"][rank][name]["checked"] == sent, (name, rank)


def _check_export(got, want):
    assert set(got) == EXPORT_KEYS
    assert got["length"] == want["length"] == len(PD_PROMPT)
    assert got["first_token"] == want["first_token"]
    for k in ("ks", "vs", "logits"):
        assert got[k].shape == want[k].shape, k
        scale = np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= EXPORT_RTOL * scale, k


def test_export_under_data_and_tensor_matches_jax(world):
    """data=2 x tensor=2: each rank's heads of the prompt's K/V gathered in
    head order give JAX's single-device export (one KV head pair a
    rank), and JAX's export installed there decodes JAX's colocated
    tokens."""
    got = world["ranks"][0]["export_d2t2"]
    _check_export(got["export"], world["exports"]["llama"])
    assert got["tokens"] == world["jax"]["llama_pd"]
    _lockstep(world, "export_d2t2")


def test_exports_installed_under_tensor4_paged_match_jax(world):
    """tensor=4, paged: JAX's export and the port's data x tensor export,
    installed (each rank its one KV head, padded to whole blocks), both
    decode JAX's colocated tokens; the followers check the first tokens
    the installs' logits give."""
    got = world["ranks"][0]["install_t4_paged"]
    assert got["tokens"] == [world["jax"]["llama_pd"][0]] * 2
    _lockstep(world, "install_t4_paged")


def test_moe_expert_parallel_export_and_install_match_jax(world):
    """``tiny_moe`` at fsdp=2 x expert=2, dropless, the weights over fsdp
    (the router and each rank's experts gathered at use): the export
    (K/V replicated over ``expert`` and ``fsdp``, nothing to gather) is
    JAX's, and JAX's export installed decodes JAX's colocated tokens."""
    got = world["ranks"][0]["moe_f2e2"]
    cfg = _configs()["moe"][1]
    assert got["wq_shape"] == (cfg.num_layers, cfg.hidden_size // 2,
                               cfg.q_dim)
    _check_export(got["export"], world["exports"]["moe"])
    assert got["tokens"] == world["jax"]["moe_pd"]
    _lockstep(world, "moe_f2e2")


@pytest.mark.parametrize("name,ref", [("fsdp2_t2_dense", "dense"),
                                      ("fsdp2_t2_paged", "paged"),
                                      ("fsdp2_t2_int8", "int8")])
def test_fsdp_and_tensor_serving_matches_jax(world, name, ref):
    """fsdp=2 x tensor=2: each rank holds its quarter of every matrix
    (the contraction dim over fsdp, heads or ffn over tensor), gathers a
    layer's over fsdp at use, and gives JAX's tokens; int8 weights take
    the whole matrix's channel scales."""
    got = world["ranks"][0][name]
    cfg = _configs()["llama"][1]
    assert got["wq_shape"] == (cfg.num_layers, cfg.hidden_size // 2,
                               cfg.q_dim // 2)
    assert got["tokens"] == world["jax"][ref]
    _lockstep(world, name)


def test_batch_axis_serving_matches_jax(world):
    """``batch_axes=("data",)`` at data=2 x tensor=2, paged: every rank of
    ``data`` serves all the slots (the rows are not striped), the tokens
    are JAX's, and the followers check each of rank 0's token arrays."""
    got = world["ranks"][0]["data2_t2_batch"]
    assert got["tokens"] == world["jax"]["paged"]
    _lockstep(world, "data2_t2_batch")
