"""The mesh slice's parts on the CPU that need no JAX model program: the
engine's refusals (the JAX engine's messages), ``moe.param_specs``
against the JAX package's, int8 scales of a row-parallel shard, the
lockstep's wire format and its token check, and ``--tensor-parallel``:
its parsing, its "only k device(s)" exit, a two-rank server on the CPU
(gloo) over HTTP whose follower, once killed, takes rank 0 down, a
two-rank server answering both prefill/decode legs, a two-rank replica
serving the weights its rank 0 pulled from a peer, and a step that fails
on rank 0 alone stopping the replica.

Mesh parity with JAX is in ``test_torch_mesh_serving.py`` (serving) and
``test_torch_moe_parallel.py`` (expert-parallel training).
"""

import dataclasses
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dstack_tpu.models import moe as j_moe
from dstack_tpu.models.llama import ShardingPolicy as JPolicy
from dstack_tpu_torch.models import checkpoint as ckpt
from dstack_tpu_torch.models import llama, moe
from dstack_tpu_torch.parallel import mesh as mesh_lib
from dstack_tpu_torch.serving import engine as t_engine
from dstack_tpu_torch.serving import lockstep
from dstack_tpu_torch.serving import server as t_server
from dstack_tpu_torch.serving.quant import quantize_weight
from dstack_tpu_torch.serving.tokenizer import ByteTokenizer
from dstack_tpu_torch.serving.wire import PD_PHASE_HEADER

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


class _Mesh:
    """A DeviceMesh's names, sizes and device type (rank 0's view)."""

    device_type = "cpu"

    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = tuple(names), tuple(shape)

    @classmethod
    def of(cls, spec: mesh_lib.MeshSpec):
        return cls(mesh_lib.AXIS_ORDER,
                   [spec.sizes[a] for a in mesh_lib.AXIS_ORDER])


def test_engine_refuses_what_the_jax_engine_refuses():
    """A mesh without the policy's tensor axis, head counts the tensor
    degree does not divide, an expert degree that does not divide the
    experts: ValueErrors with the JAX engine's messages; a serving policy
    that shards the sequence (``seq``) or the layers (``stage``), which
    the JAX engine does not serve either, is "not yet ported"."""
    tiny = llama.LlamaConfig.tiny(dtype=torch.float32)
    kw = dict(batch_size=2, max_len=64)
    with pytest.raises(ValueError, match="lack the policy's tensor axis"):
        t_engine.InferenceEngine(tiny, mesh=_Mesh(("model",), (2,)), **kw)
    odd = dataclasses.replace(tiny, num_kv_heads=2)
    with pytest.raises(ValueError, match="head counts divisible by the "
                                         "tensor degree"):
        t_engine.InferenceEngine(odd, mesh=_Mesh.of(
            mesh_lib.MeshSpec(tensor=4)), **kw)
    three = dataclasses.replace(moe.MoEConfig.tiny_moe(dtype=torch.float32),
                                num_experts=3)
    with pytest.raises(ValueError, match="num_experts \\(3\\) divisible by "
                                         "the expert mesh degree \\(2\\)"):
        t_engine.InferenceEngine(three, mesh=_Mesh.of(
            mesh_lib.MeshSpec(expert=2)), **kw)
    for axis, policy in (
            ("seq", llama.ShardingPolicy(batch_axes=(), fsdp_axis=None,
                                         seq_axis="seq")),
            ("stage", llama.ShardingPolicy(batch_axes=(), fsdp_axis=None,
                                           stage_axis="stage"))):
        with pytest.raises(NotImplementedError,
                           match=f"over \\['{axis}'\\] is not yet ported"):
            t_engine.InferenceEngine(
                tiny, mesh=_Mesh.of(mesh_lib.MeshSpec(**{axis: 2})),
                sharding_policy=policy, **kw)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("expert_axis", ["expert", None])
def test_moe_param_specs_match_jax(tied, expert_axis):
    """Every leaf's spec, entry for entry, under the default policy and
    the serving one."""
    cfg = dataclasses.replace(moe.MoEConfig.tiny_moe(), tie_embeddings=tied)
    jcfg = dataclasses.replace(j_moe.MoEConfig.tiny_moe(),
                               tie_embeddings=tied)
    for policy, jpolicy in (
            (llama.ShardingPolicy(), JPolicy()),
            (llama.ShardingPolicy(batch_axes=(), fsdp_axis=None),
             JPolicy(batch_axes=(), fsdp_axis=None))):
        got = moe.param_specs(cfg, policy, expert_axis)
        want = j_moe.param_specs(jcfg, jpolicy, expert_axis)
        pairs = []
        llama.map_with_specs(lambda sp, w: pairs.append((tuple(sp), w)),
                             got, want)
        assert len(pairs) == 13 - tied
        for g, w in pairs:
            assert isinstance(w, P) and g == tuple(w), (g, w)


def test_row_parallel_int8_takes_the_whole_matrix_scales():
    """A rank's rows of a row-parallel weight quantized with the absmax
    reduced over the ranks (the engine's ``_absmax_reduce``) are exactly
    the whole matrix's int8 rows and scales; each shard on its own is
    not."""
    w = torch.randn(2, 64, 48, generator=torch.Generator().manual_seed(3))
    whole = quantize_weight(w)
    rows = w.chunk(4, dim=-2)
    amax = torch.stack([r.abs().amax(-2, keepdim=True) for r in rows]).amax(0)
    for i, r in enumerate(rows):
        got = quantize_weight(r, reduce=lambda a: torch.maximum(a, amax))
        assert torch.equal(got["q"], whole["q"].chunk(4, dim=-2)[i])
        assert torch.equal(got["s"], whole["s"])
    alone = quantize_weight(rows[0])
    assert not torch.equal(alone["s"], whole["s"])


class _Wire:
    """A channel in one process: what is sent is what is received."""

    rank = 1

    def __init__(self):
        self.sent = []

    def send(self, payload):
        self.sent.append(payload)

    def recv(self):
        return self.sent.pop(0)


class _Engine:
    """Device operations that record their calls and give tokens."""

    def __init__(self, first):
        self.calls, self.first = [], first

    def _do_activate(self, **args):
        self.calls.append(("activate", args))
        return self.first

    def _do_window(self, **args):
        self.calls.append(("window", args))
        return torch.tensor([[3, 4]])


def test_lockstep_round_trip_and_token_check():
    """An operation's name, host arguments (numpy arrays, lists, None)
    and checks survive encode/decode; a follower runs rank 0's operations
    in order, checks rank 0's tokens against its own (first tokens and
    windows each in their order) and stops; a token that differs raises
    LockstepError."""
    args = {"slot": 1, "padded": np.arange(6, dtype=np.int64),
            "table_row": None, "consts": ([0.0, 0.5], [1.0, 1.0], [0, 3],
                                         np.ones((2, 4), np.int32))}
    checks = [("window", [np.array([[1, 2]])])]
    op, got, back = lockstep.decode(lockstep.encode("chunk", args, checks))
    assert op == "chunk" and got["slot"] == 1 and got["table_row"] is None
    np.testing.assert_array_equal(got["padded"], args["padded"])
    np.testing.assert_array_equal(got["consts"][3], args["consts"][3])
    assert back[0][0] == "window"
    np.testing.assert_array_equal(back[0][1][0], checks[0][1][0])

    for first, ok in ((7, True), (8, False)):
        wire = _Wire()
        leader = lockstep.Leader(wire)
        leader.send("activate", {"slot": 0})
        leader.produced("first", 7)
        leader.send("window", {"window": 1})
        leader.produced("window", np.array([[3, 4]]))
        leader.stop()
        assert leader.checks_sent == 2
        follower = lockstep.Follower(wire, _Engine(first))
        if ok:
            assert follower.run() == {"ops": 2, "checked": 2}
            assert [c[0] for c in follower.engine.calls] == [
                "activate", "window"]
        else:
            with pytest.raises(lockstep.LockstepError, match="first"):
                follower.run()


def test_tensor_parallel_flag_parses_and_exits_without_cards(monkeypatch):
    """``--tensor-parallel N`` parses (1 by default) and is no longer
    refused; on the card with fewer than N visible it exits with the JAX
    server's message before starting any rank."""
    parser = t_server.build_parser()
    assert parser.parse_args([]).tensor_parallel == 1
    args = parser.parse_args(["--tensor-parallel", "4"])
    assert args.tensor_parallel == 4
    # it sets up nothing of a replica's cold start
    assert t_server.elastic_plan(args, env={}) == t_server.elastic_plan(
        parser.parse_args([]), env={})
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--tensor-parallel 4 but only 1 "
                                         "device\\(s\\) visible"):
        t_server.main(["--config", "tiny", "--tensor-parallel", "4"])
    t_server.check_tensor_parallel(4, "cpu")  # gloo ranks: any number


def _get(url, timeout=60):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _pids_with(*words) -> list:
    """Processes whose command line holds every one of ``words``."""
    pids = []
    for entry in Path("/proc").iterdir():
        try:
            argv = (entry / "cmdline").read_bytes().split(b"\0")
        except (OSError, ValueError):
            continue
        if entry.name.isdigit() and all(w.encode() in argv for w in words):
            pids.append(int(entry.name))
    return pids


def test_tensor_parallel_server_on_two_cpu_ranks(tmp_path):
    """``--tensor-parallel 2 --device cpu``: one command serves through two
    gloo ranks (the second started by the first); a completion comes back
    with its tokens; once the follower is killed, rank 0 says which rank
    exited and exits non-zero (its /health answers 503 meanwhile:
    ``test_a_lost_follower_fails_health_and_load``)."""
    port = t_server._free_port()
    log = open(tmp_path / "server.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dstack_tpu_torch.serving.server",
         "--config", "tiny", "--device", "cpu", "--tensor-parallel", "2",
         "--port", str(port), "--batch-size", "2", "--max-len", "128"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    base = f"http://127.0.0.1:{port}"
    try:
        for _ in range(240):
            try:
                if _get(base + "/health", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            assert proc.poll() is None, (tmp_path / "server.log").read_text()
            time.sleep(0.5)
        req = urllib.request.Request(
            base + "/v1/completions", method="POST",
            data=json.dumps({"prompt": "hello", "max_tokens": 6}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert body["usage"]["completion_tokens"] == 6
        follower = [pid for pid in _pids_with("--follower", str(port))
                    if pid != proc.pid]
        assert len(follower) == 1, follower
        os.kill(follower[0], 9)
        code = proc.wait(timeout=60)
        assert code != 0
        assert "tensor-parallel rank 1 exited" in (
            tmp_path / "server.log").read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def _tp_server(tmp_path, name, *flags):
    """A ``--tensor-parallel 2 --device cpu`` server of the tiny config
    (two gloo ranks): (process, base URL, its log's path)."""
    port = t_server._free_port()
    log_path = tmp_path / f"{name}.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dstack_tpu_torch.serving.server",
             "--config", "tiny", "--device", "cpu", "--tensor-parallel", "2",
             "--port", str(port), "--batch-size", "2", "--max-len", "128",
             *flags],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, "OMP_NUM_THREADS": "1"})
    return proc, f"http://127.0.0.1:{port}", log_path


def _wait_healthy(proc, base, log_path):
    for _ in range(240):
        try:
            if _get(base + "/health", timeout=5)[0] == 200:
                return
        except OSError:
            pass
        assert proc.poll() is None, log_path.read_text()
        time.sleep(0.5)
    raise AssertionError(f"{base} not healthy:\n{log_path.read_text()}")


def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, method="POST", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_tensor_parallel_server_answers_both_pd_legs(tmp_path):
    """``--tensor-parallel 2 --device cpu`` takes the router's two legs:
    the prefill leg answers a prefill_result with every KV head (each
    rank's gathered), and the decode leg carrying it answers 200 with the
    tokens of the same prompt served colocated.  Prefill legs sent while
    a completion decodes run between the engine thread's operations (one
    lock orders what rank 0 sends): all answer alike, and the followers
    stay in lockstep."""
    proc, base, log_path = _tp_server(tmp_path, "pd")
    body = {"prompt": "abcabcabcabc", "max_tokens": 6,
            "return_token_ids": True}
    try:
        _wait_healthy(proc, base, log_path)
        status, result = _post(base + "/v1/completions", body,
                               {PD_PHASE_HEADER: "prefill"})
        cfg = llama.LlamaConfig.tiny()
        assert status == 200 and result["object"] == "prefill_result"
        assert result["kv_k"]["shape"] == [
            cfg.num_layers, result["length"], cfg.num_kv_heads, cfg.head_dim]
        status, decoded = _post(base + "/v1/completions",
                                dict(body, prefill_result=result),
                                {PD_PHASE_HEADER: "decode"})
        assert status == 200
        _, colocated = _post(base + "/v1/completions", body)
        tokens = decoded["choices"][0]["token_ids"]
        assert len(tokens) == 6
        assert tokens == colocated["choices"][0]["token_ids"]
        answers = [None] * 5

        def call(i):
            headers = {PD_PHASE_HEADER: "prefill"} if i else None
            answers[i] = _post(base + "/v1/completions",
                               dict(body, max_tokens=48), headers)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert all(a is not None and a[0] == 200 for a in answers)
        assert len(answers[0][1]["choices"][0]["token_ids"]) == 48
        assert all(a[1] == answers[1][1] for a in answers[2:])
        assert _get(base + "/health")[0] == 200
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def test_tensor_parallel_replica_serves_weights_rank_0_pulled(tmp_path):
    """``--weight-peers`` under ``--tensor-parallel 2``: rank 0 pulls the
    seeder's snapshot before it starts its follower, and both ranks serve
    it.  Its greedy tokens equal those of a two-rank server that draws
    the same weights from the seeder's seed; a rank that kept its own
    seed's shards would give others."""
    seed_params = llama.init_params(llama.LlamaConfig.tiny(), "cpu",
                                    torch.Generator().manual_seed(3))
    ckpt.write_snapshot(tmp_path / "seed", ckpt.snapshot_train_state(
        seed_params), 0)
    seeder = t_server.ServingApp(
        t_engine.InferenceEngine(llama.LlamaConfig.tiny(), batch_size=1,
                                 max_len=64, device="cpu"),
        ByteTokenizer(), snapshot_dir=str(tmp_path / "seed"))
    http = seeder.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=http.serve_forever, daemon=True)
    thread.start()
    peer = f"http://127.0.0.1:{http.server_address[1]}"
    servers = [_tp_server(tmp_path, "drawn", "--seed", "3"),
               _tp_server(tmp_path, "pulled", "--seed", "4",
                          "--weight-peers", peer, "--snapshot-dir",
                          str(tmp_path / "pulled"))]
    try:
        tokens = []
        for proc, base, log_path in servers:
            _wait_healthy(proc, base, log_path)
            req = urllib.request.Request(
                base + "/v1/completions", method="POST",
                data=json.dumps({"prompt": "hello", "max_tokens": 6,
                                 "return_token_ids": True}).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                tokens.append(json.loads(r.read())["choices"][0][
                    "token_ids"])
        assert len(tokens[0]) == 6 and tokens[1] == tokens[0]
        stats = _get(servers[1][1] + "/stats")[1]
        assert stats["weight_pull"]["source"] == "peer"
    finally:
        for proc, _, _ in servers:
            proc.terminate()
        for proc, _, _ in servers:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        http.shutdown()
        http.server_close()
        thread.join(timeout=10)


class _Exited:
    def __init__(self, code):
        self.code, self.killed = code, False

    def poll(self):
        return self.code

    def kill(self):
        self.killed, self.code = True, -9


def test_a_lost_follower_fails_health_and_load():
    """``watch_followers``: a follower that exits turns /health and /load
    into 503 naming the rank, kills the followers still running, then
    ends rank 0 with a non-zero code."""
    engine = t_engine.InferenceEngine(llama.LlamaConfig.tiny(), device="cpu",
                                      batch_size=2, max_len=64)
    app = t_server.ServingApp(engine, t_server.load_tokenizer(None))
    assert app.health(None).status == 200
    codes, alive = [], _Exited(None)
    t_server.watch_followers(app, [alive, _Exited(-9)],
                             exit_fn=codes.append, poll_s=0.01).join(10)
    assert codes == [1] and alive.killed
    for route in (app.health, app.load):
        resp = route(None)
        assert resp.status == 503
        assert b"tensor-parallel rank 2 exited with code -9" in resp.body


def _failing_rank(rank, port, queue):
    """One rank of a two-rank gloo world serving the tiny model at
    tensor=2: rank 0 drives ``run_forever`` under a ServingApp whose
    window operation raises on rank 0 alone; rank 1 follows."""
    import torch.distributed as dist

    from dstack_tpu_torch.parallel import distributed as dist_lib

    torch.set_num_threads(1)
    os.environ.update(DSTACK_MASTER_NODE_IP="127.0.0.1",
                      DSTACK_NODES_NUM="1", DSTACK_NODE_RANK="0",
                      DSTACK_GPUS_PER_NODE="2", LOCAL_RANK=str(rank),
                      DSTACK_COORDINATOR_PORT=str(port))
    os.environ.pop("DSTACK_GPUS_NUM", None)
    try:
        assert dist_lib.initialize(device="cpu")
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(tensor=2), "cpu")
        engine = t_engine.InferenceEngine(
            llama.LlamaConfig.tiny(dtype=torch.float32), mesh=mesh,
            batch_size=2, max_len=64, paged=True, kv_block_size=8)
        if rank == 1:
            try:
                engine.follow()
                queue.put((1, {"follow": "returned"}))
            except Exception as e:  # noqa: BLE001 — what the test reads
                queue.put((1, {"follow": type(e).__name__}))
            return

        def planted(**args):
            raise RuntimeError("planted on rank 0")

        engine._do_window = planted
        app = t_server.ServingApp(engine, t_server.load_tokenizer(None))
        codes = []
        watch = t_server.watch_followers(app, [], exit_fn=codes.append,
                                         poll_s=0.01)
        app.start_engine()
        req = engine.submit(t_engine.Request(tokens=[1, 2, 3],
                                             max_new_tokens=4))
        done = req.done.wait(60)
        watch.join(60)
        app.join_engine(60)
        queue.put((0, {"done": done, "finish_reason": req.finish_reason,
                       "failed": engine.failed, "codes": codes,
                       "engine_alive": app._thread.is_alive(),
                       "health": app.health(None).status,
                       "load": app.load(None).status}))
    except BaseException:  # noqa: BLE001 — reported to the test process
        queue.put((rank, {"error": traceback.format_exc()}))
    finally:
        if rank == 0:
            queue.close()
            queue.join_thread()
            os._exit(0)  # leave as a failed rank 0 does: no goodbye


def test_a_step_failing_on_rank_0_alone_stops_the_replica():
    """A sharded engine whose operation raises on rank 0 only (the
    follower then waits in that operation's collective) does not recover
    in place: the in-flight request fails, the engine loop ends with
    ``failed`` set, /health and /load answer 503, the watch ends rank 0
    with code 1, and the follower's loop raises once rank 0 is gone."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_failing_rank, args=(r, port, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=120) for _ in range(2))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    errors = [r["error"] for r in results.values() if "error" in r]
    assert not errors, "\n".join(errors)
    lead = results[0]
    assert lead["done"] and lead["finish_reason"] == "error"
    assert "planted on rank 0" in lead["failed"]
    assert lead["codes"] == [1] and not lead["engine_alive"]
    assert lead["health"] == lead["load"] == 503
    assert results[1]["follow"] not in ("returned", None)
