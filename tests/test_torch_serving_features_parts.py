"""The port's serving features, the cases that need no JAX program: int4
KV rows, the prefill/decode (PD) wire codec against the JAX server's,
prefix-cache bookkeeping, drain, speculation's plain-window path, a PD
install cut to the engine's room, and the HTTP replica (both PD legs,
/drain, /traces, the speculation blocks, the flags reaching the engine)
on the tiny config on the CPU.

The features' parity with the JAX engine is
``test_torch_serving_features.py``; this file compiles no JAX program, so
it may hold many tests.
"""

import json
import threading
import urllib.error
import urllib.request

import ml_dtypes
import numpy as np
import pytest
import torch

from dstack_tpu.serving import server as j_server
from dstack_tpu_torch.models.llama import LlamaConfig
from dstack_tpu_torch.serving import engine as t_engine
from dstack_tpu_torch.serving import server as t_server
from dstack_tpu_torch.serving.quant import dequantize_kv4, quantize_kv4
from dstack_tpu_torch.serving.tokenizer import ByteTokenizer
from dstack_tpu_torch.serving.wire import PD_PHASE_HEADER, TRACE_ID_HEADER
from dstack_tpu_torch.telemetry.serving import EngineTelemetry
from dstack_tpu_torch.telemetry.tracing import RequestTracer

CFG = LlamaConfig.tiny(dtype=torch.float32)
ENGINE_KW = dict(batch_size=2, max_len=64, device="cpu")
PREFIX_KW = dict(paged=True, kv_block_size=8, prefix_cache=True)

# tiny shapes gain nothing from intra-op threads, and the suite runs
# several test processes at once
torch.set_num_threads(1)


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    for _ in range(400):
        if all(r.done.is_set() for r in reqs):
            break
        engine.step()
    assert all(r.done.is_set() for r in reqs)
    return [r.output for r in reqs]


# -- int4 KV rows --------------------------------------------------------------


def test_quantize_kv4_round_trip_keeps_signs():
    """JAX's test_kv_quant_int4_negative_values_roundtrip_sign: values on
    the int4 grid come back exactly, negatives included."""
    x = torch.tensor([[-7.0, 7.0, -3.0, 0.0, 1.0, -1.0, 5.0, -5.0]])
    q4, s = quantize_kv4(x)
    assert tuple(q4.shape) == (1, 4)
    torch.testing.assert_close(dequantize_kv4(q4, s, torch.float32), x,
                               atol=1e-5, rtol=0)


def test_quantize_kv4_refuses_odd_head_dim():
    with pytest.raises(ValueError, match="even head_dim"):
        quantize_kv4(torch.ones(2, 5))


# -- the PD wire codec -----------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8", "int32"])
def test_wire_codec_cross_decodes_with_jax(dtype):
    """The port's encoding decodes bitwise through the JAX server's
    ``_arr_from_wire``, and the JAX server's encoding through the port's
    (bf16 as raw 2-byte words)."""
    rng = np.random.default_rng(5)
    values = rng.standard_normal((3, 5, 2, 4)) * 50
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    arr = values.astype(np_dtype)
    t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
        if dtype == "bfloat16" else torch.from_numpy(arr)
    wire = t_server._arr_to_wire(t)
    assert wire["dtype"] == dtype and wire["shape"] == [3, 5, 2, 4]
    back = j_server._arr_from_wire(json.loads(json.dumps(wire)))
    assert back.dtype == arr.dtype
    assert back.tobytes() == arr.tobytes()
    got = t_server._arr_from_wire(j_server._arr_to_wire(arr))
    assert got.dtype == t.dtype and torch.equal(got, t)


# -- engine bookkeeping ----------------------------------------------------


def test_prefix_blocks_park_for_reuse_and_count_as_used():
    """A finished prompt's full blocks park in the allocator (not freed)
    and count as used KV; the next request with the same prefix takes
    them and prefills only its suffix, which is all the telemetry counts;
    a reset drops every cached block."""
    tel = EngineTelemetry()
    engine = t_engine.InferenceEngine(CFG, telemetry=tel, **ENGINE_KW,
                                      **PREFIX_KW)
    prompt = list(range(10, 30))                    # two full blocks + 4
    engine.generate(prompt, max_new_tokens=4)
    alloc = engine._alloc
    assert len(alloc._lru) == 2 and alloc.free_blocks == alloc.num_blocks - 3
    assert engine._kv_used_fraction() == pytest.approx(
        2 / (alloc.num_blocks - 1))
    before = tel.prefill_tokens.value
    engine.generate(prompt + [7], max_new_tokens=4)
    assert alloc.stats["hit_blocks"] == 2
    assert tel.prefill_tokens.value - before == 5
    engine._reset_device_state()
    assert alloc.available_blocks == alloc.free_blocks == alloc.num_blocks - 1


def test_drain_and_end_drain():
    engine = t_engine.InferenceEngine(CFG, **ENGINE_KW)
    assert not engine.drained
    req = engine.submit(t_engine.Request(tokens=[1, 2, 3], max_new_tokens=3))
    engine.begin_drain()
    assert not engine.drained  # a request is still queued
    with pytest.raises(t_engine.EngineDraining):
        engine.submit(t_engine.Request(tokens=[1]))
    while not req.done.is_set():
        engine.step()
    assert engine.drained and len(req.output) == 3
    engine.end_drain()
    assert not engine.drained and not engine.draining
    assert len(engine.generate([4, 5], max_new_tokens=2).output) == 2


def test_sampled_windows_take_the_plain_path():
    """With a sampled request in the batch a speculative engine runs the
    plain window: no verification step is counted.  Greedy alone, every
    decoding slot's step is, and the telemetry counts the same."""
    tel = EngineTelemetry()
    engine = t_engine.InferenceEngine(CFG, speculation="ngram", telemetry=tel,
                                      **ENGINE_KW)
    _run(engine, [t_engine.Request(tokens=[3, 4, 3, 4], max_new_tokens=6,
                                   temperature=1.0)])
    assert engine.spec_stats == {"steps": 0, "accepted": 0}
    _run(engine, [t_engine.Request(tokens=[3, 4, 3, 4, 3, 4],
                                   max_new_tokens=6)])
    assert engine.spec_stats["steps"] > 0
    assert (tel.spec_steps.value, tel.spec_accepted.value) == (
        engine.spec_stats["steps"], engine.spec_stats["accepted"])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_pd_install_keeps_the_newest_rows_that_fit(paged):
    """A prefill made with a larger max_len: the install keeps the newest
    max_len - 2 rows (padded to whole blocks when paged), which leave room
    for the first token only, sampled from the shipped logits."""
    kw = dict(paged=True, kv_block_size=8) if paged else {}
    big = t_engine.InferenceEngine(CFG, batch_size=1, max_len=128,
                                   device="cpu")
    prompt = [(i * 5 + 1) % 500 for i in range(70)]
    exp = big.prefill_export(prompt, max_new_tokens=4)
    assert exp["length"] == 70
    engine = t_engine.InferenceEngine(CFG, **ENGINE_KW, **kw)
    installed = []
    install = engine._install_rows
    engine._install_rows = lambda slot, ks, vs, *blocks: (
        installed.append(ks), install(slot, ks, vs, *blocks))
    req = t_engine.Request(tokens=prompt, max_new_tokens=4, prefill=exp)
    assert engine._prompt_len(req) == 62
    assert _run(engine, [req]) == [[exp["first_token"]]]
    (ks,) = installed
    assert ks.shape[1] == (64 if paged else 62)
    torch.testing.assert_close(ks[:, :62], exp["ks"][:, 8:], rtol=0, atol=0)


# -- the HTTP replica ------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """A dense speculative replica with telemetry and tracing on."""
    engine = t_engine.InferenceEngine(
        CFG, speculation="ngram", speculation_k=2, prefill_chunk=512,
        telemetry=EngineTelemetry(tracer=RequestTracer()), batch_size=2,
        max_len=128, device="cpu")
    app = t_server.ServingApp(engine, ByteTokenizer(), model_name="tiny")
    app.start_engine()
    server = app.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", engine
    server.shutdown()
    server.server_close()
    engine.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _call(url, payload=None, headers=None):
    """(status, headers, JSON body); an HTTP error's too."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, method="GET" if payload is None else "POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, err.headers, json.loads(err.read())


@pytest.mark.parametrize("path, body", [
    ("/v1/completions", {"prompt": "abcabcabcabc"}),
    ("/v1/chat/completions",
     {"messages": [{"role": "user", "content": "abcabcabc"}]}),
], ids=["completions", "chat"])
def test_pd_legs_over_http(served, path, body):
    """The prefill leg answers a prefill_result and takes no slot; the
    decode leg, sent the result, answers what a colocated request does."""
    base, engine = served
    body = dict(body, max_tokens=6)
    status, _, result = _call(base + path, body, {PD_PHASE_HEADER: "prefill"})
    assert status == 200 and result["object"] == "prefill_result"
    n = result["length"]
    assert result["kv_k"]["shape"] == [CFG.num_layers, n, CFG.num_kv_heads,
                                       CFG.head_dim]
    assert result["kv_k"]["dtype"] == "float32"
    assert result["logits"]["shape"] == [CFG.vocab_size]
    status, _, decoded = _call(base + path,
                               dict(body, prefill_result=result),
                               {PD_PHASE_HEADER: "decode"})
    assert status == 200
    _, _, colocated = _call(base + path, body)
    assert decoded["usage"] == colocated["usage"]
    assert decoded["choices"] == colocated["choices"]


def test_drain_over_http(served):
    base, _ = served
    try:
        status, _, out = _call(base + "/drain", {})
        assert status == 200 and out["status"] == "draining"
        assert _call(base + "/health")[2]["status"] == "draining"
        status, headers, _ = _call(base + "/v1/completions",
                                   {"prompt": "x", "max_tokens": 2})
        assert status == 503 and headers["Retry-After"] == "1"
        # nothing in flight: drained at once
        assert _call(base + "/drain", {})[2] == {"status": "draining",
                                                 "drained": True}
    finally:
        status, _, out = _call(base + "/drain", {"drain": False})
    assert status == 200 and out == {"status": "accepting", "drained": False}
    assert _call(base + "/v1/completions",
                 {"prompt": "x", "max_tokens": 2})[0] == 200


def test_traces_over_http(served):
    base, _ = served
    _, headers, _ = _call(base + "/v1/completions",
                          {"prompt": "trace me", "max_tokens": 3})
    trace_id = headers[TRACE_ID_HEADER]
    status, _, summary = _call(base + "/traces")
    assert status == 200
    assert trace_id in {t["trace_id"] for t in summary["traces"]}
    status, _, detail = _call(base + "/traces/" + trace_id)
    assert status == 200 and detail["trace_id"] == trace_id
    names = {s["name"] for s in detail["spans"]}
    assert {"replica.request", "engine.request", "engine.decode"} <= names
    status, _, out = _call(base + "/traces/" + "0" * 32)
    assert status == 404 and "unknown trace" in out["detail"]


def test_traces_answer_404_when_tracing_is_off():
    engine = t_engine.InferenceEngine(CFG, **ENGINE_KW)
    app = t_server.ServingApp(engine, ByteTokenizer())
    assert app.traces(None).status == 404
    assert app.trace_detail(None).status == 404


def test_health_and_stats_carry_speculation(served):
    base, engine = served
    _call(base + "/v1/completions", {"prompt": "abababab", "max_tokens": 8})
    _, _, health = _call(base + "/health")
    _, _, stats = _call(base + "/stats")
    for block in (health["speculation"], stats["speculation"]):
        assert block["steps"] > 0
        assert block["accept_rate"] == pytest.approx(
            block["accepted"] / block["steps"])


@pytest.mark.parametrize("flags, want", [
    (["--paged", "--prefix-cache"], dict(paged=True, prefix_cache=True)),
    (["--prefix-cache"], dict(paged=True, prefix_cache=True)),
    (["--speculation", "ngram", "--speculation-k", "3"],
     dict(speculation="ngram", speculation_k=3, paged=False)),
    (["--kv-quantize", "int4"], dict(kv_quantize="int4", paged=False)),
    (["--kv-quantize", "int4", "--paged"], dict(kv_quantize="int4",
                                                paged=True)),
], ids=["paged-prefix", "prefix-implies-paged", "speculation", "int4",
        "int4-paged"])
def test_flags_reach_the_engine(flags, want):
    args = t_server.build_parser().parse_args(
        ["--config", "tiny", "--device", "cpu", "--max-len", "64",
         "--batch-size", "2", *flags])
    assert not t_server.elastic_plan(args, env={})["warm"]
    cfg, params, _, _ = t_server.load_model(args)
    engine = t_server.build_engine(args, cfg, params)
    assert {k: getattr(engine, k) for k in want} == want
    assert len(engine.generate([1, 2, 3], max_new_tokens=3).output) == 3
