"""The port's OpenAI-compatible server, tiny config on the CPU, driven over
real HTTP on 127.0.0.1 (port 0), plus its command line's refusals."""

import json
import threading
import urllib.request

import pytest
import torch

from dstack_tpu_torch.models.llama import LlamaConfig
from dstack_tpu_torch.serving import server as t_server
from dstack_tpu_torch.serving.engine import InferenceEngine
from dstack_tpu_torch.serving.tokenizer import ByteTokenizer
from dstack_tpu_torch.serving.wire import LOAD_ACTIVE_HEADER, TRACE_ID_HEADER
from dstack_tpu_torch.telemetry.exposition import parse
from dstack_tpu_torch.telemetry.serving import EngineTelemetry
from dstack_tpu_torch.telemetry.tracing import RequestTracer

# tiny shapes gain nothing from intra-op threads, and the suite runs
# several test processes at once
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def base_url():
    engine = InferenceEngine(
        LlamaConfig.tiny(dtype=torch.float32), batch_size=2, max_len=128,
        paged=True, kv_block_size=16, prefill_chunk=512, device="cpu",
        telemetry=EngineTelemetry(tracer=RequestTracer()))
    app = t_server.ServingApp(engine, ByteTokenizer(), model_name="tiny")
    app.start_engine()
    server = app.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    engine.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, resp.headers, resp.read()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.headers, resp.read()


def test_health_and_models(base_url):
    status, _, body = _get(base_url + "/health")
    assert status == 200 and json.loads(body) == {"status": "ok",
                                                  "model": "tiny"}
    _, _, body = _get(base_url + "/v1/models")
    assert json.loads(body)["data"][0]["id"] == "tiny"


def test_completion(base_url):
    status, headers, body = _post(base_url + "/v1/completions",
                                  {"prompt": "hello there", "max_tokens": 5})
    out = json.loads(body)
    assert status == 200
    assert out["usage"]["completion_tokens"] == 5
    assert out["choices"][0]["finish_reason"] == "length"
    assert headers.get(LOAD_ACTIVE_HEADER) is not None
    assert len(headers.get(TRACE_ID_HEADER)) == 32


def test_streaming_completion(base_url):
    status, headers, body = _post(
        base_url + "/v1/completions",
        {"prompt": "stream me", "max_tokens": 6, "stream": True})
    assert status == 200
    assert headers.get("Content-Type") == "text/event-stream"
    events = [line[len("data: "):] for line in body.decode().split("\n\n")
              if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    final = json.loads(events[-2])
    assert final["choices"][0]["finish_reason"] == "length"
    assert final["object"] == "text_completion"


def test_chat_completion(base_url):
    status, _, body = _post(
        base_url + "/v1/chat/completions",
        {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4})
    out = json.loads(body)
    assert status == 200
    assert out["object"] == "chat.completion"
    assert out["choices"][0]["message"]["role"] == "assistant"
    assert out["usage"]["completion_tokens"] == 4


def test_metrics_parse_strict_and_stats(base_url):
    _post(base_url + "/v1/completions", {"prompt": "x", "max_tokens": 3})
    _, _, body = _get(base_url + "/metrics")
    samples = parse(body.decode(), strict=True)
    names = {s.name for s in samples}
    assert "dstack_serving_ttft_seconds_bucket" in names
    assert "dstack_serving_decode_tokens_total" in names
    _, _, body = _get(base_url + "/stats")
    stats = json.loads(body)
    assert stats["decode_steps"] > 0
    assert stats["num_layers"] == 2
    # CPU tensors take the plain version: no kernel launch is counted
    assert stats["kernels"]["paged_decode_attention"]["launches"] == 0
    _, _, body = _get(base_url + "/load")
    assert json.loads(body)["capacity_slots"] == 2


def test_bad_json_is_a_400(base_url):
    req = urllib.request.Request(base_url + "/v1/completions", data=b"{",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=60)
    assert err.value.code == 400


@pytest.mark.parametrize("flags", [
    ["--tensor-parallel", "2"],
    ["--prefix-cache"],
    ["--speculation", "ngram"],
    ["--speculation-k", "2"],
    ["--kv-quantize", "int4"],
    ["--checkpoint", "ckpt"],
    ["--compile-cache", "cache"],
    ["--compile-cache-peers", "http://peer"],
    ["--snapshot-dir", "snap"],
    ["--weight-peers", "http://peer"],
    ["--seed-rate-bps", "100"],
    ["--standby"],
])
def test_unported_flags_exit_nonzero(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        t_server.main(["--config", "tiny", "--device", "cpu", *flags])
    assert exc.value.code != 0
    assert "not yet ported" in capsys.readouterr().err


def test_server_without_cuda_refuses_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_server.main(["--config", "tiny"])
