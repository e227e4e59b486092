"""The port's OpenAI-compatible server, tiny config on the CPU, driven over
real HTTP on 127.0.0.1 (port 0), plus its command line's refusals."""

import dataclasses
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
    ["--tensor-parallel", "2", "--standby"],
    ["--checkpoint", "ckpt", "--snapshot-dir", "snap"],
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


def _hf_checkpoint(path):
    """A one-layer tied HF Llama checkpoint of the tiny shape (random bf16
    weights, [out, in] layout, safetensors), and its config."""
    st = pytest.importorskip("safetensors.torch")
    cfg = dataclasses.replace(LlamaConfig.tiny(tie_embeddings=True),
                              num_layers=1)
    g = torch.Generator().manual_seed(0)
    d, f, p = cfg.hidden_size, cfg.intermediate_size, "model.layers.0."
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, d),
              "model.norm.weight": (d,), p + "input_layernorm.weight": (d,),
              p + "post_attention_layernorm.weight": (d,),
              p + "self_attn.q_proj.weight": (cfg.q_dim, d),
              p + "self_attn.k_proj.weight": (cfg.kv_dim, d),
              p + "self_attn.v_proj.weight": (cfg.kv_dim, d),
              p + "self_attn.o_proj.weight": (d, cfg.q_dim),
              p + "mlp.gate_proj.weight": (f, d),
              p + "mlp.up_proj.weight": (f, d),
              p + "mlp.down_proj.weight": (d, f)}
    path.mkdir()
    st.save_file({n: torch.randn(s, generator=g).to(torch.bfloat16)
                  for n, s in shapes.items()},
                 str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "vocab_size": cfg.vocab_size, "hidden_size": d,
        "intermediate_size": f, "num_hidden_layers": 1,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_eps,
        "max_position_embeddings": cfg.max_seq_len,
        "tie_word_embeddings": True}))
    return cfg


def test_checkpoint_loads_config_weights_and_tokenizer(tmp_path,
                                                       monkeypatch):
    """--checkpoint takes the model's config and weights (stacked, [in,
    out], on --device) and asks for the tokenizer in the same directory
    (a stand-in answers: loading an HF tokenizer is transformers' work)."""
    path = tmp_path / "tiny-hf"
    want = _hf_checkpoint(path)
    asked = []

    class WordTokenizer:
        vocab_size, bos_id, eos_id = 300, 298, 299

        def encode(self, text):
            return [self.bos_id] + [len(w) for w in text.split()]

    def load_tokenizer(name):
        asked.append(name)
        return WordTokenizer()

    monkeypatch.setattr(t_server, "load_tokenizer", load_tokenizer)
    args = t_server.build_parser().parse_args(
        ["--checkpoint", str(path), "--device", "cpu"])
    assert t_server.unported_flags(args) == []
    cfg, params, tokenizer, name = t_server.load_model(args)
    assert asked == [str(path)] and isinstance(tokenizer, WordTokenizer)
    assert cfg == want and name == "tiny-hf"
    assert params["layers"]["wq"].shape == (1, cfg.hidden_size, cfg.q_dim)
    assert params["embed"].device.type == "cpu"
    engine = InferenceEngine(cfg, params=params, batch_size=1, max_len=64,
                             device="cpu")
    req = engine.generate(tokenizer.encode("a few words"),
                          max_new_tokens=3)
    assert len(req.output) == 3
    assert all(0 <= t < cfg.vocab_size for t in req.output)


def test_checkpoint_without_a_tokenizer_is_refused(tmp_path, monkeypatch):
    """Real weights with the byte fallback (what load_tokenizer returns
    when no HF tokenizer loads) would serve fluent-looking garbage: the
    server exits instead."""
    path = tmp_path / "no-tok"
    _hf_checkpoint(path)
    monkeypatch.setattr(t_server, "load_tokenizer",
                        lambda name: ByteTokenizer())
    with pytest.raises(SystemExit,
                       match="could not load a tokenizer .*--tokenizer"):
        t_server.main(["--checkpoint", str(path), "--device", "cpu"])
