"""The port's replica cold start against the JAX package's, on the CPU.

Snapshots stream both ways, bitwise: one the JAX package publishes is
pulled by the port's ``stream_snapshot`` and read by its
``read_snapshot``; one a port server seeds is pulled by the JAX package's
``stream_snapshot`` over real HTTP on 127.0.0.1 and read by its
``read_snapshot``.  Then two port servers on loopback: B, a standby
started through the server's own startup (``start_replica``, what
``main`` runs), pulls A's weights with a cold fallback that fails the
test if called, refuses /v1 until activated, and then answers with the
JAX engine's greedy tokens on the same weights, token for token.

Three tests, one JAX program family (a dense engine's prefill and decode
window on the tiny config in f32): the file stays out of the early
window of the dtlint scan guard (see ROADMAP.md, "The port's tests stay
light").  Weights are drawn with numpy in the JAX package's layout and
passed to the port through ``params_from_jax``.
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.elastic import weight_stream as j_stream
from dstack_tpu.models import checkpoint as j_ckpt
from dstack_tpu.models.llama import LlamaConfig as JConfig
from dstack_tpu.serving import engine as j_engine
from dstack_tpu_torch.elastic import stream_snapshot
from dstack_tpu_torch.models import checkpoint as ckpt
from dstack_tpu_torch.models import llama
from dstack_tpu_torch.models.llama import LlamaConfig, params_from_jax
from dstack_tpu_torch.serving import server as t_server
from dstack_tpu_torch.serving.engine import InferenceEngine
from dstack_tpu_torch.serving.tokenizer import ByteTokenizer

torch.set_num_threads(1)

PROMPT = "elastic replicas"  # 17 byte ids: one prefill bucket
NEW_TOKENS = 8


def _np_params(jcfg, seed):
    """``init_params``'s tree (shapes, fan-in scales, unit norms), drawn
    with numpy in the model's dtype."""
    rng = np.random.default_rng(seed)
    d, f, n = jcfg.hidden_size, jcfg.intermediate_size, jcfg.num_layers
    dtype = np.dtype(jcfg.dtype)

    def dense(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(dtype)

    return {
        "embed": dense((jcfg.vocab_size, d), d),
        "layers": {
            "attn_norm": np.ones((n, d), dtype),
            "wq": dense((n, d, jcfg.q_dim), d),
            "wk": dense((n, d, jcfg.kv_dim), d),
            "wv": dense((n, d, jcfg.kv_dim), d),
            "wo": dense((n, jcfg.q_dim, d), jcfg.q_dim),
            "mlp_norm": np.ones((n, d), dtype),
            "w_gate": dense((n, d, f), d),
            "w_up": dense((n, d, f), d),
            "w_down": dense((n, f, d), f),
        },
        "final_norm": np.ones((d,), dtype),
        "lm_head": dense((d, jcfg.vocab_size), d),
    }


def _raw(x) -> bytes:
    """The bytes of a leaf, torch or numpy (bf16 included)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _leaves(tree):
    return [leaf for _, leaf in ckpt._tree_items(tree, "")]


def _fs_fetch(src):
    def fetch(url):
        name = url.rsplit("/", 1)[1]
        path = src / ("manifest.json" if name == "manifest" else name)
        with open(path, "rb") as f:
            while block := f.read(1 << 16):
                yield block

    return fetch


class _Served:
    """A ServingApp's HTTP server on 127.0.0.1 (port 0) on a thread."""

    def __init__(self, app):
        self.app = app
        self.server = app.make_server("127.0.0.1", 0)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.app.engine.stop()
        self.app.join_engine(timeout=30)
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def test_jax_snapshot_streams_into_the_port(tmp_path):
    """The JAX package publishes its engine's bf16 params; the port pulls
    the snapshot (chunked, sha256-checked) and reads it bitwise."""
    jcfg = JConfig.tiny()
    np_tree = _np_params(jcfg, seed=3)
    jparams = jax.tree.map(jnp.asarray, np_tree)
    j_ckpt.write_snapshot(tmp_path / "jax", j_ckpt.snapshot_train_state(
        jparams), 5, process_index=0, num_processes=1)
    dest = tmp_path / "port"
    assert stream_snapshot("http://jax-replica:8000", dest,
                           fetch=_fs_fetch(tmp_path / "jax" /
                                           "step_00000005")) == 5
    cfg = LlamaConfig.tiny()
    params, step = ckpt.read_snapshot(
        dest, llama.init_params(cfg, "meta", None), verify=True,
        device="cpu")
    assert step == 5
    want = params_from_jax(np_tree, "cpu", torch.bfloat16)
    got_leaves, want_leaves = _leaves(params), _leaves(want)
    assert len(got_leaves) == len(want_leaves) == 12
    for got, exp in zip(got_leaves, want_leaves):
        assert got.dtype == torch.bfloat16 and got.shape == exp.shape
        assert _raw(got) == _raw(exp)


def test_jax_stream_snapshot_pulls_from_a_port_server(tmp_path):
    """A port server seeds its published snapshot; the JAX package's
    stream_snapshot pulls it with its own urllib fetch and its
    read_snapshot gives the port's bf16 params back bitwise."""
    cfg = LlamaConfig.tiny()
    params = llama.init_params(cfg, "cpu", torch.Generator().manual_seed(9))
    ckpt.write_snapshot(tmp_path / "seed", ckpt.snapshot_train_state(params),
                        7)
    engine = InferenceEngine(LlamaConfig.tiny(dtype=torch.float32),
                             batch_size=1, max_len=64, device="cpu")
    served = _Served(t_server.ServingApp(engine, ByteTokenizer(),
                                         snapshot_dir=str(tmp_path / "seed")))
    try:
        assert j_stream.stream_snapshot(served.base, tmp_path / "jax") == 7
    finally:
        served.close()
    template = _np_params(JConfig.tiny(), seed=0)
    restored, step = j_ckpt.read_snapshot(tmp_path / "jax", template,
                                          verify=True)
    assert step == 7
    got = [leaf for _, leaf in ckpt._tree_items(restored, "")]
    want = _leaves(params)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g.dtype == jnp.bfloat16 and tuple(g.shape) == tuple(w.shape)
        assert _raw(g) == _raw(w)


def test_standby_replica_pulls_its_weights_from_a_peer(tmp_path):
    """B, a standby started as main starts it, pulls A's published weights
    (the cold fallback would fail the test), answers 503 until activated,
    and then serves the JAX engine's greedy tokens on those weights.  B's
    own seed differs from the weights': only the pulled weights give
    these tokens."""
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32)
    np_tree = _np_params(jcfg, seed=0)
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    a_params = params_from_jax(np_tree, "cpu", torch.float32)
    ckpt.write_snapshot(tmp_path / "a", ckpt.snapshot_train_state(a_params),
                        0)
    a_engine = InferenceEngine(cfg, params=a_params, batch_size=2,
                               max_len=128, device="cpu")
    a = _Served(t_server.ServingApp(a_engine, ByteTokenizer(),
                                    snapshot_dir=str(tmp_path / "a")))
    args = t_server.build_parser().parse_args([
        "--config", "tiny", "--device", "cpu", "--paged", "--batch-size",
        "2", "--max-len", "128", "--kv-block-size", "16", "--seed", "1",
        "--snapshot-dir", str(tmp_path / "b"), "--weight-peers", a.base,
        "--standby"])
    b = None
    try:
        app = t_server.start_replica(
            args, cfg, None, ByteTokenizer(), "tiny",
            cold_fallback=lambda: pytest.fail("cold weight read happened"))
        b = _Served(app)
        assert app.weight_pull["source"] == "peer"
        assert app.weight_pull["peer"] == a.base
        deadline = time.monotonic() + 120
        while app.warming:
            assert time.monotonic() < deadline, "warmup did not end"
            time.sleep(0.05)
        status, headers, _ = _http(b.base + "/v1/completions",
                                   {"prompt": PROMPT, "max_tokens": 1})
        assert status == 503 and headers["Retry-After"] == "2"
        assert _http(b.base + "/elastic/standby/activate", {})[0] == 200
        status, _, body = _http(b.base + "/v1/completions", {
            "prompt": PROMPT, "max_tokens": NEW_TOKENS,
            "return_token_ids": True})
        assert status == 200
        tokens = body["choices"][0]["token_ids"]
        stats = _http(b.base + "/stats")[2]
        assert stats["weight_pull"]["source"] == "peer"
    finally:
        a.close()
        if b is not None:
            b.close()
    ids = ByteTokenizer().encode(PROMPT)
    engine = j_engine.InferenceEngine(jcfg, params=jax.tree.map(
        jnp.asarray, np_tree), batch_size=2,
                                      max_len=128)
    want = engine.generate(ids, max_new_tokens=NEW_TOKENS,
                           eos_id=ByteTokenizer.eos_id).output
    assert tokens == list(want)


def _http(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, method="GET" if payload is None else "POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, err.headers, json.loads(err.read())
