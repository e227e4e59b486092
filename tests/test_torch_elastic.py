"""The port's replica cold start (``dstack_tpu_torch/elastic/``) on the CPU,
with no JAX program: the token bucket, weight streaming, the standby pool
and the compile cache of the kernels' nvcc libraries, each case the
counterpart of one of the JAX package's ``tests/compute/test_elastic.py``
and ``test_elastic_server.py``; then the engine's warmup and the server's
elastic routes, over real HTTP on 127.0.0.1.

The tests need no nvcc and no card: the compile cache's compiler and
loader are injected (the compiler writes a stand-in library and counts
its calls), and ``_build.BUILD_DIR`` points into the test's directory.
"""

import contextlib
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from dstack_tpu_torch.elastic import (
    CachedKernels,
    CompileCache,
    StandbyPool,
    TokenBucket,
    WeightStreamError,
    cache_key,
    maybe_cached,
    pull_weights,
    stream_snapshot,
    topology_fingerprint,
)
from dstack_tpu_torch.elastic import compile_cache as cc
from dstack_tpu_torch.models import checkpoint as ckpt
from dstack_tpu_torch.models import train
from dstack_tpu_torch.models.llama import LlamaConfig
from dstack_tpu_torch.ops import _build
from dstack_tpu_torch.serving import server as t_server
from dstack_tpu_torch.serving.engine import InferenceEngine
from dstack_tpu_torch.serving.tokenizer import ByteTokenizer
from dstack_tpu_torch.telemetry.serving import (
    EngineTelemetry,
    parse_load_headers,
)

torch.set_num_threads(1)


# -- token bucket --------------------------------------------------------------


def test_token_bucket_paces_with_injected_clock():
    t = [0.0]
    slept = []

    def sleep(s):
        slept.append(s)
        t[0] += s

    bucket = TokenBucket(1000.0, capacity=1000.0, clock=lambda: t[0],
                         sleep=sleep)
    assert bucket.consume(1000) == 0.0  # a full bucket passes freely
    assert bucket.consume(500) == pytest.approx(0.5)  # 0.5 s at 1000 B/s
    assert sum(slept) == pytest.approx(0.5)


def test_token_bucket_disabled_at_zero_rate():
    bucket = TokenBucket(0.0, clock=lambda: 0.0,
                         sleep=lambda s: pytest.fail("slept"))
    assert bucket.consume(10 ** 9) == 0.0


# -- weight streaming ----------------------------------------------------------


def _publish_seed(directory, step=3):
    """A published snapshot of a small tree (the port writes it)."""
    tree = {"w": torch.arange(24.0).reshape(4, 6),
            "b": torch.arange(6, dtype=torch.bfloat16)}
    ckpt.write_snapshot(directory, ckpt.snapshot_train_state(tree), step)
    return tree, directory / f"step_{step:08d}"


def _fs_fetch(src):
    """A peer's routes, read from its snapshot directory."""
    def fetch(url):
        name = url.rsplit("/", 1)[1]
        path = src / ("manifest.json" if name == "manifest" else name)
        with open(path, "rb") as f:
            while block := f.read(1 << 16):
                yield block

    return fetch


def _edited_manifest(src, **fields):
    """``src``'s manifest with ``fields`` changed (the snapshot files are
    not touched)."""
    manifest = json.loads((src / "manifest.json").read_text())
    manifest.update(fields)
    data = json.dumps(manifest).encode()
    shard = _fs_fetch(src)

    def fetch(url):
        if url.endswith("/manifest"):
            return iter([data])
        return shard(url)

    return fetch


def test_stream_snapshot_happy_path_restores(tmp_path):
    tree, src = _publish_seed(tmp_path / "seeder")
    dest = tmp_path / "joiner"
    assert stream_snapshot("http://seeder:8000", dest,
                           fetch=_fs_fetch(src)) == 3
    template = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in tree.items()}
    restored, step = ckpt.read_snapshot(dest, template, verify=True,
                                        device="cpu")
    assert step == 3
    for k, v in tree.items():
        assert restored[k].dtype == v.dtype and torch.equal(restored[k], v)
    # the streamed shard is the seeder's file, byte for byte
    assert ((dest / "step_00000003" / "host_00000.npz").read_bytes()
            == (src / "host_00000.npz").read_bytes())
    assert not list(dest.glob("*.stream-*"))


def test_stream_snapshot_refuses_corrupt_shard(tmp_path):
    _, src = _publish_seed(tmp_path / "seeder")
    shard = src / "host_00000.npz"
    shard.write_bytes(shard.read_bytes() + b"FLIP")
    dest = tmp_path / "joiner"
    with pytest.raises(WeightStreamError, match="refusing the corrupt"):
        stream_snapshot("http://seeder:8000", dest, fetch=_fs_fetch(src))
    # nothing published, nothing staged
    assert not list(dest.glob("step_*"))


def test_stream_snapshot_refuses_host_count_mismatch(tmp_path):
    """A manifest whose checksums don't cover num_processes shard files is
    a torn seeder snapshot: refused before anything is transferred."""
    _, src = _publish_seed(tmp_path / "seeder")
    dest = tmp_path / "joiner"
    with pytest.raises(WeightStreamError, match="count mismatch"):
        stream_snapshot("http://seeder:8000", dest,
                        fetch=_edited_manifest(src, num_processes=2))
    assert not dest.exists() or not list(dest.iterdir())


def test_stream_snapshot_refuses_wrong_format(tmp_path):
    _, src = _publish_seed(tmp_path / "seeder")
    dest = tmp_path / "joiner"
    with pytest.raises(WeightStreamError, match="format"):
        stream_snapshot("http://seeder:8000", dest,
                        fetch=_edited_manifest(src, format=2))
    assert not dest.exists() or not list(dest.iterdir())


def _broken_fetch(url):
    raise ConnectionError("peer down")


def test_pull_weights_falls_back_cold_after_peer_failures(tmp_path):
    calls = []

    def cold():
        calls.append(1)
        return 42

    out = pull_weights(["http://p1", "http://p2"], tmp_path / "dest",
                       cold_fallback=cold, fetch=_broken_fetch)
    assert out["source"] == "cold" and out["step"] == 42
    assert len(out["errors"]) == 2 and calls == [1]


def test_pull_weights_raises_without_cold_fallback(tmp_path):
    with pytest.raises(WeightStreamError, match="no cold fallback"):
        pull_weights(["http://p1"], tmp_path / "dest", fetch=_broken_fetch)


def test_pull_weights_prefers_first_live_peer(tmp_path):
    _, src = _publish_seed(tmp_path / "seeder")
    good = _fs_fetch(src)

    def fetch(url):
        if url.startswith("http://dead"):
            raise ConnectionError("dead peer")
        return good(url)

    out = pull_weights(["http://dead:1", "http://live:2", "http://dead:3"],
                       tmp_path / "joiner",
                       cold_fallback=lambda: pytest.fail("cold read"),
                       fetch=fetch)
    assert out["source"] == "peer" and out["peer"] == "http://live:2"
    assert out["step"] == 3 and len(out["errors"]) == 1


# -- standby pool --------------------------------------------------------------


def test_standby_pool_lifecycle_and_counts():
    t = [0.0]
    built = []

    def factory():
        t[0] += 2.5  # the cold start happens HERE, before the spike
        built.append(object())
        return built[-1]

    pool = StandbyPool(factory, size=2, clock=lambda: t[0])
    assert pool.counts() == {"warming": 0, "ready": 0, "active": 0}
    records = pool.warm()
    assert len(records) == 2 and pool.ready == 2
    assert records[0].warmup_s == pytest.approx(2.5)
    rec = pool.activate()
    assert rec is not None and rec.engine is built[0]
    assert pool.snapshot() == {"standby_size": 2, "standby_warming": 0,
                               "standby_ready": 1, "standby_active": 1}
    assert pool.activate() is not None
    assert pool.activate() is None  # exhausted
    assert pool.warm() == []  # never past its size


def test_standby_pool_background_warming_joins():
    pool = StandbyPool(lambda: "engine", size=1)
    threads = pool.warm_in_background()
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()
    assert pool.ready == 1
    assert pool.activate().engine == "engine"


def test_standby_pool_rejects_negative_size():
    with pytest.raises(ValueError):
        StandbyPool(lambda: None, size=-1)


# -- compile cache: keying and bytes -------------------------------------------


def test_cache_key_is_content_addressed():
    assert cache_key("src-a", "topo") == cache_key("src-a", "topo")
    assert cache_key("src-a", "topo") != cache_key("src-b", "topo")
    # the topology is part of the address: the same source built for
    # another card or by another nvcc must never collide
    assert cache_key("src-a", "topo-1") != cache_key("src-a", "topo-2")
    assert len(cache_key("src-a")) == 64


def test_topology_fingerprint_names_card_nvcc_and_driver(monkeypatch):
    """The card's capability and name, nvcc's version and the driver's
    CUDA version; on a host without them, the stated placeholders."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def no_libcuda(name):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    monkeypatch.setattr(cc.ctypes, "CDLL", no_libcuda)
    assert topology_fingerprint() == (
        "cuda/sm_none/no-card/nvcc-none/driver-none")
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(cc.subprocess, "run", lambda *a, **k: type(
        "Done", (), {"stdout": "Cuda compilation tools, release 12.4, "
                               "V12.4.131\nBuild cuda_12.4.r12.4\n"})())
    monkeypatch.setattr(cc, "_card", lambda: "sm_90/NVIDIA H100 80GB HBM3")
    assert topology_fingerprint() == ("cuda/sm_90/NVIDIA H100 80GB HBM3/"
                                      "nvcc-12.4.131/driver-none")


def test_key_for_follows_the_library_sources(monkeypatch):
    cache = CompileCache()
    assert cache.key_for("paged_decode") == cache_key(
        _build.source_digest("paged_decode"), topology_fingerprint())
    assert cache.key_for("flash_fwd") != cache.key_for("flash_bwd")
    assert _build.library_path("flash_fwd").name == (
        f"flash_fwd-{_build.source_digest('flash_fwd')[:16]}.so")


def test_from_env_disabled_when_unset(tmp_path):
    assert CompileCache.from_env(env={}) is None
    cache = CompileCache.from_env(env={"DSTACK_COMPILE_CACHE": str(tmp_path)})
    assert cache is not None and cache.root == tmp_path
    peers_only = CompileCache.from_env(
        env={"DSTACK_COMPILE_CACHE_PEERS": "http://a:8000, http://b:8000"})
    assert peers_only.peers == ["http://a:8000", "http://b:8000"]
    assert peers_only.root is None


def test_compile_cache_entry_bytes_roundtrip(tmp_path):
    cache = CompileCache(tmp_path)
    key = "ab" * 32
    assert not cache.contains(key) and cache.get_bytes(key) is None
    assert cache.put_bytes(key, b"\x7fELF library bytes")
    assert cache.get_bytes(key) == b"\x7fELF library bytes"
    assert cache.contains(key) and not cache.contains("0" * 64)
    assert (tmp_path / "ab" / (key + ".so")).exists()
    assert not list(tmp_path.rglob(".tmp-*"))
    assert cache.snapshot()["compile_cache_puts"] == 1
    # no root: nothing is stored
    assert not CompileCache().put_bytes(key, b"x")


# -- compile cache: libraries --------------------------------------------------


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """An empty build/ for the libraries (the sources are the repo's)."""
    path = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", path)
    return path


def _library(name: str) -> bytes:
    return b"\x7fELF stand-in library of " + name.encode()


class Compiler:
    """Writes a stand-in library where nvcc would; counts its runs."""

    def __init__(self):
        self.calls = []

    def __call__(self, names):
        for name in names:
            self.calls.append(name)
            path = _build.library_path(name)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(_library(name))


def _loader(path, name):
    """Loads a stand-in library of ``name`` and nothing else."""
    with open(path, "rb") as f:
        if f.read() != _library(name):
            raise OSError(f"{path}: not a library of {name}")


def _cache(root, **kw):
    return CompileCache(root, loader=_loader, **kw)


def test_ensure_compiles_once_then_hits(tmp_path, build_dir):
    """An empty build/ and root: nvcc once per library (misses = the
    compiler's runs), the library stored into the root; again from the
    same build/: a hit, no compile."""
    compiler = Compiler()
    cache = _cache(tmp_path / "root")
    for name in ("flash_fwd", "flash_bwd"):
        assert cache.ensure(name, compiler) == "compile"
    assert compiler.calls == ["flash_fwd", "flash_bwd"]
    assert cache.ensure("flash_fwd", compiler) == "build"
    assert compiler.calls == ["flash_fwd", "flash_bwd"]
    assert cache.snapshot() == {
        "compile_cache_hits": 1, "compile_cache_misses": len(compiler.calls),
        "compile_cache_peer_hits": 0, "compile_cache_puts": 2,
        "compile_cache_errors": 0}
    assert cache.get_bytes(cache.key_for("flash_bwd")) == _library(
        "flash_bwd")
    assert cache.resolved["flash_bwd"]["source"] == "compile"


def test_ensure_from_the_root_in_a_fresh_build_dir(tmp_path, build_dir,
                                                   monkeypatch):
    """A second cache instance over the same root, with an empty build/
    (a restart, another replica on the shared volume): every library a
    hit, no compile, installed under its library_path."""
    first = _cache(tmp_path / "root")
    first.ensure("paged_decode", Compiler())
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "other-build")
    compiler = Compiler()
    second = _cache(tmp_path / "root")
    assert second.ensure("paged_decode", compiler) == "cache"
    assert compiler.calls == []
    assert _build.library_path("paged_decode").read_bytes() == _library(
        "paged_decode")
    snap = second.snapshot()
    assert snap["compile_cache_hits"] == 1
    assert snap["compile_cache_misses"] == 0
    assert snap["compile_cache_puts"] == 0


def test_library_already_built_goes_into_the_root(tmp_path, build_dir):
    """A library nvcc built before the cache was set (the checkout's
    build/) is a hit and is put into the root for the fleet, once."""
    Compiler()(["flash_fwd"])
    cache = _cache(tmp_path / "root")
    assert cache.ensure("flash_fwd", Compiler()) == "build"
    assert cache.ensure("flash_fwd", Compiler()) == "build"
    snap = cache.snapshot()
    assert (snap["compile_cache_hits"], snap["compile_cache_puts"]) == (2, 1)
    assert cache.contains(cache.key_for("flash_fwd"))


@pytest.mark.parametrize("entry", [b"not a library", b"\x7fELF torn"],
                         ids=["not-elf", "unloadable"])
def test_corrupt_entry_counts_an_error_and_compiles(tmp_path, build_dir,
                                                    entry):
    """A garbage or torn entry never reaches build/: the error counter
    ticks, nvcc builds the library and its entry replaces the bad one."""
    cache = _cache(tmp_path / "root")
    key = cache.key_for("paged_decode")
    cache.put_bytes(key, entry)
    compiler = Compiler()
    assert cache.ensure("paged_decode", compiler) == "compile"
    assert compiler.calls == ["paged_decode"]
    snap = cache.snapshot()
    assert snap["compile_cache_errors"] == 1
    assert snap["compile_cache_misses"] == 1
    assert cache.get_bytes(key) == _library("paged_decode")
    assert not list(build_dir.glob("tmp*"))


def test_default_loader_refuses_a_file_ctypes_cannot_load(tmp_path,
                                                          build_dir):
    """The default loader (ctypes, then the entry point): ELF bytes that
    do not load are an error, and nvcc builds the library."""
    cache = CompileCache(tmp_path / "root")
    cache.put_bytes(cache.key_for("flash_fwd"), b"\x7fELF" + bytes(60))
    compiler = Compiler()
    assert cache.ensure("flash_fwd", compiler) == "compile"
    assert cache.snapshot()["compile_cache_errors"] == 1
    assert compiler.calls == ["flash_fwd"]


def test_peer_fetch_fills_local_store(tmp_path, build_dir, monkeypatch):
    """On a local miss the cache fetches the library from a peer's seed
    route and persists it: no nvcc.  A peer that answers with a library
    that does not load is skipped for the next one."""
    seeder = _cache(tmp_path / "seeder")
    seeder.ensure("paged_decode", Compiler())
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "joiner-build")
    urls = []

    def fetch(url):
        urls.append(url)
        if url.startswith("http://bad"):
            return b"\x7fELF something else"
        if url.startswith("http://down"):
            raise ConnectionError(url)
        key = url.rsplit("/", 1)[1]
        assert url == f"http://peer:8000/elastic/compile/{key}"
        return seeder.get_bytes(key)

    joiner = _cache(tmp_path / "joiner",
                    peers=["http://down:1", "http://bad:2/",
                           "http://peer:8000"], fetch=fetch)
    compiler = Compiler()
    assert joiner.ensure("paged_decode", compiler) == "peer"
    assert compiler.calls == [] and len(urls) == 3
    assert _build.library_path("paged_decode").read_bytes() == _library(
        "paged_decode")
    snap = joiner.snapshot()
    assert snap == {"compile_cache_hits": 1, "compile_cache_misses": 0,
                    "compile_cache_peer_hits": 1, "compile_cache_puts": 1,
                    "compile_cache_errors": 1}
    # persisted: a second instance over the joiner's root needs no peer
    again = _cache(tmp_path / "joiner")
    assert again.get_bytes(joiner.key_for("paged_decode")) is not None


def test_maybe_cached_none_is_identity():
    def fn(x):
        return x

    assert maybe_cached(fn, None) is fn


def test_cached_kernels_resolve_once_when_a_call_needs_them(tmp_path,
                                                            build_dir):
    compiler = Compiler()
    cache = _cache(tmp_path / "root")
    cache.ensure = (lambda name, _ensure=cache.ensure:
                    _ensure(name, compiler))
    step = maybe_cached(lambda x, on_card: x + 1, cache, tag="step",
                        kernels=("flash_fwd", "flash_bwd"),
                        needs=lambda x, on_card: on_card)
    assert isinstance(step, CachedKernels) and step.tag == "step"
    assert step(1, False) == 2
    assert step.source is None and compiler.calls == []
    assert step(1, True) == 2 and step(2, True) == 3
    assert step.source == "compile"
    assert compiler.calls == ["flash_fwd", "flash_bwd"]
    assert step.key == ",".join(cache.key_for(n)
                                for n in ("flash_fwd", "flash_bwd"))
    again = maybe_cached(lambda: 0, cache, kernels=("flash_fwd",))
    again()
    assert again.source == "cache" and len(compiler.calls) == 2


def test_make_train_step_takes_a_compile_cache(tmp_path, monkeypatch):
    """make_train_step(compile_cache=) wraps the step; a step on the CPU
    takes the plain attention and resolves no library."""
    monkeypatch.setattr(CompileCache, "ensure",
                        lambda self, name, compiler=None: pytest.fail(name))
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    opt = train.default_optimizer()
    cache = CompileCache(tmp_path)
    step = train.make_train_step(cfg, opt, compile_cache=cache)
    assert isinstance(step, CachedKernels)
    assert step.kernels == ("flash_fwd", "flash_bwd", "rownorm", "adamw")
    state = train.create_state(0, cfg, opt, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 17),
                           generator=torch.Generator().manual_seed(0))
    _, metrics = step(state, {"tokens": tokens})
    assert torch.isfinite(metrics["loss"]) and step.source is None
    assert cache.snapshot()["compile_cache_misses"] == 0


# -- the engine's warmup -------------------------------------------------------


def _engine(**kw):
    return InferenceEngine(
        LlamaConfig.tiny(dtype=torch.float32), batch_size=2, max_len=128,
        paged=True, kv_block_size=16, device="cpu",
        telemetry=EngineTelemetry(), **kw)


class _Ensured:
    """A compile cache that records what it was asked to resolve."""

    def __init__(self):
        self.names = []
        self.resolved = {}

    def ensure(self, name):
        self.names.append(name)
        return "cache"

    def snapshot(self):
        return {"compile_cache_hits": len(self.names)}


def test_engine_warmup_returns_elapsed():
    engine = _engine()
    assert engine.compile_cache is None
    assert engine.warmup(prompt_len=4, max_new_tokens=2) > 0.0
    assert engine.decode_steps > 0


def test_engine_resolves_the_kernel_library_once_on_the_card_path():
    """A CPU engine resolves no library (its decode takes the plain
    attention); an engine on the kernels' path resolves the row kernel and
    paged_decode once, in warmup or at its first device operation."""
    cpu = _engine(compile_cache=_Ensured())
    cpu.warmup(prompt_len=4, max_new_tokens=2)
    assert cpu.compile_cache.names == []
    for warm in (True, False):
        engine = _engine(compile_cache=_Ensured())
        # as on CUDA with bf16 pages
        engine._kernels_pending = ("rownorm", "paged_decode")
        if warm:
            engine.warmup(prompt_len=4, max_new_tokens=2)
        engine.generate([1, 2, 3], max_new_tokens=3)
        assert engine.compile_cache.names == ["rownorm", "paged_decode"]


# -- the server's elastic routes -----------------------------------------------


@contextlib.contextmanager
def _served(app, start=False, warm=False):
    if start:
        app.start_engine(warm=warm)
    server = app.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        app.engine.stop()
        app.join_engine(timeout=30)
        thread.join(timeout=10)
        assert not thread.is_alive()


def _call(url, payload=None, method=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, method=method or ("GET" if data is None else "POST"),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers, err.read()


def _json(url, payload=None, method=None):
    status, headers, body = _call(url, payload, method)
    return status, headers, json.loads(body)


def test_load_reports_warming_distinct_from_draining():
    """A warming replica is healthy but not capacity; the two flags stay
    independent on /load and in the X-Dstack-Load-* headers, /v1 answers
    503 with Retry-After 2, and /health says warming."""
    app = t_server.ServingApp(_engine(), ByteTokenizer())
    app.warming = True
    with _served(app) as base:
        status, headers, body = _json(base + "/load")
        assert status == 200
        assert body["warming"] == 1 and body["draining"] == 0
        hdrs = parse_load_headers(headers)
        assert hdrs["warming"] == 1 and hdrs["draining"] == 0
        status, headers, body = _json(base + "/v1/completions",
                                      {"prompt": "hi", "max_tokens": 1})
        assert status == 503 and headers["Retry-After"] == "2"
        assert "warming" in body["detail"]
        assert _json(base + "/health")[2]["status"] == "warming"
        app.warming = False
        body = _json(base + "/load")[2]
        assert body["warming"] == 0 and body["draining"] == 0


def test_load_and_stats_surface_compile_cache_counters(tmp_path):
    app = t_server.ServingApp(_engine(compile_cache=CompileCache(tmp_path)),
                              ByteTokenizer())
    with _served(app) as base:
        body = _json(base + "/load")[2]
        assert body["compile_cache_hits"] == 0
        assert body["compile_cache_misses"] == 0
        stats = _json(base + "/stats")[2]
        assert stats["compile_cache"]["compile_cache_misses"] == 0
        assert stats["compile_cache_resolved"] == {}
        assert stats["warming"] is False and stats["standby"] is False
        assert "weight_pull" not in stats


def test_elastic_compile_route_serves_cache_bytes(tmp_path):
    cache = CompileCache(tmp_path)
    key = "ab" * 32
    cache.put_bytes(key, b"\x7fELF library bytes")
    app = t_server.ServingApp(_engine(compile_cache=cache), ByteTokenizer())
    with _served(app) as base:
        status, headers, body = _call(f"{base}/elastic/compile/{key}")
        assert status == 200 and body == b"\x7fELF library bytes"
        assert headers["Content-Type"] == "application/octet-stream"
        assert _call(f"{base}/elastic/compile/{'cd' * 32}")[0] == 404
        assert _call(f"{base}/elastic/compile/..%2fsecrets")[0] == 400
        assert _call(f"{base}/elastic/compile/AB")[0] == 400


def test_elastic_compile_404_when_cache_disabled():
    app = t_server.ServingApp(_engine(), ByteTokenizer())
    with _served(app) as base:
        status, _, body = _json(f"{base}/elastic/compile/{'ab' * 32}")
        assert status == 404 and "disabled" in body["detail"]


def test_elastic_weights_routes_seed_published_snapshot(tmp_path):
    """Manifest and shard bytes come back verbatim from the latest
    published snapshot; only manifest-format shard names are served."""
    _publish_seed(tmp_path, step=2)
    _, step_dir = _publish_seed(tmp_path, step=4)
    app = t_server.ServingApp(_engine(), ByteTokenizer(),
                              snapshot_dir=str(tmp_path))
    with _served(app) as base:
        status, _, manifest = _json(base + "/elastic/weights/manifest")
        assert status == 200 and manifest["step"] == 4
        assert "host_00000.npz" in manifest["checksums"]
        status, headers, body = _call(base + "/elastic/weights/host_00000.npz")
        assert status == 200
        assert body == (step_dir / "host_00000.npz").read_bytes()
        assert int(headers["Content-Length"]) == len(body)
        assert _call(base + "/elastic/weights/host_00099.npz")[0] == 404
        assert _call(base + "/elastic/weights/manifest.json")[0] == 400
        assert _call(base + "/elastic/weights/..%2fLATEST")[0] == 400
        assert _call(base + "/elastic/weights/../LATEST")[0] == 404


def test_elastic_weights_404_without_a_snapshot(tmp_path):
    for snapshot_dir in (None, str(tmp_path)):
        app = t_server.ServingApp(_engine(), ByteTokenizer(),
                                  snapshot_dir=snapshot_dir)
        with _served(app) as base:
            assert _call(base + "/elastic/weights/manifest")[0] == 404
            assert _call(base + "/elastic/weights/host_00000.npz")[0] == 404


def test_seeding_is_paced_below_its_rate(tmp_path):
    """seed_rate_bps paces a shard chunk by chunk: at 20 MB/s the client
    of a 3-chunk shard of n bytes waits at least (n - one chunk) / rate
    (the first chunk goes out at once); unpaced it is not held back."""
    tree = {"w": torch.arange(3 << 18, dtype=torch.float32)}
    ckpt.write_snapshot(tmp_path, ckpt.snapshot_train_state(tree), 0)
    size = (tmp_path / "step_00000000" / "host_00000.npz").stat().st_size
    assert size > 2 * t_server.SEED_CHUNK_BYTES
    rate = 20e6
    paced = (size - t_server.SEED_CHUNK_BYTES) / rate
    for seed_rate in (rate, 0.0):
        app = t_server.ServingApp(_engine(), ByteTokenizer(),
                                  snapshot_dir=str(tmp_path),
                                  seed_rate_bps=seed_rate)
        with _served(app) as base:
            t0 = time.monotonic()
            status, _, body = _call(base + "/elastic/weights/host_00000.npz")
            elapsed = time.monotonic() - t0
        assert status == 200 and len(body) == size
        if seed_rate:
            assert elapsed >= paced
        else:
            assert elapsed < paced


def test_standby_warms_then_activates_over_http():
    """A standby warms (its engine loop starts after), refuses /v1 until
    POST /elastic/standby/activate flips it live; activation while still
    warming is a 409; a second activation reports no flip."""
    app = t_server.ServingApp(_engine(), ByteTokenizer(), standby=True)
    with _served(app, start=True, warm=True) as base:
        deadline = time.monotonic() + 60
        while _json(base + "/elastic/standby")[2]["warming"]:
            assert time.monotonic() < deadline, "warmup did not end"
            time.sleep(0.05)
        assert _json(base + "/elastic/standby")[2] == {
            "standby": True, "warming": False, "activated_at": None}
        assert _json(base + "/load")[2]["warming"] == 1
        assert _json(base + "/health")[2]["status"] == "warming"
        status, headers, _ = _call(base + "/v1/completions",
                                   {"prompt": "hi", "max_tokens": 1})
        assert status == 503 and headers["Retry-After"] == "2"
        app.warming = True
        status, headers, body = _json(base + "/elastic/standby/activate",
                                      method="POST")
        assert status == 409 and headers["Retry-After"] == "2"
        assert body["warming"] is True
        app.warming = False
        status, _, body = _json(base + "/elastic/standby/activate",
                                method="POST")
        assert status == 200
        assert body == {"activated": True, "warming": False,
                        "standby": False}
        assert _json(base + "/load")[2]["warming"] == 0
        assert _json(base + "/health")[2]["status"] == "ok"
        status = _json(base + "/elastic/standby")[2]
        assert status["standby"] is False and status["activated_at"]
        status, _, body = _json(base + "/v1/completions",
                                {"prompt": "hi", "max_tokens": 3,
                                 "return_token_ids": True})
        assert status == 200 and len(body["choices"][0]["token_ids"]) == 3
        assert _json(base + "/elastic/standby/activate",
                     method="POST")[2]["activated"] is False
