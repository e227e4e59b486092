#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure stops the run with a non-zero exit and no result):

1. build   — compiles every CUDA kernel of the port from
             dstack_tpu_torch/ops/csrc/ with nvcc (sm_90a).
2. kernels — holds the paged-decode kernel (bf16 and int8 pages) to its
             plain PyTorch version at the serving path's shapes (Llama-3-8B:
             D=128; Llama-3.2-1B: D=64), and times the kernel, the plain
             version and, as a yardstick only, scaled_dot_product_attention
             on the gathered view, beside the card's least time (bound).
3. server  — serves Llama-3-8B (full width and depth, random weights from a
             seed) with `python -m dstack_tpu_torch.serving.server --paged`
             and sends concurrent /v1/completions (one streaming) and a
             /v1/chat/completions; checks the answers, /metrics and /stats,
             and that the kernel ran once per layer per decode step.
4. share   — the server's burst again, in process (Llama-3-8B, bf16
             pages): the kernel's device time per decode step (CUDA
             events around each call, replayed with the stream held so
             they span the kernel alone) beside the step's wall time.
5. engines — in-process engines: Llama-3-8B with int8 KV pages, then
             Llama-3.2-1B with bf16 and int8 pages; each decodes a few
             tokens through the kernel, and each greedy token is checked
             against a plain full-sequence forward of the same model.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Needs one CUDA card; exits non-zero without
one, or when run outside a checkout of the repository.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): device memory rate
# and bf16 tensor-core rate; the bound of a kernel is the larger of its
# bytes over the first and its operations over the second
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

SOURCE = "dstack_tpu_torch/ops/csrc/paged_decode.cu"
REPLACES = "dstack_tpu/ops/flash_attention.py:703"
#: the serving path's decode shapes: 8 slots, 8 kv heads x 4 query heads,
#: 32-row pages, 32 table columns (max_len 1024)
SHAPES = {"llama3-8b": 128, "llama3-1b": 64}
LENGTHS = [0, 1, 31, 32, 33, 500, 1000, 1024]
B, HKV, G, BS, NBK = 8, 8, 4, 32, 32
#: o: p is rounded to bf16 before PV against the running max in the kernel
#: and the global max in the plain version (sound kernel: <= 1.6e-3 at
#: these shapes); lse sums unrounded f32 p on both sides.  What planted
#: faults give against these limits: dstack_tpu_torch/tools/
#: paged_decode_faults.py
O_ATOL = 5e-3
LSE_ATOL = 1e-3
#: calls replayed per hold of the stream in the share phase
REPLAY_CHUNK = 128
#: the server phase's prompt, also sent in process by the share phase
PROMPT = ("The paged KV cache keeps each request's keys and values in "
          "fixed-size blocks; request number {i} asks about it.")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# -- phase 2: kernel against its plain version -------------------------------


def make_case(torch, d: int, quant: bool, seed: int):
    from dstack_tpu_torch.serving.quant import quantize_kv

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    nb = B * NBK + 1
    q = torch.randn((B, HKV, G, d), generator=gen, device=dev).to(
        torch.bfloat16)
    kp = torch.randn((nb, BS, HKV, d), generator=gen, device=dev).to(
        torch.bfloat16)
    vp = torch.randn((nb, BS, HKV, d), generator=gen, device=dev).to(
        torch.bfloat16)
    # each slot owns distinct random pages; the table is twice as wide as
    # the walk and sliced, as the engine's ragged bucket is
    perm = torch.randperm(nb - 1, generator=gen, device=dev).to(
        torch.int32) + 1
    tables = torch.zeros((B, 2 * NBK), dtype=torch.int32, device=dev)
    for b, n in enumerate(LENGTHS):
        owned = -(-n // BS)
        tables[b, :owned] = perm[b * NBK:b * NBK + owned]
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    if quant:
        kq, ks = quantize_kv(kp)
        vq, vs = quantize_kv(vp)
        kp, vp = {"q": kq, "s": ks}, {"q": vq, "s": vs}
    return q, kp, vp, tables[:, :NBK], lengths


def time_ms(torch, fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(d: int, quant: bool):
    """Least time for this call's work: each input byte the function needs
    read once (q, the K/V rows below each length, their scales, the table
    entries walked, the lengths), each output byte written once, against
    4 * sum(length) * Hq * D operations (QK and PV, two per MAC) in bf16."""
    hq = HKV * G
    rows = sum(LENGTHS)
    elem = 1 if quant else 2
    kv = 2 * rows * HKV * d * elem + (2 * rows * HKV * 4 if quant else 0)
    pages = sum(-(-n // BS) for n in LENGTHS)
    nbytes = (B * hq * d * 2 + kv + pages * 4 + B * 4
              + B * hq * d * 4 + B * hq * 4)
    flops = 4 * rows * hq * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def errors(torch, fa, args):
    """Largest |o| and |lse| differences of the wrapper against the plain
    version on ``args``, and whether the empty slot (row 0) gave o = 0,
    lse = -1e30."""
    o, lse = fa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    want_o, want_lse = fa.paged_decode_attention_plain(*args)
    err_o = (o - want_o).abs().max().item()
    err_lse = (lse - want_lse).abs().max().item()
    empty_ok = bool(torch.all(o[0] == 0) and torch.all(lse[0] == -1e30))
    return err_o, err_lse, empty_ok


def check_kernels(torch) -> dict:
    import torch.nn.functional as F

    from dstack_tpu_torch.ops import flash_attention as fa

    out = {}
    for shape, d in SHAPES.items():
        for quant in (False, True):
            variant = "int8" if quant else "bf16"
            args = make_case(torch, d, quant, seed=d + quant)
            err_o, err_lse, empty_ok = errors(torch, fa, args)
            if not (err_o <= O_ATOL and err_lse <= LSE_ATOL):
                fail(f"kernel {variant} D={d} disagrees with the plain "
                     f"version: max |o| err {err_o}, max |lse| err {err_lse}")
            if not empty_ok:
                fail(f"kernel {variant} D={d}: empty slot is not o=0, "
                     "lse=-1e30")
            ms = time_ms(torch, lambda: fa.paged_decode_attention(*args), 200)
            plain_ms = time_ms(
                torch, lambda: fa.paged_decode_attention_plain(*args), 20)
            # yardstick: one library attention call over the gathered,
            # dequantized view (the port never calls it)
            q, kp, vp, tables, lengths = args
            idx = tables.long()

            def dense(pages):
                if isinstance(pages, dict):
                    rows = (pages["q"][idx].float()
                            * pages["s"][idx][..., None]).to(torch.bfloat16)
                else:
                    rows = pages[idx]
                return rows.reshape(B, NBK * BS, HKV, d).transpose(1, 2)

            kd, vd = dense(kp), dense(vp)
            qd = q.reshape(B, HKV * G, 1, d)
            mask = (torch.arange(NBK * BS, device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
            library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask, enable_gqa=True), 200)
            bound_ms, bound_by, nbytes, flops = bound(d, quant)
            name = f"paged_decode_attention[{variant},{shape}]"
            out[name] = {
                "name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES, "launches": 0,
                "max_abs_err": err_o, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms,
            }
            log(f"kernel {name}: max|o err| {err_o:.3e} max|lse err| "
                f"{err_lse:.3e}  kernel {ms * 1e3:.1f} us  plain "
                f"{plain_ms * 1e3:.1f} us  sdpa {library_ms * 1e3:.1f} us  "
                f"bound {bound_ms * 1e3:.2f} us by {bound_by} ({nbytes} B, "
                f"{flops} flop)")
    return out


# -- phase 3: the server -----------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(url: str, payload=None, timeout: float = 600.0):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"},
        method="GET" if payload is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def stream(url: str, payload, result: dict) -> None:
    """POST a streaming completion; records the status, the final chunk's
    finish reason and whether the stream ended with [DONE]."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.time()
    with urllib.request.urlopen(req, timeout=600) as resp:
        result["status"] = resp.status
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            body = line[len("data: "):]
            if body == "[DONE]":
                result["done"] = True
                break
            result["finish"] = json.loads(body)["choices"][0]["finish_reason"]
    result["wall"] = time.time() - t0


def serve_8b() -> dict:
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    log_path = ROOT / "dstack_tpu_torch" / "build" / "chip_smoke_server.log"
    cmd = [sys.executable, "-m", "dstack_tpu_torch.serving.server",
           "--config", "llama3-8b", "--paged", "--batch-size", "8",
           "--max-len", "1024", "--port", str(port)]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    log("server: " + " ".join(cmd[1:]))
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out,
                                stderr=subprocess.STDOUT)
    try:
        return drive_server(base, proc)
    except BaseException:
        log("server log (tail):\n" + log_path.read_text()[-4000:])
        raise
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def drive_server(base: str, proc) -> dict:
    t0 = time.time()
    while True:
        if proc.poll() is not None:
            fail(f"server exited with {proc.returncode} before answering")
        try:
            if http(base + "/health", timeout=5)[0] == 200:
                break
        except OSError:
            pass
        if time.time() - t0 > 600:
            fail("server did not answer /health within 600 s")
        time.sleep(1.0)
    log(f"server: up in {time.time() - t0:.1f} s")
    # one short request first: the card's first kernels and cuBLAS handles
    # start here, outside the measured run
    status, _ = http(base + "/v1/completions",
                     {"prompt": "warm up", "max_tokens": 4})
    if status != 200:
        fail(f"warm-up request answered {status}")
    # time to first token on an idle server: a one-token completion is a
    # prefill plus the first token's sampling (the random model's tokens are
    # mostly ids the byte tokenizer prints as nothing, so a stream's first
    # event would come only at its end)
    ttfts = []
    for i in range(3):
        t = time.time()
        status, body = http(base + "/v1/completions",
                            {"prompt": PROMPT.format(i=i), "max_tokens": 1})
        ttfts.append(time.time() - t)
        if status != 200 or json.loads(body)["usage"][
                "completion_tokens"] != 1:
            fail(f"one-token completion failed: {status} {body[:200]}")
    before = json.loads(http(base + "/stats")[1])
    results = [dict() for _ in range(5)]

    def complete(i):
        t = time.time()
        status, body = http(base + "/v1/completions",
                            {"prompt": PROMPT.format(i=i), "max_tokens": 64})
        out = json.loads(body)
        results[i].update(status=status, wall=time.time() - t,
                          tokens=out["usage"]["completion_tokens"])

    def chat(i):
        t = time.time()
        status, body = http(base + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": PROMPT.format(i=i)}],
            "max_tokens": 64})
        out = json.loads(body)
        results[i].update(status=status, wall=time.time() - t,
                          tokens=out["usage"]["completion_tokens"],
                          role=out["choices"][0]["message"]["role"])

    threads = [threading.Thread(target=complete, args=(i,)) for i in range(3)]
    threads.append(threading.Thread(target=stream, args=(
        base + "/v1/completions",
        {"prompt": PROMPT.format(i=3), "max_tokens": 64, "stream": True},
        results[3])))
    threads.append(threading.Thread(target=chat, args=(4,)))
    t_run = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.time() - t_run
    for i, r in enumerate(results):
        if r.get("status") != 200 or (i != 3 and r.get("tokens") != 64):
            fail(f"request {i} failed: {r}")
    if not (results[3].get("done") and results[3].get("finish") == "length"):
        fail(f"the stream did not run to its 64 tokens: {results[3]}")
    if results[4].get("role") != "assistant":
        fail(f"chat completion malformed: {results[4]}")
    status, metrics = http(base + "/metrics")
    if status != 200 or b"dstack_serving_decode_tokens_total" not in metrics:
        fail("/metrics did not answer with the serving series")
    after = json.loads(http(base + "/stats")[1])
    launches = (after["kernels"]["paged_decode_attention"]["launches"]
                - before["kernels"]["paged_decode_attention"]["launches"])
    steps = after["decode_steps"] - before["decode_steps"]
    layers = after["num_layers"]
    log(f"server: kernel launches {launches} over {steps} decode steps x "
        f"{layers} layers")
    if steps <= 0 or launches < layers * steps:
        fail(f"paged-decode kernel launched {launches} times, expected at "
             f"least {layers} x {steps}")
    counter = "dstack_serving_decode_tokens_total"
    decoded = after["counters"][counter] - before["counters"][counter]
    out = {"launches": launches, "decode_steps": steps,
           "ttft_s": sorted(ttfts)[1], "ttft_runs_s": ttfts,
           "concurrent_requests": 5, "wall_s": wall,
           "decode_tokens": decoded, "decode_tok_per_s": decoded / wall,
           "request_wall_s": [r["wall"] for r in results],
           "server_inter_token_p50_s": after["percentiles"].get(
               "dstack_serving_inter_token_seconds", {}).get("p50")}
    log("server: " + json.dumps(out))
    return out


# -- phase 4: the kernel's share of a decode step ----------------------------


def kernel_share(torch, cfg) -> dict:
    """The server phase's burst (five 64-token requests of PROMPT at once,
    8 slots, 1024 rows) on an in-process engine with bf16 pages.

    The engine's calls of the wrapper go through a shim that records a
    CUDA event before and after each call and keeps its arguments (the
    table and lengths cloned).  Each pair spans the launch on the device's
    clock; while the device waits on the host, the span includes the
    wrapper's host work.  So every call is then replayed, a chunk at a
    time, with the stream held by ``torch.cuda._sleep`` until the host has
    queued the chunk: each replayed pair spans the kernel alone, and the
    host's queuing time over the calls is the wrapper's host time.  The kernel's time depends on
    the lengths and tables only, not on the page contents, which the run
    has overwritten since.  A decode step's time is the run's wall time
    over its decode steps (prefill of the five prompts included, as in
    the server's rate)."""
    from dstack_tpu_torch.serving import engine as eng

    engine = eng.InferenceEngine(cfg, batch_size=8, max_len=1024, paged=True,
                                 rng_seed=1, device="cuda")
    engine.generate(list(b"warm up"), max_new_tokens=4)
    real, pairs, calls = eng.paged_decode_attention, [], []

    def event_pair():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def timed(q, k_pages, v_pages, tables, lengths, **kw):
        start, end = event_pair()
        start.record()
        out = real(q, k_pages, v_pages, tables, lengths, **kw)
        end.record()
        pairs.append((start, end))
        calls.append((q, k_pages, v_pages, tables.clone(), lengths.clone(),
                      kw))
        return out

    reqs = [eng.Request(tokens=list(PROMPT.format(i=i).encode()),
                        max_new_tokens=64) for i in range(5)]
    steps0 = engine.decode_steps
    eng.paged_decode_attention = timed
    try:
        t0 = time.time()
        for r in reqs:
            engine.submit(r)
        while not all(r.done.is_set() for r in reqs):
            engine.step()
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        eng.paged_decode_attention = real
    steps = engine.decode_steps - steps0
    if steps <= 0 or len(pairs) < cfg.num_layers * steps:
        fail(f"share: {len(pairs)} kernel calls over {steps} decode steps")
    span_ms = sum(a.elapsed_time(b) for a, b in pairs)

    replays, enqueue_ms = [], 0.0
    for first in range(0, len(calls), REPLAY_CHUNK):
        # a chunk at a time: the launch queue is only so deep, and a full
        # one would block the host until the device caught up
        held = torch.cuda.Event(enable_timing=True)
        held.record()
        torch.cuda._sleep(400_000_000)  # ~0.2 s of device clock cycles
        t_host = time.time()
        chunk = []
        for q, kp, vp, tables, lengths, kw in calls[first:
                                                    first + REPLAY_CHUNK]:
            pair = event_pair()
            pair[0].record()
            real(q, kp, vp, tables, lengths, **kw)
            pair[1].record()
            chunk.append(pair)
        chunk_ms = (time.time() - t_host) * 1e3
        torch.cuda.synchronize()
        chunk_held_ms = held.elapsed_time(chunk[0][0])
        if chunk_ms >= chunk_held_ms:
            fail(f"share: the host took {chunk_ms:.0f} ms to queue "
                 f"{len(chunk)} replays, longer than the stream was held "
                 f"({chunk_held_ms:.0f} ms)")
        replays += chunk
        enqueue_ms += chunk_ms
    kernel_ms = sum(a.elapsed_time(b) for a, b in replays)
    out = {"decode_steps": steps, "launches": len(pairs),
           "step_wall_ms": wall * 1e3 / steps,
           "kernel_ms_per_step": kernel_ms / steps,
           "kernel_us_per_launch": kernel_ms * 1e3 / len(pairs),
           "kernel_share_of_step": kernel_ms / (wall * 1e3),
           "call_span_us_per_launch": span_ms * 1e3 / len(pairs),
           # two event records per call included
           "wrapper_host_us_per_call": enqueue_ms * 1e3 / len(replays)}
    log("share: " + json.dumps(out))
    del engine, calls
    torch.cuda.empty_cache()
    return out


# -- phase 5: in-process engines ---------------------------------------------


def run_engine(torch, cfg, kv_quantize, label: str,
               device: str = "cuda") -> int:
    """Decode a few greedy tokens for two prompts; returns the kernel's
    launches during the run.  Each generated token must be the plain
    full-sequence forward's argmax up to a margin (bf16 sums in another
    order; int8 pages add their quantization error)."""
    from dstack_tpu_torch.ops import flash_attention as fa
    from dstack_tpu_torch.serving.engine import (
        InferenceEngine,
        Request,
        _prompt_forward,
    )

    engine = InferenceEngine(cfg, batch_size=8, max_len=1024, paged=True,
                             kv_quantize=kv_quantize, rng_seed=1,
                             device=device)
    prompts = [[(i * 37 + 11) % 256 for i in range(40)],
               [(i * 91 + 3) % 256 for i in range(75)]]
    reqs = [Request(tokens=p, max_new_tokens=12) for p in prompts]
    fa.paged_decode_attention.launches = 0
    steps0 = engine.decode_steps
    for r in reqs:
        engine.submit(r)
    t0 = time.time()
    while not all(r.done.is_set() for r in reqs):
        engine.step()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fa.paged_decode_attention.launches
    steps = engine.decode_steps - steps0
    if launches < cfg.num_layers * steps or steps <= 0:
        fail(f"{label}: {launches} launches over {steps} steps")
    margin = 0.1 if kv_quantize is None else 0.25
    worst = 0.0
    for r in reqs:
        if len(r.output) != 12:
            fail(f"{label}: {len(r.output)} tokens, wanted 12")
        seq = list(r.tokens)
        for tok in r.output:
            padded = torch.zeros(128, dtype=torch.long, device=device)
            padded[:len(seq)] = torch.tensor(seq, device=device)
            logits, _, _ = _prompt_forward(engine.params, cfg, padded,
                                           len(seq), 128)
            if not torch.isfinite(logits).all():
                fail(f"{label}: non-finite logits")
            gap = ((logits.max() - logits[tok]) / logits.std()).item()
            worst = max(worst, gap)
            if gap > margin:
                fail(f"{label}: token {tok} is {gap:.3f} std below the "
                     f"plain forward's argmax")
            seq.append(tok)
    log(f"engine {label}: {steps} decode steps, {launches} kernel launches, "
        f"{wall:.2f} s, worst greedy gap {worst:.4f} std")
    del engine
    if device == "cuda":
        torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "dstack_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    log(f"card: {smi.stdout.strip()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from dstack_tpu_torch.models.llama import LlamaConfig
    from dstack_tpu_torch.ops import _build

    t0 = time.time()
    logs = _build.build()
    log(f"build: {time.time() - t0:.1f} s")
    for name, text in logs.items():
        log(f"nvcc {name}:\n{text.strip()}")

    kernels = check_kernels(torch)
    served = serve_8b()
    kernels["paged_decode_attention[bf16,llama3-8b]"]["launches"] = \
        served["launches"]
    share = kernel_share(torch, LlamaConfig.llama3_8b())
    for cfg_name, cfg in (("llama3-8b", LlamaConfig.llama3_8b()),
                          ("llama3-1b", LlamaConfig.llama3_1b())):
        variants = ("int8",) if cfg_name == "llama3-8b" else ("bf16", "int8")
        for variant in variants:
            launches = run_engine(torch, cfg,
                                  None if variant == "bf16" else "int8",
                                  f"{cfg_name} {variant} pages")
            kernels[f"paged_decode_attention[{variant},{cfg_name}]"][
                "launches"] = launches
    for k in kernels.values():
        if k["launches"] <= 0:
            fail(f"{k['name']} was not launched on its path")
    log("server summary: " + json.dumps(served))
    log("share summary: " + json.dumps(share))
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
