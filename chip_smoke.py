#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure stops the run with a non-zero exit and no result):

1. build   — compiles every CUDA kernel of the port from
             dstack_tpu_torch/ops/csrc/ with nvcc (sm_90a), one nvcc per
             source, all at once.
2. kernels — holds the paged-decode kernel (bf16 and int8 pages) to its
             plain PyTorch version at the serving path's shapes (Llama-3-8B:
             D=128; Llama-3.2-1B: D=64), and the causal flash-attention
             forward (o, lse) and backward (dq, dk, dv) kernels to theirs
             (largest absolute error, and largest error of a row relative
             to the row) at the training path's shapes (Llama-3.2-1B b8 s1024 D=64,
             Llama-3-8B geometry b4 s2048 D=128); times each kernel, its
             plain version and, as a yardstick only,
             scaled_dot_product_attention, beside the card's least time
             (bound).  Then the loss's f32 logits from bf16 inputs against
             an f32 matmul.
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
6. train   — make_train_step on Llama-3.2-1B (full width and depth, b8
             s1024) and on the Llama-3-8B layer geometry at 6 layers (b4
             s2048), both with selective remat, random init from a seed:
             the loss is
             finite and falls, the flash kernels launch exactly layers x
             steps (forward x2 under remat), and tokens/s, MFU and peak
             memory are printed.
7. train-plain — one 1B step through the kernels and the same step with
             flash_attention swapped for its plain versions: loss and
             grad norm must agree.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Needs one CUDA card; exits non-zero without
one, or when run outside a checkout of the repository.
"""

from __future__ import annotations

import json
import math
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
FLASH_SOURCES = {"fwd": "dstack_tpu_torch/ops/csrc/flash_fwd.cu",
                 "bwd": "dstack_tpu_torch/ops/csrc/flash_bwd.cu"}
#: the Pallas kernel each instance replaces: D=128 the per-head kernels,
#: D=64 the head-pair packed ones
FLASH_REPLACES = {("fwd", 128): "dstack_tpu/ops/flash_attention.py:80",
                  ("bwd", 128): "dstack_tpu/ops/flash_attention.py:157",
                  ("fwd", 64): "dstack_tpu/ops/flash_attention.py:403",
                  ("bwd", 64): "dstack_tpu/ops/flash_attention.py:478"}
#: limits on the flash kernels' largest absolute errors against their
#: plain versions (bf16 outputs, unit-normal q, k, v, do from fixed seeds).
#: A sound kernel differs by one bf16 ulp of its largest outputs (another
#: summation order before the rounding, and p rounded against the running
#: max): o 3.9e-3, dq 7.8e-3, dk 1.6e-2, dv 3.1e-2, lse 9.5e-7 at these
#: inputs on an H100 (700 W); each limit is about 4x that
FLASH_ATOL = {"o": 1.6e-2, "lse": 1e-4, "dq": 3e-2, "dk": 6e-2, "dv": 1.2e-1}
#: limit on each output row's error relative to the row (L2 norms over the
#: D values of one position and head; the row's norm floored at 1/16 of
#: the output's RMS row norm, since the first query's dq is rounding
#: noise): an absolute limit alone misses a fault confined to rows of
#: small values, such as the last key block's dk and dv.  What sound and
#: planted faults give against both limits: dstack_tpu_torch/tools/
#: flash_faults.py
FLASH_ROW_RTOL = 3e-2
FLASH_LIMITS = {**FLASH_ATOL, **{f"{n}_row": FLASH_ROW_RTOL
                                 for n in ("o", "dq", "dk", "dv")}}
#: further (batch, seq, query heads, kv heads, head_dim) the flash kernels
#: are held to, for correctness only: MHA (group 1), group 2, MQA, and odd
#: numbers of 64-row blocks
FLASH_EDGE_SHAPES = ((2, 128, 4, 4, 64), (3, 192, 6, 3, 64),
                     (1, 256, 8, 2, 128), (2, 320, 4, 1, 128))
#: train phase: steps of each trainer of dstack_tpu_torch.tools.
#: train_profile.TRAINERS: Llama-3.2-1B at b8 s1024 and the Llama-3-8B
#: layer geometry at L=6, b4 s2048, both with selective remat (as the JAX
#: package's bench trains them)
TRAIN_STEPS = {"llama3-1b": 5, "llama3-8b-fit": 4}
#: train-plain phase: batch of the 1B step held to its plain-attention
#: twin, and the limits on the relative differences of the two (a sound
#: kernel gave 9.8e-5 on the loss and 5.2e-4 on the grad norm on an H100,
#: 700 W: bf16 attention outputs rounded in another order; ~10x that)
TRAIN_PLAIN_BATCH = 2
TRAIN_PLAIN_RTOL = {"loss": 1e-3, "grad_norm": 5e-3}
#: f32 logits from bf16 inputs: max error over the largest logit (f32
#: sums in another order give ~1e-6; bf16 rounding of the output, ~4e-3,
#: must not pass)
F32_LOGITS_RTOL = 1e-4
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


# -- phase 2, training kernels: flash attention against its plain versions --


def flash_case(torch, shape, seed: int):
    b, s, hq, hkv, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*dims):
        return torch.randn(dims, generator=gen, device="cuda").to(
            torch.bfloat16)

    return randn(b, s, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d), \
        randn(b, s, hq, d)


def flash_bounds(shape):
    """Least times (ms) of the forward and the backward function at
    ``shape``, each with what bounds it.  Bytes: each input read once and
    each output written once (forward: q, k, v -> o, lse; backward: q, k,
    v, o, lse, do -> dq, dk, dv).  Operations: 2 per multiply-add over the
    (query, key) pairs the causal mask keeps, S(S+1)/2 per head: two
    products (QK^T, PV) forward, five (QK^T, dO V^T, dV, dK, dQ) backward."""
    b, s, hq, hkv, d = shape
    pairs = b * hq * s * (s + 1) // 2
    q_bytes, kv_bytes, lse_bytes = b * s * hq * d * 2, b * s * hkv * d * 2, \
        b * hq * s * 4
    out = {}
    for part, nbytes, flops in (
            ("fwd", 2 * q_bytes + 2 * kv_bytes + lse_bytes, 4 * d * pairs),
            ("bwd", 4 * q_bytes + 4 * kv_bytes + lse_bytes, 10 * d * pairs)):
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
        out[part] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations", nbytes,
                     flops)
    return out


def row_rel_err(torch, got, want) -> float:
    """Largest error of a row of ``got`` relative to the row of ``want``
    (rows: the last dimension), as FLASH_ROW_RTOL defines it."""
    got, want = got.float(), want.float()
    norms = torch.linalg.vector_norm(want, dim=-1)
    floor = norms.square().mean().sqrt() / 16
    err = torch.linalg.vector_norm(got - want, dim=-1)
    return (err / norms.clamp_min(floor)).max().item()


def flash_errors(torch, fa, shape, scale: float):
    """Run both kernels once at ``shape`` and return their inputs, the
    forward's (o, lse) and each output's largest absolute error and row
    error (key ``<name>_row``) against the plain versions.  The backward is
    held on the kernel forward's own (o, lse), so its error is its own."""
    q, k, v, do = flash_case(torch, shape, seed=shape[4])
    o, lse = fa._flash_fwd_kernel(q, k, v, scale)
    grads = fa._flash_bwd_kernel(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    want_o, want_lse = fa.flash_attention_fwd_plain(q, k, v, scale)
    want_grads = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    errs = {"lse": (lse - want_lse).abs().max().item()}
    for n, got, want in zip(("o", "dq", "dk", "dv"), (o, *grads),
                            (want_o, *want_grads)):
        errs[n] = (got.float() - want.float()).abs().max().item()
        errs[n + "_row"] = row_rel_err(torch, got, want)
    return (q, k, v, do), (o, lse), errs


def flash_violations(errs: dict) -> dict:
    """The errors past their FLASH_LIMITS (a NaN is past any limit)."""
    return {n: e for n, e in errs.items() if not e <= FLASH_LIMITS[n]}


def checked_flash_errors(torch, fa, shape, scale: float):
    """:func:`flash_errors`, failing the run past FLASH_LIMITS."""
    out = flash_errors(torch, fa, shape, scale)
    bad = flash_violations(out[2])
    if bad:
        fail(f"flash kernels at (B, S, Hq, Hkv, D) = {shape} disagree with "
             f"the plain versions: {bad} (limits {FLASH_LIMITS})")
    return out


def check_flash_kernels(torch) -> dict:
    """Hold the forward (o, lse) and backward (dq, dk, dv) kernels to their
    plain versions at both training shapes, and at FLASH_EDGE_SHAPES, and
    time each at the training shapes beside its plain version,
    scaled_dot_product_attention (the yardstick, never called by the
    port) and its bound."""
    import torch.nn.functional as F

    from dstack_tpu_torch.ops import flash_attention as fa

    for shape in FLASH_EDGE_SHAPES:
        errs = checked_flash_errors(torch, fa, shape, shape[4] ** -0.5)[2]
        log(f"kernel flash (B, S, Hq, Hkv, D) = {shape}: max err " + " ".join(
            f"{n} {e:.3e}" for n, e in errs.items()))
    out = {}
    for cfg_name in TRAIN_STEPS:
        cfg, batch, seq, _ = trainer(cfg_name)
        shape = (batch, seq, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        d = cfg.head_dim
        scale = d ** -0.5
        (q, k, v, do), (o, lse), errs = checked_flash_errors(torch, fa,
                                                             shape, scale)

        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True, scale=scale)

        times = {
            "fwd": time_ms(torch, lambda: fa._flash_fwd_kernel(
                q, k, v, scale), 20),
            "fwd_plain": time_ms(torch, lambda: fa.flash_attention_fwd_plain(
                q, k, v, scale), 3),
            "bwd": time_ms(torch, lambda: fa._flash_bwd_kernel(
                q, k, v, o, lse, do, scale), 20),
            "bwd_plain": time_ms(torch, lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, lse, do, scale), 3),
        }
        with torch.no_grad():
            times["fwd_sdpa"] = time_ms(torch, sdpa, 20)
        ref = sdpa()
        times["bwd_sdpa"] = time_ms(torch, lambda: torch.autograd.grad(
            ref, (qt, kt, vt), dot, retain_graph=True), 20)
        times["fwd_bwd_sdpa"] = time_ms(torch, lambda: torch.autograd.grad(
            sdpa(), (qt, kt, vt), dot), 20)
        del ref
        bounds = flash_bounds(shape)
        for part, errs_shown in (("fwd", ("o", "lse", "o_row")),
                                 ("bwd", ("dq", "dk", "dv", "dq_row",
                                          "dk_row", "dv_row"))):
            name = f"flash_attention_{part}[{cfg_name},D={d}]"
            bound_ms, bound_by, nbytes, flops = bounds[part]
            out[name] = {
                "name": name, "route": "cuda", "source": FLASH_SOURCES[part],
                "replaces": FLASH_REPLACES[(part, d)], "launches": 0,
                "max_abs_err": max(errs[n] for n in errs_shown
                                   if not n.endswith("_row")),
                "ms": times[part], "plain_ms": times[part + "_plain"],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": times[part + "_sdpa"],
            }
            log(f"kernel {name}: max err " + " ".join(
                f"{n} {errs[n]:.3e}" for n in errs_shown)
                + f"  kernel {times[part] * 1e3:.1f} us  plain "
                f"{times[part + '_plain'] * 1e3:.1f} us  sdpa "
                f"{times[part + '_sdpa'] * 1e3:.1f} us  bound "
                f"{bound_ms * 1e3:.1f} us by {bound_by} ({nbytes} B, "
                f"{flops} flop)  {flops / times[part] / 1e9:.1f} TFLOP/s, "
                f"{bound_ms / times[part]:.3f} of the bound, "
                f"{times[part] / times[part + '_sdpa']:.2f}x sdpa")
        log(f"kernel flash fwd+bwd [{cfg_name}]: kernels "
            f"{(times['fwd'] + times['bwd']) * 1e3:.1f} us, sdpa "
            f"{times['fwd_bwd_sdpa'] * 1e3:.1f} us")
        del q, k, v, do, o, lse, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def check_f32_logits(torch) -> None:
    """The loss's bf16 x @ head with f32 output (torch.mm's out_dtype)
    against the f32 matmul of the same bf16 values, at one loss chunk of
    the 1B trainer (b8, 512 positions, 2048 x 128,256): the f32 sums run
    in another order, so the difference is f32 rounding, not bf16's."""
    from dstack_tpu_torch.ops.loss import f32_logits

    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((8, 512, 2048), generator=gen, device="cuda").to(
        torch.bfloat16)
    head = (torch.randn((2048, 128_256), generator=gen, device="cuda")
            * 2048 ** -0.5).to(torch.bfloat16)
    got = f32_logits(x, head)
    want = torch.matmul(x.float(), head.float())
    rel = ((got - want).abs().max() / want.abs().max()).item()
    del got, want
    torch.cuda.empty_cache()
    if not rel <= F32_LOGITS_RTOL:
        fail(f"f32 logits: max error {rel:.2e} of the largest logit "
             f"(limit {F32_LOGITS_RTOL})")
    log(f"f32 logits: max error {rel:.3e} of the largest logit")


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


# -- phases 6 and 7: training at full width ----------------------------------


def trainer(name: str):
    """(config, batch, seq, remat) of one of the trainers."""
    from dstack_tpu_torch.tools.train_profile import TRAINERS

    make_cfg, batch, seq, remat = TRAINERS[name]
    return make_cfg(), batch, seq, remat


def run_train(torch, cfg_name: str, steps: int) -> dict:
    """``steps`` train steps of the trainer ``cfg_name`` on one repeated
    batch of random tokens, from a random init (seed 0), unstacked.  Checks the loss is finite and falls, and that
    the flash kernels ran exactly once per layer per step forward (twice
    under remat: the backward recomputes the layer) and once backward."""
    from dstack_tpu_torch.models import train
    from dstack_tpu_torch.ops import flash_attention as fa

    cfg, batch, seq, remat = trainer(cfg_name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    opt = train.default_optimizer()
    t0 = time.time()
    state = train.create_state(gen, cfg, opt, unstacked=True)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    step_fn = train.make_train_step(cfg, opt, remat=remat)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.fwd_launches = fa.flash_attention.bwd_launches = 0
    losses, norms, times = [], [], []
    for _ in range(steps):
        t = time.time()
        state, metrics = step_fn(state, {"tokens": tokens})
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        torch.cuda.synchronize()
        times.append(time.time() - t)
    fwd, bwd = fa.flash_attention.fwd_launches, fa.flash_attention.bwd_launches
    per_layer = 1 if remat in (False, "none") else 2
    want_fwd = per_layer * cfg.num_layers * steps
    want_bwd = cfg.num_layers * steps
    if fwd != want_fwd or bwd != want_bwd:
        fail(f"train {cfg_name}: flash launches fwd {fwd} bwd {bwd}, "
             f"expected {want_fwd} and {want_bwd}")
    if not all(map(math.isfinite, losses + norms)):
        fail(f"train {cfg_name}: non-finite loss or grad norm: {losses} "
             f"{norms}")
    if not losses[-1] < losses[0]:
        fail(f"train {cfg_name}: loss did not fall: {losses}")
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    tok = batch * seq
    out = {"config": cfg_name, "num_layers": cfg.num_layers,
           "num_params": cfg.num_params(), "batch": batch, "seq": seq,
           "remat": remat, "steps": steps, "init_s": init_s,
           "losses": losses, "grad_norms": norms, "step_s": times,
           "step_median_s": step_s, "tokens_per_s": tok / step_s,
           # 6 * params * tokens: the matmuls only, attention left out
           "mfu_6nd": 6 * cfg.num_params() * tok / step_s / PEAK_BF16_FLOPS,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "fwd_launches": fwd, "bwd_launches": bwd}
    log("train: " + json.dumps(out))
    del state, step_fn
    torch.cuda.empty_cache()
    return out


def train_plain(torch) -> dict:
    """One Llama-3.2-1B step at a small batch through the kernels, then the
    same step from the same init with flash_attention swapped for its
    plain versions: the loss and the grad norm of the two must agree."""
    from dstack_tpu_torch.models import train
    from dstack_tpu_torch.ops import flash_attention as fa

    cfg, _, seq, _ = trainer("llama3-1b")
    kernel_fn = fa.flash_attention
    out = {}
    for route in ("kernel", "plain"):
        gen = torch.Generator(device="cuda").manual_seed(1)
        opt = train.default_optimizer()
        state = train.create_state(gen, cfg, opt, unstacked=True)
        tokens = torch.randint(0, cfg.vocab_size, (TRAIN_PLAIN_BATCH,
                                                   seq + 1), generator=gen,
                               device="cuda", dtype=torch.int32)
        step_fn = train.make_train_step(cfg, opt, remat=False)
        if route == "plain":
            fa.flash_attention = fa.flash_attention_plain
        try:
            _, metrics = step_fn(state, {"tokens": tokens})
            out[route] = {"loss": metrics["loss"].item(),
                          "grad_norm": metrics["grad_norm"].item()}
        finally:
            fa.flash_attention = kernel_fn
        del state, step_fn
        torch.cuda.empty_cache()
    for key, limit in TRAIN_PLAIN_RTOL.items():
        got, want = out["kernel"][key], out["plain"][key]
        rel = abs(got - want) / abs(want)
        out[f"{key}_rel_err"] = rel
        if not (math.isfinite(got) and rel <= limit):
            fail(f"train-plain: {key} {got} through the kernels vs {want} "
                 f"through the plain versions (rel {rel:.2e} > {limit})")
    log("train-plain: " + json.dumps(out))
    return out


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
    kernels.update(check_flash_kernels(torch))
    check_f32_logits(torch)
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
    trained = []
    for cfg_name, steps in TRAIN_STEPS.items():
        run = run_train(torch, cfg_name, steps)
        d = trainer(cfg_name)[0].head_dim
        kernels[f"flash_attention_fwd[{cfg_name},D={d}]"]["launches"] = \
            run["fwd_launches"]
        kernels[f"flash_attention_bwd[{cfg_name},D={d}]"]["launches"] = \
            run["bwd_launches"]
        trained.append(run)
    plain = train_plain(torch)
    for k in kernels.values():
        if k["launches"] <= 0:
            fail(f"{k['name']} was not launched on its path")
    log("server summary: " + json.dumps(served))
    log("share summary: " + json.dumps(share))
    for run in trained:
        log("train summary: " + json.dumps(
            {k: run[k] for k in ("config", "tokens_per_s", "mfu_6nd",
                                 "step_median_s", "max_memory_allocated_gb",
                                 "losses")}))
    log("train-plain summary: " + json.dumps(plain))
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
