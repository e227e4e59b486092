"""Where a training step's time goes on the card.

    python -m dstack_tpu_torch.tools.train_profile

For each trainer of :data:`TRAINERS` (the ones chip_smoke.py drives:
Llama-3.2-1B at b8 s1024 and the Llama-3-8B layer geometry at L=6, b4
s2048, both with selective remat, as the JAX package's bench.py trains
them), from a random init (seed 0) on
one repeated batch of random tokens: two warm-up steps, then one step
under ``torch.profiler`` (CPU and CUDA activities).  Prints the step's
wall time, the device's kernel time summed by category (the flash
attention kernels, the fused optimizer, matrix products, elementwise,
reductions, the rest),
the device's busy share of the wall time (kernel time over wall time),
the kernel time of each phase (forward, backward, optimizer) by category,
the phases' named ranges (their host time, and their span on the
device's timeline where the profiler records one) and the longest
kernels; the last line is one JSON object with the same numbers.  Needs
a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from dstack_tpu_torch.models import train
from dstack_tpu_torch.models.llama import LlamaConfig

#: name -> (config factory, batch, seq, remat) of the trainers that
#: chip_smoke.py drives and this tool profiles: bench.py's two (its
#: ``_measure`` trains both with remat=True, that is selective)
TRAINERS = {
    "llama3-1b": (LlamaConfig.llama3_1b, 8, 1024, True),
    "llama3-8b-fit": (lambda: LlamaConfig.llama3_8b_fit(num_layers=6), 4,
                      2048, True),
}
#: kernel-name fragments of each category, first match wins
CATEGORIES = (
    ("flash", ("flash::",)),
    ("optimizer", ("multi_tensor_apply",)),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "splitK")),
    ("elementwise", ("elementwise", "CatArrayBatched", "copy_kernel",
                     "fill")),
    ("reduction", ("reduce_kernel", "softmax", "norm_kernel", "logsumexp")),
)
RANGES = ("train.forward", "train.backward", "train.optimizer")


def category(name: str) -> str:
    for cat, parts in CATEGORIES:
        if any(p in name for p in parts):
            return cat
    return "other"


def profile_config(name: str) -> dict:
    make_cfg, batch, seq, remat = TRAINERS[name]
    cfg = make_cfg()
    gen = torch.Generator(device="cuda").manual_seed(0)
    opt = train.default_optimizer()
    state = train.create_state(gen, cfg, opt, unstacked=True)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    step_fn = train.make_train_step(cfg, opt, remat=remat)
    for _ in range(2):
        state, metrics = step_fn(state, {"tokens": tokens})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        state, metrics = step_fn(state, {"tokens": tokens})
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # each range shows twice: on the host (its wall time there) and, for
    # ranges the calling thread enqueues, as an annotation on the device's
    # timeline (its span there); neither is a kernel, nor is any other
    # annotation.  A range's device span covers only the kernels launched
    # directly in it, so torch.optim's own step range, nested in the
    # optimizer's, adds its span to that phase.  The backward runs on
    # autograd's own thread and gets no device span: a kernel that starts
    # inside no span of the forward or the optimizer is counted to the
    # backward.
    host, spans, phase_spans, kernel_events = {}, {}, [], []
    for ev in prof.events():
        on_device = ev.device_type == torch.autograd.DeviceType.CUDA
        if on_device and ev.is_user_annotation:
            span = (ev.time_range.start, ev.time_range.end)
            if ev.name in RANGES:
                spans[ev.name] = span
                phase_spans.append((ev.name.split(".")[1], *span))
            elif ev.name.startswith("Optimizer.step#"):
                phase_spans.append(("optimizer", *span))
        elif ev.name in RANGES:
            host[ev.name] = ev.time_range.elapsed_us() / 1e3
        elif on_device:
            kernel_events.append(ev)
    kernels: dict = {}
    by_cat: dict = {}
    by_phase: dict = {}
    for ev in kernel_events:
        ms = ev.time_range.elapsed_us() / 1e3
        total, count = kernels.get(ev.name, (0.0, 0))
        kernels[ev.name] = (total + ms, count + 1)
        cat = category(ev.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        phase = next((ph for ph, a, b in phase_spans
                      if a <= ev.time_range.start < b), "backward")
        cell = by_phase.setdefault(phase, {})
        cell[cat] = cell.get(cat, 0.0) + ms
    device_ms = sum(by_cat.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    out = {"config": name, "batch": batch, "seq": seq, "remat": remat,
           "loss": metrics["loss"].item(), "wall_ms": wall_ms,
           "device_kernel_ms": device_ms,
           "device_busy_share": device_ms / wall_ms,
           "kernel_ms_by_category": by_cat,
           "kernel_ms_by_phase": by_phase, "range_host_ms": host,
           "range_device_span_ms": {k: (b - a) / 1e3
                                    for k, (a, b) in spans.items()},
           "top_kernels": [{"name": k[:120], "ms": ms, "count": n}
                           for k, (ms, n) in top]}
    del state, step_fn
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("train_profile: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}  torch {torch.__version__}",
          flush=True)
    results = []
    for name in TRAINERS:
        res = profile_config(name)
        print(f"{name}: wall {res['wall_ms']:.1f} ms, kernels "
              f"{res['device_kernel_ms']:.1f} ms (busy "
              f"{res['device_busy_share']:.1%})", flush=True)
        for cat, ms in sorted(res["kernel_ms_by_category"].items(),
                              key=lambda kv: -kv[1]):
            print(f"  {cat:12s} {ms:8.1f} ms", flush=True)
        for phase, cats in res["kernel_ms_by_phase"].items():
            print(f"  {phase:10s} " + "  ".join(
                f"{c} {ms:.1f}" for c, ms in sorted(
                    cats.items(), key=lambda kv: -kv[1])) + " (ms)",
                  flush=True)
        for rng in RANGES:
            print(f"  {rng:16s} host {res['range_host_ms'].get(rng, 0):8.1f}"
                  f" ms, device span "
                  f"{res['range_device_span_ms'].get(rng, 0):8.1f} ms",
                  flush=True)
        for k in res["top_kernels"]:
            print(f"  {k['ms']:8.2f} ms x{k['count']:<5d} {k['name']}",
                  flush=True)
        results.append(res)
    print(json.dumps({"card": smi.stdout.strip(), "profiles": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
