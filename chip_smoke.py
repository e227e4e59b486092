#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure stops the run with a non-zero exit and no result):

1. build   — compiles every CUDA kernel of the port from
             dstack_tpu_torch/ops/csrc/ with nvcc (sm_90a), one nvcc per
             source, all at once.
2. kernels — holds the paged-decode kernel (bf16 and int8 pages) to its
             plain PyTorch version at the serving path's shapes (Llama-3-8B:
             D=128; Llama-3.2-1B: D=64) and at four sets of lengths (ragged,
             one split, lengths ending mid-split, all slots full), timing it
             and its SDPA yardstick as device time with the stream held (the
             host off the critical path, L2 flushed before each call) beside
             the wrapper's host time per call, and at several split counts
             (ragged, full); the same at the kv heads a rank holds under
             a tensor-parallel mesh (Llama-3-8B at tensor=2: Hkv 4, G 4;
             at tensor=4: Hkv 2, G 4; Llama-3-70B at tensor=4: Hkv 2,
             G 8), timed and reported where phase 13 runs them on this
             host's cards; then at further head shapes and block sizes
             (correctness only); and the causal flash-attention
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
             and that the kernel ran once per layer per decode step.  Then
             (its numbers taken) a prefill-leg request and a decode-leg
             request carrying its prefill_result, /traces and
             /traces/{id} of a finished request, /drain (503 while
             draining, drained turns true) and {"drain": false}.
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
8. resume  — run_train_loop on Llama-3.2-1B cut to 4 layers (b8 s1024,
             selective remat) three times on one fixed batch sequence:
             8 steps uninterrupted under TrainTelemetry; with snapshots
             every 2 steps in a PreemptionGuard and a real SIGTERM after
             step 5; killed by an exception after step 7.  Fails unless
             the SIGTERM run returns "preempted" with step 5 published,
             the guard is uninstalled after it, the periodic snapshot of
             step 4 equals the state after step 4 and the restore of step
             5 the preempted state (bitwise, moments and AdamW's count
             included), the resumed steps 6-8 give the uninterrupted
             run's losses (relative 1e-3), a resume after the kill comes
             from step 6, the telemetry's median step (its tokens/s and
             MFU) is within 10% of the phase's own median step and its
             gauges hold the last step's rates, and the flash kernels
             launched layers x steps (x2 forward) over the phase.  Prints the
             snapshot's bytes, the copy and write seconds of each save,
             the restore's seconds.
9. hf-import — writes Llama-3.2-1B (full size, random bf16 weights from a
             seed, llama3 rope scaling, tied) as an HF checkpoint in two
             safetensors shards and loads it with load_hf_llama.  Fails
             unless config_from_hf gives that config, every loaded leaf
             equals its source (transposed where HF stores [out, in]),
             and a paged engine over the loaded weights decodes greedy
             tokens through the paged-decode kernel, each the plain
             forward's argmax (as phase 5).  Prints the load's seconds
             and GB/s.
10. serving-features — Llama-3-8B (full size, random bf16 weights from
             seed 1, shared by every engine; batch 8, max_len 1024):
             prefix caching (paged, chunks of 512: after a miss, a wave
             of 7 hits on a 512-token prefix, admitted in chunks, must
             reuse 16 blocks each, and a wave of 7 on a 256-token prefix,
             each prefilled whole, 8 blocks each; every hit prefills only
             its suffix); n-gram speculation (dense, k = 2: a sampled
             request takes the plain window, eight repeating prompts must
             see drafts accepted) against the plain window's decode rate;
             int4 KV (quantize_kv4 on the card equal to the CPU's, dense
             and paged engines beside bf16 ones, the kernel never
             launched on int4 pages, decode rates at eight slots of 64
             tokens); a 300-token prefill_export through the wire codec
             (bitwise) installed into a paged engine.  The kernel
             launches exactly layers x decode steps on the prefix and PD
             paths; every greedy token is checked against a plain forward
             (0.1 std; int4 INT4_GAP_STD).  Decode rates run from the
             last first token to the last token, prefills left out.
11. moe     — Mixtral-8x7B (full width and depth, random weights from a
             seed) with int8 weights, drawn and quantized a matrix at a
             time (the bf16 tree does not fit the card), served paged
             (batch 8, max_len 1024, chunks of 512, capacity factor 4.0:
             dropless): a 64-token prompt alone (TTFT), eight prompts of
             64 tokens (the decode rate at a full batch), a 700-token
             prompt in two chunks (the second padded, its pads masked
             out of routing); the paged-decode kernel launches exactly
             layers x decode steps.  Then its layers at 8 deep with bf16
             experts on a dense cache, the same requests.  Every greedy
             token is held to moe.forward on the same weights, routed
             as the engine routed where the two differ (each such flip on
             a router near-tie: MOE_TIE_EPS), within 0.1 std.
             Then training at Mixtral width, 2 layers, b4 s2048, remat:
             6 steps (loss falls, aux loss finite, flash launches exact)
             and one step through the kernels against one through
             flash_attention_plain (TRAIN_PLAIN_RTOL).  Prints TTFT,
             decode rate and step, train step and tokens/s (no MFU: the
             parameter count holds all 8 experts, a token uses 2), peak
             memory.
12. sharded — (run right after phase 8) in fresh processes, one rank
             per visible card, each forming its process group with the
             port's initialize(force=True) from the control plane's
             variables (DSTACK_MASTER_NODE_IP,
             DSTACK_NODES_NUM, DSTACK_NODE_RANK, DSTACK_GPUS_PER_NODE, a
             free DSTACK_COORDINATOR_PORT; LOCAL_RANK per rank): NCCL,
             build_mesh(MeshSpec.auto(world)), the default ShardingPolicy.
             On one card the world is 1 rank and every mesh axis 1; the
             path is the sharded one all the same (DTensor state, the
             layout's gathers, flash_attention_sharded).  The Llama-3-8B
             layer geometry at 6 layers (b4 s2048, selective remat) 3
             steps unsharded and 3 sharded from the same seed and batch;
             Llama-3.2-1B at 4 layers (b8 s1024) 5 steps unsharded, 3
             sharded through run_train_loop with an AsyncCheckpointer
             snapshot of step 3, resume_train_state onto the mesh (bitwise
             equal to the state on the card), 2 more sharded steps.  Fails
             unless every sharded loss is within 1e-3 and grad norm within
             5e-3 of the unsharded step's, the resumed losses within 1e-3
             of the uninterrupted run's, the backend is nccl and the flash
             kernels launched exactly layers x steps (x2 forward) on the
             sharded steps.  Prints each step's median and tokens/s both
             ways, and the snapshot's copy, writer and restore seconds.
             Then its MoE part (sharded_moe): Mixtral width at 2 layers
             (b4 s2048, remat) 3 steps unsharded and 3 on the mesh
             MeshSpec(expert=world) from one seed, each rank its stripe
             and its experts, the routing the global batch's, each step
             after the first from the unsharded run's state (free-running
             runs of these steps differ by more than the limits); losses
             within 1e-3, grad norms within 5e-3, after each step every
             parameter and AdamW first moment within MOE_UPDATE_RTOL of
             the unsharded update (its own spread, a second unsharded
             first step, printed), K1/K2 launches exactly layers x steps
             (x2 forward).
13. mesh-serving — Llama-3-8B (full size, seed 1, batch 8, max_len
             1024, paged) on one card, bf16 and int8 pages, beside the
             same weights served under a mesh: (a) the world of the
             visible cards under NCCL — on one card a group of one in
             this process (MeshSpec(tensor=1): the sharded engine with
             every axis 1), on N cards N rank processes at tensor=N and
             the server's --tensor-parallel N over HTTP; (b) two rank
             processes sharing the one card under gloo
             (NCCL refuses two ranks on one device; gloo serves them):
             Llama-3-8B at tensor=2 (each rank 4
             KV heads: K5 at Hkv 4, G 4), then Mixtral-8x7B at 8 layers
             in bf16 at expert=2 (seed 3), rank 0 driving, rank 1
             following it in lockstep.  On four cards (or eight) the
             NCCL world also serves Llama-3-70B at tensor=N and
             Mixtral-8x7B in bf16 at expert=N at full depth (timed), each
             beside the same model cut to MESH_CUT_LAYERS / 8 layers
             (held).  Every held engine's greedy tokens are held to the
             plain forward of the same seed's weights on one card within
             0.1 std (Mixtral: moe_check_tokens with rank 0's routing
             replayed), K5 launches exactly layers x decode steps on
             every rank and counts in the row of its shape, and each
             follower checks every token array rank 0 produced equal to
             its own.  Prints each engine's decode step and TTFT beside
             the one-card engine's.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Needs one CUDA card; exits non-zero without
one, or when run outside a checkout of the repository.

    python3 chip_smoke.py --wrapper-host

prints only the paged-decode wrapper's host µs per call (see
wrapper_host_report).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
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
#: K5's shapes under a tensor-parallel mesh, each rank on its Hkv / tensor
#: kv heads (D=128): name -> (kv heads, query heads per kv head).  Held to
#: the plain version at every case of paged_cases; those the mesh-serving
#: phase runs on this host's cards are also timed and reported as rows
K5_MESH_SHAPES = {"llama3-8b/tensor=2": (4, 4), "llama3-8b/tensor=4": (2, 4),
                  "llama3-70b/tensor=4": (2, 8)}
#: device cycles the stream is held for while the host queues timed calls
#: (~0.1 s at the H100's clock; the host's queuing must end before it)
HOLD_CYCLES = 200_000_000
#: timed calls of the kernel and of its yardstick per case
PAGED_ITERS = 100
#: bytes read between timed calls to evict the pages from the 50 MB L2, as
#: the other layers' weights do between two calls of a decode step (read,
#: not written: dirty lines would add their write-back to the next call)
FLUSH_BYTES = 128 << 20
#: further (query heads per kv head, head_dim, page rows) the paged-decode
#: kernel is held to, for correctness only, at the ragged lengths cut to
#: the table: the tiny config's G=2 D=16, head dims that are no power of
#: two, two blocks of 8 query rows (G=16, G=12), D=256, block sizes that
#: are no power of two
PAGED_EDGE_SHAPES = ((2, 16, 32), (5, 48, 32), (16, 32, 32), (12, 80, 24),
                     (4, 256, 32), (1, 112, 16), (4, 128, 24))
#: split counts the paged-decode kernel is also held and timed at (ragged
#: and full cases; the wrapper picks one of them)
SPLIT_SWEEP = (1, 2, 4, 6, 8, 16)
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
#: resume phase: the Llama-3.2-1B trainer (full width, b8 s1024,
#: selective remat, unstacked) cut to 4 layers, so that one snapshot of
#: bf16 params and moments is ~3 GB (full depth: ~7.4 GB, kept twice);
#: the uninterrupted run's steps, the step after which a real SIGTERM
#: preempts the checkpointed run, and the step after which the host-kill
#: run raises (snapshots every 2 steps, the last 2 kept)
RESUME_LAYERS = 4
RESUME_STEPS = 8
RESUME_PREEMPT_AFTER = 5
RESUME_KILL_AFTER = 7
#: the resumed run's losses against the uninterrupted run's, relative:
#: the two runs cannot agree bitwise, since K4's dq is added by TMA
#: reduce-adds in no fixed order
RESUME_LOSS_RTOL = 1e-3
#: TrainTelemetry's median step (its tokens/s and MFU) against the
#: phase's own median step (host clock between the loop's step
#: callbacks); medians, since one step on a busy host can be far off
TELEMETRY_RTOL = 0.10
#: phase 12, sharded training: steps of each trainer on the mesh, the 1B
#: trainer's depth there, the steps it takes after its snapshot's restore,
#: and the seconds the ranks get in all
SHARDED_STEPS = 3
SHARDED_1B_LAYERS = 4
SHARDED_RESUME_STEPS = 2
SHARDED_TIMEOUT_S = 420
#: hf-import phase: Llama-3.2-1B (full width and depth) in HF's layout,
#: random bf16 weights from a seed, written in this many safetensors
#: shards, with Llama-3.2-1B's published llama3 rope scaling
HF_SHARDS = 2
HF_ROPE_SCALING = {"rope_type": "llama3", "factor": 32.0,
                   "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                   "original_max_position_embeddings": 8192}
#: f32 logits from bf16 inputs: max error over the largest logit (f32
#: sums in another order give ~1e-6; bf16 rounding of the output, ~4e-3,
#: must not pass)
F32_LOGITS_RTOL = 1e-4
#: calls replayed per hold of the stream in the share phase
REPLAY_CHUNK = 128
# int4 KV engines: each greedy token within this many standard deviations
# of the logits below the plain bf16 forward's argmax.  The CPU parity test
# (tests/test_torch_serving_features.py) measures the tiny f32 int4
# engines' worst gap at 0.198 std and holds it to the same margin; 0.5 is
# ~2.5x that, room for bf16's own near-ties (0.1) and the 8B's depth.
INT4_GAP_STD = 0.5
#: moe phase: Mixtral-8x7B served whole with int8 weights (paged, block
#: 32, batch 8, max_len 1024, chunks of 512); its layers at 8 deep with
#: bf16 experts (dense cache); trained at 2 layers, b4 s2048, remat.
#: Served at capacity factor 4.0 (= E / k: dropless at any length), so
#: that the forward and per-token decode route alike, as the JAX package's
#: MoE serving tests set it
MOE_SERVE_CAPACITY_FACTOR = 4.0
MOE_BF16_LAYERS = 8
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 4, 2048, 6
#: phase 12's MoE part: after each sharded step, the largest difference of
#: a parameter leaf (and of its AdamW first moment) from this rank's block
#: of the unsharded state, over the norm of that leaf's unsharded update.
#: The first moment is the gradient's record; the parameters move by
#: AdamW's first update, lr * sign(g) wherever |g| >> eps, so a gradient
#: element near zero that rounding turns over moves its parameter by 2 lr.
#: The unsharded first step run twice from the seed's state differed by
#: 0.0224 (parameters) and 0.00257 (first moments) on an H100 (700 W), the
#: sharded steps of a world of one by 0.0226 / 0.00263 at most: each limit
#: is ~4x that.  A sharded step that halves one leaf's gradient after the
#: norm gives 0.5 on that leaf's moment; a lost update 1 on its parameter
MOE_UPDATE_RTOL = {"param": 0.1, "exp_avg": 0.01}
#: the same on more than one rank.  There the experts' outputs are summed
#: by an all-reduce of each rank's bf16 partial sum, rounded otherwise than
#: the unsharded einsum, so the next layer's router logits differ and
#: near-ties take other experts (bf16 tiny_moe on the CPU at expert=4:
#: logits up to 0.019 apart, 12 of 2048 tokens routed otherwise in layer
#: 1; none in f32), and each such token changes its router gradient by a
#: whole term.  Measured at expert=4: four H100s (700 W) 0.342 / 0.0959
#: (layer 1's router, step 1), the CPU's bf16 tiny_moe 0.279 / 0.126;
#: each limit is ~2x the larger
MOE_UPDATE_RTOL_MESH = {"param": 0.7, "exp_avg": 0.25}
#: the long prompt: one chunk of 512, then 188 tokens in a 256 bucket, so
#: padding is masked out of routing
MOE_LONG_PROMPT = 700
#: routing near-ties.  A decode step's hidden state differs from the full
#: forward's by bf16 rounding, and where a token's k-th and (k+1)-th
#: router logits nearly tie the engine may take other experts than the
#: forward; that is routing, not a fault.  The check replays the engine's
#: routing in the forward wherever the two differ; then the engine's
#: router logits must be within MOE_TIE_EPS of the forward's at every
#: position and layer, and each flip must sit on a forward gap below it.
#: From bf16's unit roundoff u = 2^-8: after L = 32 layers of bf16
#: residual adds the two paths' hidden states differ by about sqrt(L) u
#: relative, and router logits are unit-scale sums of them (rms-normed
#: hiddens, fan-in-scaled router), so each differs by about sigma =
#: sqrt(L) u = 0.022; the largest of a run's ~5e5 logits by about 5 sigma
#: = 0.11, a gap (a difference of two) by about 0.16.  The limit, 2^-2,
#: is 1.6x that.  Measured on an H100 (700 W): 0.091 at most, flips on
#: gaps up to 0.087 (int8, 32 layers, attention dequantized for the
#: forward); 0.061 and 0.042 (bf16, 8 layers).
MOE_TIE_EPS = 2.0 ** -2
#: the server phase's prompt, also sent in process by the share phase
PROMPT = ("The paged KV cache keeps each request's keys and values in "
          "fixed-size blocks; request number {i} asks about it.")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# -- phase 2: kernel against its plain version -------------------------------


def paged_cases(num_sms: int, hkv: int = HKV) -> dict:
    """case -> (lengths of the 8 slots, table columns walked): the ragged
    burst; a table of 2 columns (one split, no merge); lengths ending
    inside a split, on its boundaries and past it at the split count this
    card gets at ``hkv`` kv heads; every slot full (the served
    configuration's worst case)."""
    from dstack_tpu_torch.ops import flash_attention as fa

    splits = fa.paged_decode_splits(NBK, B, hkv, num_sms)
    rows = -(-NBK // splits) * BS  # rows a split walks
    mid = [0, rows - 1, rows, rows + 1, rows + rows // 2 + 3,
           2 * rows + 17, NBK * BS - rows // 2, NBK * BS - 5]
    return {"ragged": (LENGTHS, NBK),
            "one-split": ([min(n, 2 * BS) for n in LENGTHS[:5]] + [40, 63,
                                                                    64], 2),
            "mid-split": ([min(n, NBK * BS) for n in mid], NBK),
            "full": ([NBK * BS] * B, NBK)}


def make_case(torch, d: int, quant: bool, seed: int, lengths=LENGTHS,
              nbk: int = NBK, g: int = G, bs: int = BS, hkv: int = HKV):
    from dstack_tpu_torch.serving.quant import quantize_kv

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    nb = B * NBK + 1
    q = torch.randn((B, hkv, g, d), generator=gen, device=dev).to(
        torch.bfloat16)
    kp = torch.randn((nb, bs, hkv, d), generator=gen, device=dev).to(
        torch.bfloat16)
    vp = torch.randn((nb, bs, hkv, d), generator=gen, device=dev).to(
        torch.bfloat16)
    # each slot owns distinct random pages; the table is twice as wide as
    # the walk and sliced, as the engine's ragged bucket is
    perm = torch.randperm(nb - 1, generator=gen, device=dev).to(
        torch.int32) + 1
    tables = torch.zeros((B, 2 * NBK), dtype=torch.int32, device=dev)
    for b, n in enumerate(lengths):
        owned = -(-n // bs)
        tables[b, :owned] = perm[b * NBK:b * NBK + owned]
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if quant:
        kq, ks = quantize_kv(kp)
        vq, vs = quantize_kv(vp)
        kp, vp = {"q": kq, "s": ks}, {"q": vq, "s": vs}
    return q, kp, vp, tables[:, :nbk], lengths


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


def held_span(torch, body, iters: int):
    """(device ms, host ms) of ``iters`` calls of ``body`` queued while
    the stream is held by ``torch.cuda._sleep``, between two CUDA events:
    the device runs them back to back, so the span is the device's work
    and the launch gaps between the kernels, never the host's queuing."""
    body()
    torch.cuda.synchronize()
    held, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    held.record()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        body()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    held_ms = held.elapsed_time(start)
    if host_ms >= held_ms:
        fail(f"the host took {host_ms:.1f} ms to queue {iters} calls, longer "
             f"than the stream was held ({held_ms:.1f} ms)")
    return start.elapsed_time(end), host_ms


def device_ms(torch, fn, iters: int, flush=None, flush_span=0.0) -> float:
    """Device ms per call of ``fn`` (see :func:`held_span`).  With
    ``flush``, each call follows a flush of the L2, and ``flush_span``, the
    span of ``iters`` flushes alone, is taken off."""
    if flush is None:
        return held_span(torch, fn, iters)[0] / iters
    both = held_span(torch, lambda: (flush(), fn()), iters)[0]
    return (both - flush_span) / iters


def wrapper_host_ms(torch, fn, iters: int) -> float:
    """Host ms per call of ``fn``, queued while the stream is held."""
    return held_span(torch, fn, iters)[1] / iters


def bound(d: int, quant: bool, lengths=LENGTHS, hkv: int = HKV, g: int = G):
    """Least time for this call's work: each input byte the function needs
    read once (q, the K/V rows below each length, their scales, the table
    entries walked, the lengths), each output byte written once, against
    4 * sum(length) * Hq * D operations (QK and PV, two per MAC) in bf16."""
    hq = hkv * g
    rows = sum(lengths)
    elem = 1 if quant else 2
    kv = 2 * rows * hkv * d * elem + (2 * rows * hkv * 4 if quant else 0)
    pages = sum(-(-n // BS) for n in lengths)
    nbytes = (B * hq * d * 2 + kv + pages * 4 + B * 4
              + B * hq * d * 4 + B * hq * 4)
    flops = 4 * rows * hq * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def errors(torch, fa, args):
    """Largest |o| and |lse| differences of the wrapper against the plain
    version on ``args``, and whether every empty slot gave o = 0, lse =
    -1e30 exactly (True where no slot is empty)."""
    o, lse = fa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    want_o, want_lse = fa.paged_decode_attention_plain(*args)
    err_o = (o - want_o).abs().max().item()
    err_lse = (lse - want_lse).abs().max().item()
    empty = args[4] == 0
    empty_ok = bool(torch.all(o[empty] == 0)
                    and torch.all(lse[empty] == -1e30))
    return err_o, err_lse, empty_ok


def checked_errors(torch, fa, args, label: str):
    """:func:`errors`, failing the run past O_ATOL, LSE_ATOL or the
    empty-slot sentinel."""
    err_o, err_lse, empty_ok = errors(torch, fa, args)
    if not (err_o <= O_ATOL and err_lse <= LSE_ATOL):
        fail(f"kernel {label}: disagrees with the plain version: max |o| "
             f"err {err_o}, max |lse| err {err_lse}")
    if not empty_ok:
        fail(f"kernel {label}: an empty slot is not o=0, lse=-1e30")
    return err_o, err_lse


def split_sweep(torch, fa, args, flush, flush_span, label: str) -> dict:
    """K5's device µs per call at each count of SPLIT_SWEEP (timed as
    :func:`check_kernels` times it), each result held to the plain
    version first."""
    q, kp, vp, tables, lengths = args
    kq, ks = fa._pages(kp)
    vq, vs = fa._pages(vp)
    want_o, want_lse = fa.paged_decode_attention_plain(*args)
    out = {}
    for splits in SPLIT_SWEEP:
        def run():
            return fa._paged_decode_kernel(q, kq, ks, vq, vs, tables,
                                           lengths, None, splits)

        o, lse = run()
        torch.cuda.synchronize()
        err_o = (o - want_o).abs().max().item()
        err_lse = (lse - want_lse).abs().max().item()
        if not (err_o <= O_ATOL and err_lse <= LSE_ATOL):
            fail(f"kernel {label} at {splits} splits: disagrees with the "
                 f"plain version: max |o| err {err_o}, max |lse| err "
                 f"{err_lse}")
        out[splits] = device_ms(torch, run, PAGED_ITERS, flush,
                                flush_span) * 1e3
    return out


def sdpa_yardstick(torch, args, d: int, nbk: int):
    """One library attention call over the gathered, dequantized view of
    the pages (the port never calls it): the K5 yardstick."""
    import torch.nn.functional as F

    q, kp, vp, tables, lengths = args
    _, hkv, g, _ = q.shape
    idx = tables.long()

    def dense(pages):
        if isinstance(pages, dict):
            rows = (pages["q"][idx].float()
                    * pages["s"][idx][..., None]).to(torch.bfloat16)
        else:
            rows = pages[idx]
        return rows.reshape(B, nbk * BS, hkv, d).transpose(1, 2)

    kd, vd = dense(kp), dense(vp)
    qd = q.reshape(B, hkv * g, 1, d)
    mask = (torch.arange(nbk * BS, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True)


def check_kernels(torch, mesh_rows=None) -> tuple:
    """K5 against its plain version at every case of :func:`paged_cases`,
    both head dims and both page types, and at K5_MESH_SHAPES and the
    shapes of ``mesh_rows`` (:func:`mesh_k5_rows`: those the mesh-serving
    phase runs here); each case of SHAPES and of ``mesh_rows`` timed as
    device time (stream held, L2 flushed before each call) beside SDPA's,
    its bound and the wrapper's host time per call, the ragged and full
    cases also at each split count of SPLIT_SWEEP.  Then K5 against its
    plain version at PAGED_EDGE_SHAPES.  Returns the kernels' JSON
    entries (the ragged case's numbers, as earlier runs reported: every
    page type of SHAPES, the page types ``mesh_rows`` names) and every
    case's numbers."""
    from dstack_tpu_torch.ops import flash_attention as fa

    flush_buf = torch.zeros(FLUSH_BYTES // 4, device="cuda")
    flush = flush_buf.sum
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    out, timings = {}, {}
    mesh_rows = mesh_rows or {}
    shapes = {shape: (d, HKV, G, {"bf16", "int8"})
              for shape, d in SHAPES.items()}
    shapes.update({shape: (128, hkv, g, set())
                   for shape, (hkv, g) in K5_MESH_SHAPES.items()})
    shapes.update({shape: (128, *row) for shape, row in mesh_rows.items()})
    for shape, (d, hkv, g, reported) in shapes.items():
        timed = bool(reported)
        cases = paged_cases(num_sms, hkv)
        for quant in (False, True):
            variant = "int8" if quant else "bf16"
            name = f"paged_decode_attention[{variant},{shape}]"
            for case, (lengths, nbk) in cases.items():
                args = make_case(torch, d, quant, seed=d + quant + HKV - hkv + g - G,
                                 lengths=lengths, nbk=nbk, g=g, hkv=hkv)
                label = f"{variant} D={d} Hkv={hkv} G={g} {case}"
                err_o, err_lse = checked_errors(torch, fa, args, label)
                splits = fa.paged_decode_splits(nbk, B, hkv, num_sms)
                if not timed:
                    timings[f"{name}[{case}]"] = {
                        "max_abs_err": err_o, "max_abs_err_lse": err_lse,
                        "splits": splits}
                    log(f"kernel {name} {case} (splits {splits}): max|o "
                        f"err| {err_o:.3e} max|lse err| {err_lse:.3e}")
                    continue

                def kernel():
                    fa.paged_decode_attention(*args)

                sdpa = sdpa_yardstick(torch, args, d, nbk)
                flush_span = held_span(torch, flush, PAGED_ITERS)[0]
                ms = device_ms(torch, kernel, PAGED_ITERS, flush, flush_span)
                library_ms = device_ms(torch, sdpa, PAGED_ITERS, flush,
                                       flush_span)
                warm_ms = device_ms(torch, kernel, PAGED_ITERS)
                host_ms = wrapper_host_ms(torch, kernel, PAGED_ITERS)
                bound_ms, bound_by, nbytes, flops = bound(d, quant, lengths,
                                                          hkv, g)
                row = {"max_abs_err": err_o, "max_abs_err_lse": err_lse,
                       "splits": splits, "ms": ms, "warm_l2_ms": warm_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "of_bound": bound_ms / ms,
                       "x_sdpa": ms / library_ms,
                       "wrapper_host_us": host_ms * 1e3}
                log(f"kernel {name} {case} (splits {splits}): max|o err| "
                    f"{err_o:.3e} max|lse err| {err_lse:.3e}  kernel "
                    f"{ms * 1e3:.2f} us (warm L2 {warm_ms * 1e3:.2f})  sdpa "
                    f"{library_ms * 1e3:.2f} us  bound {bound_ms * 1e3:.2f} "
                    f"us by {bound_by} ({nbytes} B, {flops} flop), "
                    f"{bound_ms / ms:.3f} of it, {ms / library_ms:.2f}x sdpa"
                    f"  wrapper host {host_ms * 1e3:.1f} us/call")
                if case in ("ragged", "full"):
                    sweep = split_sweep(torch, fa, args, flush, flush_span,
                                        label)
                    row["split_sweep_us"] = sweep
                    log(f"kernel {name} {case}: us at splits " + ", ".join(
                        f"{n}{'*' if n == splits else ''} {us:.2f}"
                        for n, us in sweep.items()))
                timings[f"{name}[{case}]"] = row
                if case != "ragged" or variant not in reported:
                    continue
                plain_ms = time_ms(
                    torch, lambda: fa.paged_decode_attention_plain(*args), 20)
                log(f"kernel {name} ragged: plain {plain_ms * 1e3:.1f} us")
                out[name] = {
                    "name": name, "route": "cuda", "source": SOURCE,
                    "replaces": REPLACES, "launches": 0,
                    "max_abs_err": err_o, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms,
                }
            del args
    del flush_buf
    for g, d, bs in PAGED_EDGE_SHAPES:
        for quant in (False, True):
            variant = "int8" if quant else "bf16"
            lengths = [min(n, NBK * bs) for n in LENGTHS]
            args = make_case(torch, d, quant, seed=g + d + bs + quant,
                             lengths=lengths, g=g, bs=bs)
            label = f"{variant} G={g} D={d} BS={bs}"
            err_o, err_lse = checked_errors(torch, fa, args, label)
            timings[f"paged_decode_attention[{variant},G={g},D={d},"
                    f"BS={bs}]"] = {"max_abs_err": err_o,
                                    "max_abs_err_lse": err_lse}
            log(f"kernel paged_decode_attention {label}: max|o err| "
                f"{err_o:.3e} max|lse err| {err_lse:.3e}")
            del args
    torch.cuda.empty_cache()
    return out, timings


def wrapper_host_report(torch) -> dict:
    """The wrapper's host µs per call at the ragged case of each shape and
    page type, five times each, queued with the stream held and no events
    among the calls (:func:`wrapper_host_ms`).  It calls nothing but
    ``paged_decode_attention``, so ``chip_smoke.py --wrapper-host`` copied
    into another checkout's root and run there times that checkout's
    wrapper the same way."""
    from dstack_tpu_torch.ops import flash_attention as fa

    out = {}
    for shape, d in SHAPES.items():
        for quant in (False, True):
            args = make_case(torch, d, quant, seed=d + quant)
            out[f"{'int8' if quant else 'bf16'},{shape}"] = [
                wrapper_host_ms(torch,
                                lambda: fa.paged_decode_attention(*args),
                                PAGED_ITERS) * 1e3 for _ in range(5)]
            del args
    torch.cuda.empty_cache()
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


def http(url: str, payload=None, timeout: float = 600.0, headers=None):
    """(status, body bytes, headers) of a GET (no payload) or a JSON POST;
    an HTTP error's status, body and headers too."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, method="GET" if payload is None else "POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as err:
        return err.code, err.read(), err.headers


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
    status = http(base + "/v1/completions",
                  {"prompt": "warm up", "max_tokens": 4})[0]
    if status != 200:
        fail(f"warm-up request answered {status}")
    # time to first token on an idle server: a one-token completion is a
    # prefill plus the first token's sampling (the random model's tokens are
    # mostly ids the byte tokenizer prints as nothing, so a stream's first
    # event would come only at its end)
    ttfts = []
    for i in range(3):
        t = time.time()
        status, body, _ = http(base + "/v1/completions",
                               {"prompt": PROMPT.format(i=i), "max_tokens": 1})
        ttfts.append(time.time() - t)
        if status != 200 or json.loads(body)["usage"][
                "completion_tokens"] != 1:
            fail(f"one-token completion failed: {status} {body[:200]}")
    before = json.loads(http(base + "/stats")[1])
    results = [dict() for _ in range(5)]

    def complete(i):
        t = time.time()
        status, body, _ = http(base + "/v1/completions", {
            "prompt": PROMPT.format(i=i), "max_tokens": 64})
        out = json.loads(body)
        results[i].update(status=status, wall=time.time() - t,
                          tokens=out["usage"]["completion_tokens"])

    def chat(i):
        t = time.time()
        status, body, _ = http(base + "/v1/chat/completions", {
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
    status, metrics, _ = http(base + "/metrics")
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
    out["features"] = drive_server_features(base, layers)
    return out


def http_json(url: str, payload=None, headers=None):
    """(status, JSON body, headers) of :func:`http`."""
    status, body, got = http(url, payload, headers=headers)
    return status, json.loads(body), got


def drive_server_features(base: str, layers: int) -> dict:
    """The replica's routes of phase 10, on the served 8B: a prefill-leg
    request and a decode-leg request carrying its prefill_result (its 16
    tokens' text must equal a colocated request's: both legs run the same
    prefill forward, the wire is bitwise and greedy decoding is
    deterministic), /traces and /traces/{id} of a finished request (404
    for an unknown id), /drain (a new completion gets 503; drained turns
    true) and {"drain": false} (completions are accepted again)."""
    from dstack_tpu_torch.serving.wire import PD_PHASE_HEADER, TRACE_ID_HEADER

    payload = {"prompt": PROMPT.format(i=5), "max_tokens": 16}
    t0 = time.time()
    status, result, _ = http_json(base + "/v1/completions", payload,
                                  {PD_PHASE_HEADER: "prefill"})
    prefill_s = time.time() - t0
    if status != 200 or result.get("object") != "prefill_result":
        fail(f"http pd: the prefill leg answered {status}")
    if (result["kv_k"]["dtype"] != "bfloat16"
            or result["kv_k"]["shape"][0] != layers):
        fail(f"http pd: prefill_result kv_k is {result['kv_k']['shape']} "
             f"{result['kv_k']['dtype']}")
    body = dict(payload, prefill_result=result)
    t0 = time.time()
    status, decoded, _ = http_json(base + "/v1/completions", body,
                                   {PD_PHASE_HEADER: "decode"})
    decode_s = time.time() - t0
    if status != 200 or decoded["usage"]["completion_tokens"] != 16:
        fail(f"http pd: the decode leg answered {status} {decoded}")
    colocated = http_json(base + "/v1/completions", payload)[1]
    if decoded["choices"][0]["text"] != colocated["choices"][0]["text"]:
        fail(f"http pd: the decode leg's text "
             f"{decoded['choices'][0]['text']!r} is not the colocated "
             f"request's {colocated['choices'][0]['text']!r}")
    out = {"pd_prefill_s": prefill_s, "pd_decode_s": decode_s,
           "pd_body_bytes": len(json.dumps(body))}

    _, _, headers = http(base + "/v1/completions",
                         {"prompt": "trace me", "max_tokens": 4})
    trace_id = headers[TRACE_ID_HEADER]
    status, summary, _ = http_json(base + "/traces")
    if status != 200 or trace_id not in {t["trace_id"]
                                         for t in summary["traces"]}:
        fail(f"http traces: /traces answered {status} without {trace_id}")
    status, detail, _ = http_json(base + "/traces/" + trace_id)
    names = {sp["name"] for sp in detail.get("spans", [])}
    if status != 200 or "engine.request" not in names:
        fail(f"http traces: /traces/{trace_id} answered {status} {names}")
    if http(base + "/traces/" + "0" * 32)[0] != 404:
        fail("http traces: an unknown trace id did not answer 404")
    out["trace_spans"] = sorted(names)

    status, drain, _ = http_json(base + "/drain", {})
    if status != 200 or drain["status"] != "draining":
        fail(f"http drain: /drain answered {status} {drain}")
    refused = http(base + "/v1/completions",
                   {"prompt": "x", "max_tokens": 2})[0]
    if refused != 503:
        fail(f"http drain: a completion while draining answered {refused}")
    t0 = time.time()
    while not http_json(base + "/drain", {})[1]["drained"]:
        if time.time() - t0 > 60:
            fail("http drain: not drained within 60 s")
        time.sleep(0.2)
    status, undrain, _ = http_json(base + "/drain", {"drain": False})
    if undrain != {"status": "accepting", "drained": False}:
        fail(f"http drain: {{'drain': false}} answered {status} {undrain}")
    status, again, _ = http_json(base + "/v1/completions",
                                 {"prompt": "x", "max_tokens": 2})
    if status != 200 or again["usage"]["completion_tokens"] != 2:
        fail(f"http drain: a completion after undrain answered {status}")
    log("server features: " + json.dumps(out))
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
    queued the chunk: each replayed pair spans the kernels alone.  The
    chunk is then queued once more, held, without events: the host's
    queuing time over those calls is the wrapper's host time.  The
    kernel's time depends on
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
        chunk_calls = calls[first:first + REPLAY_CHUNK]
        chunk = [event_pair() for _ in chunk_calls]
        held = torch.cuda.Event(enable_timing=True)
        held.record()
        torch.cuda._sleep(400_000_000)  # ~0.2 s of device clock cycles
        t_host = time.perf_counter()
        for pair, (q, kp, vp, tables, lengths, kw) in zip(chunk,
                                                          chunk_calls):
            pair[0].record()
            real(q, kp, vp, tables, lengths, **kw)
            pair[1].record()
        chunk_ms = (time.perf_counter() - t_host) * 1e3
        torch.cuda.synchronize()
        chunk_held_ms = held.elapsed_time(chunk[0][0])
        if chunk_ms >= chunk_held_ms:
            fail(f"share: the host took {chunk_ms:.0f} ms to queue "
                 f"{len(chunk)} replays, longer than the stream was held "
                 f"({chunk_held_ms:.0f} ms)")
        replays += chunk
        # the same calls again without events: the wrapper's host time
        torch.cuda._sleep(400_000_000)
        t_host = time.perf_counter()
        for q, kp, vp, tables, lengths, kw in chunk_calls:
            real(q, kp, vp, tables, lengths, **kw)
        enqueue_ms += (time.perf_counter() - t_host) * 1e3
        torch.cuda.synchronize()
    kernel_ms = sum(a.elapsed_time(b) for a, b in replays)
    out = {"decode_steps": steps, "launches": len(pairs),
           "step_wall_ms": wall * 1e3 / steps,
           "kernel_ms_per_step": kernel_ms / steps,
           "kernel_us_per_launch": kernel_ms * 1e3 / len(pairs),
           "kernel_share_of_step": kernel_ms / (wall * 1e3),
           "call_span_us_per_launch": span_ms * 1e3 / len(pairs),
           # the calls queued with the stream held, no events among them
           "wrapper_host_us_per_call": enqueue_ms * 1e3 / len(replays)}
    log("share: " + json.dumps(out))
    del engine, calls
    torch.cuda.empty_cache()
    return out


# -- phase 5: in-process engines ---------------------------------------------


def drive(torch, engine, reqs) -> float:
    """Submit ``reqs`` at once and step the engine until all are done;
    returns the wall seconds (the device synchronised at the end)."""
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    while not all(r.done.is_set() for r in reqs):
        engine.step()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def greedy_gaps(torch, params, cfg, reqs, margin: float, label: str,
                n_tokens: int) -> float:
    """Each request must have ``n_tokens`` tokens, each the plain
    full-sequence forward's argmax (finite logits) up to ``margin``
    standard deviations of the logits; returns the worst gap.  One
    forward a request over its prompt and tokens gives every position's
    logits (causal: position i sees only what precedes token i + 1)."""
    from dstack_tpu_torch.serving.engine import _prompt_forward

    device = params["embed"].device
    worst = 0.0
    for r in reqs:
        if len(r.output) != n_tokens:
            fail(f"{label}: {len(r.output)} tokens, wanted {n_tokens}")
        seq = list(r.tokens) + list(r.output)
        bucket = max(128, 1 << (len(seq) - 1).bit_length())
        padded = torch.zeros(bucket, dtype=torch.long, device=device)
        padded[:len(seq)] = torch.tensor(seq, device=device)
        logits, _, _ = _prompt_forward(params, cfg, padded, len(seq), bucket,
                                       every_position=True)
        logits = logits[len(r.tokens) - 1:-1]
        if not torch.isfinite(logits).all():
            fail(f"{label}: non-finite logits")
        out = torch.tensor(r.output, device=device)[:, None]
        gaps = ((logits.max(-1).values - logits.gather(1, out)[:, 0])
                / logits.std(-1)).tolist()
        i = max(range(n_tokens), key=gaps.__getitem__)
        if gaps[i] > margin:
            fail(f"{label}: token {i} ({r.output[i]}) is {gaps[i]:.3f} std "
                 f"below the plain forward's argmax")
        worst = max(worst, gaps[i])
    return worst


def decode_rate(reqs) -> float:
    """Tokens a second of decode alone: every token after each request's
    first, over the span from the last first token to the last token.
    Requests submitted at once are admitted in one scheduling step, so no
    decode window runs before that span starts."""
    tokens = sum(len(r.output) - 1 for r in reqs)
    return tokens / (max(r.finished_at for r in reqs)
                     - max(r.first_token_at for r in reqs))


#: two prompts whose greedy tokens each engine run checks
ENGINE_PROMPTS = ([(i * 37 + 11) % 256 for i in range(40)],
                  [(i * 91 + 3) % 256 for i in range(75)])
#: eight prompts of 40-110 tokens, one for each slot of a batch-8 engine:
#: the load at which a decode rate is taken
BURST_PROMPTS = tuple([(i * (37 + 6 * p) + 11 + p) % 256
                       for i in range(40 + 10 * p)] for p in range(8))


def run_engine(torch, cfg, kv_quantize, label: str, device: str = "cuda",
               params=None, paged: bool = True, margin=None,
               exact: bool = False, rate: bool = False) -> dict:
    """Decode 12 greedy tokens for each of ENGINE_PROMPTS, submitted at
    once, on an engine (batch 8, max_len 1024) from ``params`` (random
    from seed 1 when None), after a short warm-up request.  Each token
    must be the plain full-sequence forward's argmax up to ``margin`` std
    (by default 0.1 on bf16 KV and 0.25 on int8: bf16 sums in another
    order; int8 pages add their quantization error).  With ``rate``,
    BURST_PROMPTS follow, 64 tokens each, for the decode rate at a full
    batch.  On the card the kernel must launch layers x decode steps on
    bf16/int8 pages (exactly with ``exact``, at least otherwise) and
    never on int4 KV or a dense cache.  Returns the launches and decode
    steps of both runs, the checked run's wall seconds and worst gap,
    and the burst's decode rate."""
    from dstack_tpu_torch.ops import flash_attention as fa
    from dstack_tpu_torch.serving.engine import InferenceEngine, Request

    engine = InferenceEngine(cfg, params=params, batch_size=8, max_len=1024,
                             paged=paged, kv_quantize=kv_quantize, rng_seed=1,
                             device=device)
    drive(torch, engine, [Request(tokens=list(range(40)), max_new_tokens=4)])
    reqs = [Request(tokens=list(p), max_new_tokens=12)
            for p in ENGINE_PROMPTS]
    fa.paged_decode_attention.launches = 0
    steps0 = engine.decode_steps
    wall = drive(torch, engine, reqs)
    out = {"wall_s": wall}
    if rate:
        burst = [Request(tokens=list(p), max_new_tokens=64)
                 for p in BURST_PROMPTS]
        drive(torch, engine, burst)
        if any(len(r.output) != 64 for r in burst):
            fail(f"{label}: a burst request ended short of 64 tokens")
        out["decode_tok_per_s"] = decode_rate(burst)
    launches = fa.paged_decode_attention.launches
    steps = engine.decode_steps - steps0
    want = cfg.num_layers * steps if paged and kv_quantize != "int4" else 0
    if steps <= 0 or device == "cuda" and (
            launches != want if exact or not want else launches < want):
        fail(f"{label}: {launches} kernel launches over {steps} decode "
             f"steps x {cfg.num_layers} layers")
    if margin is None:
        margin = 0.1 if kv_quantize is None else 0.25
    out.update(launches=launches, decode_steps=steps,
               worst_gap_std=greedy_gaps(torch, engine.params, cfg, reqs,
                                         margin, label, 12))
    log(f"engine {label}: " + json.dumps(out))
    del engine
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


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


# -- phase 8: resume ----------------------------------------------------------


class SimulatedHostLoss(Exception):
    """Raised from a step callback: the moral equivalent of a host
    vanishing mid-run."""


def differing(torch, got: list, want: list) -> list:
    """Paths where two lists of (path, tensor) snapshot leaves (params,
    moments, AdamW's count, step) differ, bitwise."""
    if [p for p, _ in got] != [p for p, _ in want]:
        return ["(leaf paths differ)"]
    return [p for (p, a), (_, b) in zip(got, want)
            if a.dtype != b.dtype or not torch.equal(a.to(b.device), b)]


def resume_phase(torch, cfg=None, batch: int = 0, seq: int = 0,
                 device: str = "cuda") -> dict:
    """The resumable trainer: Llama-3.2-1B at 4 layers (b8 s1024, selective
    remat, unstacked) through run_train_loop, three times on one fixed
    batch sequence:

    1. 8 steps uninterrupted, under TrainTelemetry;
    2. with snapshots every 2 steps (the last 2 kept) inside a
       PreemptionGuard, a real SIGTERM sent after step 5: the loop must
       return "preempted" with step 5 published; the periodic snapshot of
       step 4 must equal, bitwise, the state cloned on the card after step
       4 (the next step updates it in place: a torn copy shows here), and
       resume_train_state must restore step 5 bitwise (params, moments,
       AdamW's count); then the run resumes to step 8, whose losses of
       steps 6-8 must be the uninterrupted run's within RESUME_LOSS_RTOL;
    3. an exception from the step callback after step 7: nothing in
       flight is published, and a resume comes from step 6.

    ``cfg``, ``batch`` and ``seq`` default to the chip's; a CPU rehearsal
    passes small ones and ``device="cpu"``."""
    import dataclasses
    import shutil
    import signal
    import tempfile

    from dstack_tpu_torch.models import checkpoint as ckpt
    from dstack_tpu_torch.models import train
    from dstack_tpu_torch.ops import flash_attention as fa
    from dstack_tpu_torch.telemetry.training import TrainTelemetry

    base_cfg, base_batch, base_seq, remat = trainer("llama3-1b")
    if cfg is None:
        cfg = dataclasses.replace(base_cfg, num_layers=RESUME_LAYERS)
        batch, seq = base_batch, base_seq
    opt = train.default_optimizer()
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def batch_fn(step):
        gen = torch.Generator(device=device).manual_seed(1000 + step)
        return {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                                        generator=gen, device=device,
                                        dtype=torch.int32)}

    class Tap(TrainTelemetry):
        """The train telemetry, also keeping each step wall it records and
        the state object the loop's step is given (the step updates it in
        place)."""

        def __init__(self):
            super().__init__(log_every=0)
            self.walls, self.state = [], None

        def record_step(self, wall, tokens, n_devices=1, recompiled=False):
            self.walls.append(wall)
            super().record_step(wall, tokens, n_devices, recompiled)

        def wrap(self, step_fn, cfg=None, n_devices=1):
            timed = super().wrap(step_fn, cfg, n_devices)

            def step(state, b):
                self.state = state
                return timed(state, b)

            return step

    loop_kw = dict(unstacked=True, remat=remat, device=device)
    out = {"num_layers": cfg.num_layers, "batch": batch, "seq": seq}
    fa.flash_attention.fwd_launches = fa.flash_attention.bwd_launches = 0
    root = Path(tempfile.mkdtemp(prefix="chip-smoke-resume-"))
    before = signal.getsignal(signal.SIGTERM)
    try:
        # 1. uninterrupted
        tel, stamps = Tap(), []
        base = train.run_train_loop(
            cfg, opt, batch_fn, steps=RESUME_STEPS, generator=0,
            telemetry=tel,
            on_step=lambda step, m: stamps.append(time.perf_counter()),
            **loop_kw)
        tel.state = None

        def median(xs):
            return sorted(xs)[len(xs) // 2]

        tokens = batch * seq
        step_s = median([b - a for a, b in zip(stamps, stamps[1:])])
        tel_s = median(tel.walls[1:])

        def mfu(wall):
            return 6 * cfg.num_params() * tokens / wall / PEAK_BF16_FLOPS

        out.update(losses=base.losses, step_median_s=step_s,
                   tokens_per_s=tokens / step_s, mfu_6nd=mfu(step_s),
                   telemetry_tokens_per_s=tokens / tel_s,
                   telemetry_mfu=mfu(tel_s),
                   telemetry_last_tokens_per_s=tel.tokens_per_sec.value,
                   telemetry_last_mfu=tel.mfu.value)
        if (tel.steps_total.value != RESUME_STEPS
                or tel.tokens_total.value != RESUME_STEPS * tokens
                or len(tel.walls) != RESUME_STEPS):
            fail(f"resume: telemetry counted {tel.steps_total.value} steps "
                 f"and {tel.tokens_total.value} tokens")
        # the gauges hold the last step's rates; its median step agrees
        # with the host clock between the loop's step callbacks
        for name, got, want in (
                ("tokens/s gauge", tel.tokens_per_sec.value,
                 tokens / tel.walls[-1]),
                ("MFU gauge", tel.mfu.value, mfu(tel.walls[-1])),
                ("median step", tel_s, step_s)):
            if not abs(got / want - 1) <= (
                    TELEMETRY_RTOL if name == "median step" else 1e-9):
                fail(f"resume: telemetry {name} {got:.6g} against "
                     f"{want:.6g}")
        base_losses = base.losses
        del base

        # 2. preempted by a real SIGTERM, then resumed
        tap, clones = Tap(), {}

        def preempt(step, metrics):
            if step == RESUME_PREEMPT_AFTER - 1:
                clones["leaves"] = [
                    (p, t.clone()) for p, t in ckpt.state_leaves(tap.state)]
            if step == RESUME_PREEMPT_AFTER:
                os.kill(os.getpid(), signal.SIGTERM)

        ckdir = root / "preempted"
        with ckpt.PreemptionGuard() as guard:
            pre = train.run_train_loop(
                cfg, opt, batch_fn, steps=RESUME_STEPS, generator=0,
                checkpoint_dir=ckdir, checkpoint_every=2, keep_last=2,
                guard=guard, on_step=preempt, telemetry=tap, **loop_kw)
        tap.state = None
        if signal.getsignal(signal.SIGTERM) is not before:
            fail("resume: the PreemptionGuard stayed installed")
        published = ckpt.list_snapshot_steps(ckdir)
        if (pre.status != "preempted" or pre.step != RESUME_PREEMPT_AFTER
                or published != [RESUME_PREEMPT_AFTER - 1,
                                 RESUME_PREEMPT_AFTER]):
            fail(f"resume: SIGTERM after step {RESUME_PREEMPT_AFTER} gave "
                 f"status {pre.status!r} at step {pre.step}, published "
                 f"{published}")
        cp = pre.checkpointer
        out.update(snapshot_bytes=cp.snapshot_bytes,
                   copy_s={str(k): v for k, v in cp.copy_seconds.items()},
                   write_s={str(k): v for k, v in cp.write_seconds.items()},
                   dropped=cp.dropped)
        template = train.state_template(cfg, opt, unstacked=True)
        periodic, _ = ckpt.read_snapshot(ckdir, template,
                                         RESUME_PREEMPT_AFTER - 1,
                                         device=device)
        torn = differing(torch, ckpt.state_leaves(periodic),
                         clones.pop("leaves"))
        if torn:
            fail(f"resume: the snapshot of step {RESUME_PREEMPT_AFTER - 1} "
                 f"differs from the state after it at {torn[:3]}")
        del periodic
        sync()
        t0 = time.perf_counter()
        restored, start = train.resume_train_state(ckdir, cfg, opt,
                                                   unstacked=True,
                                                   device=device)
        sync()
        out["restore_s"] = time.perf_counter() - t0
        differ = differing(torch, ckpt.state_leaves(restored),
                           ckpt.state_leaves(pre.state))
        if start != RESUME_PREEMPT_AFTER or differ:
            fail(f"resume: restored step {start}, leaves differing from the "
                 f"preempted state: {differ[:3]}")
        del restored, pre
        cont = train.run_train_loop(
            cfg, opt, batch_fn, steps=RESUME_STEPS, checkpoint_dir=ckdir,
            checkpoint_every=2, keep_last=2, **loop_kw)
        if (cont.resumed_from != RESUME_PREEMPT_AFTER
                or cont.step != RESUME_STEPS
                or len(cont.losses) != RESUME_STEPS - RESUME_PREEMPT_AFTER):
            fail(f"resume: continued from {cont.resumed_from} to "
                 f"{cont.step} with {len(cont.losses)} losses")
        rel = [abs(a - b) / abs(b) for a, b in
               zip(cont.losses, base_losses[RESUME_PREEMPT_AFTER:])]
        out.update(resumed_losses=cont.losses, resumed_loss_rel_err=rel)
        if not all(math.isfinite(x) and x <= RESUME_LOSS_RTOL for x in rel):
            fail(f"resume: losses of steps {RESUME_PREEMPT_AFTER + 1}-"
                 f"{RESUME_STEPS} {cont.losses} against "
                 f"{base_losses[RESUME_PREEMPT_AFTER:]} (rel {rel})")
        del cont
        shutil.rmtree(ckdir)

        # 3. host kill after step 7: resume from the periodic step 6
        ckdir = root / "killed"

        def kill(step, metrics):
            if step == RESUME_KILL_AFTER:
                raise SimulatedHostLoss(f"host lost after step {step}")

        try:
            train.run_train_loop(
                cfg, opt, batch_fn, steps=RESUME_STEPS, generator=0,
                checkpoint_dir=ckdir, checkpoint_every=2, keep_last=2,
                on_step=kill, **loop_kw)
            fail("resume: the host-kill run did not raise")
        except SimulatedHostLoss:
            pass
        killed, start = train.resume_train_state(ckdir, cfg, opt,
                                                 unstacked=True,
                                                 device=device)
        if start != RESUME_KILL_AFTER - 1 or killed.step != start:
            fail(f"resume: after a kill at step {RESUME_KILL_AFTER} the "
                 f"resume came from step {start}")
        del killed
    finally:
        shutil.rmtree(root, ignore_errors=True)
    steps_run = RESUME_STEPS * 2 + RESUME_KILL_AFTER
    per_layer = 1 if remat in (False, "none") else 2
    want = (per_layer * cfg.num_layers * steps_run,
            cfg.num_layers * steps_run)
    got = (fa.flash_attention.fwd_launches, fa.flash_attention.bwd_launches)
    out.update(fwd_launches=got[0], bwd_launches=got[1])
    if cuda and got != want:
        fail(f"resume: flash launches fwd {got[0]} bwd {got[1]}, expected "
             f"{want[0]} and {want[1]}")
    log("resume: " + json.dumps(out))
    if cuda:
        torch.cuda.empty_cache()
    return out


# -- phase 12: sharded training ----------------------------------------------


def local_leaves(torch, state) -> list:
    """(path, this rank's tensor) of every snapshot leaf of a state."""
    from dstack_tpu_torch.models import checkpoint as ckpt
    from dstack_tpu_torch.parallel.mesh import local_tensor

    return [(p, local_tensor(t)) for p, t in ckpt.state_leaves(state)]


def stripe_of(mesh, tokens):
    """This rank's rows of a global batch (its coordinate on the batch
    axes of the default policy)."""
    from dstack_tpu_torch.models.llama import ShardingPolicy
    from dstack_tpu_torch.parallel import mesh as mesh_lib

    index, count = mesh_lib.batch_stripe(
        mesh_lib.mesh_sizes(mesh), mesh_lib.mesh_coordinate(mesh),
        ShardingPolicy().batch_axes)
    rows = tokens.shape[0] // count
    return tokens[index * rows:(index + 1) * rows]


def check_rel(label: str, got: list, want: list, limit: float) -> list:
    """Relative errors of ``got`` against ``want``; fails past ``limit``."""
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    if len(got) != len(want) or not all(
            math.isfinite(x) and x <= limit for x in rel):
        fail(f"{label}: {got} against {want} (rel {rel}, limit {limit})")
    return rel


def median_step(stamps: list) -> float:
    """Median wall between consecutive step ends (the first step's own
    warm-up left out)."""
    gaps = sorted(b - a for a, b in zip(stamps, stamps[1:]))
    return gaps[len(gaps) // 2]


def sharded_8b(torch, mesh, device: str, trained=None) -> dict:
    """The 8B layer geometry at 6 layers (b4 s2048, selective remat) for
    SHARDED_STEPS steps on one batch: unsharded, then sharded from the
    same seed (the same init and tokens: each rank draws every matrix and
    keeps its blocks).  Holds the losses and grad norms to
    TRAIN_PLAIN_RTOL and counts the kernels' launches on the sharded
    steps."""
    from dstack_tpu_torch.models import train
    from dstack_tpu_torch.ops import flash_attention as fa

    cfg, batch, seq, remat = trained or trainer("llama3-8b-fit")
    cuda = device == "cuda"
    out = {"num_layers": cfg.num_layers, "batch": batch, "seq": seq,
           "steps": SHARDED_STEPS}
    for route in ("unsharded", "sharded"):
        kw = {} if route == "unsharded" else {"mesh": mesh}
        gen = torch.Generator(device=device).manual_seed(0)
        opt = train.default_optimizer()
        state = train.create_state(gen, cfg, opt, unstacked=True,
                                   device=device, **kw)
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                               generator=gen, device=device,
                               dtype=torch.int32)
        if route == "sharded":
            tokens = stripe_of(mesh, tokens)
        step_fn = train.make_train_step(cfg, opt, remat=remat, **kw)
        if cuda:
            torch.cuda.synchronize()
        fa.flash_attention.fwd_launches = fa.flash_attention.bwd_launches = 0
        losses, norms, stamps = [], [], [time.perf_counter()]
        for _ in range(SHARDED_STEPS):
            state, metrics = step_fn(state, {"tokens": tokens})
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
            if cuda:
                torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        step_s = median_step(stamps[1:])
        out[route] = {"losses": losses, "grad_norms": norms,
                      "step_s": [b - a for a, b in zip(stamps, stamps[1:])],
                      "step_median_s": step_s,
                      "tokens_per_s": batch * seq / step_s}
        del state, step_fn
        if cuda:
            torch.cuda.empty_cache()
    out["fwd_launches"] = fa.flash_attention.fwd_launches
    out["bwd_launches"] = fa.flash_attention.bwd_launches
    per_layer = 1 if remat in (False, "none") else 2
    want = (per_layer * cfg.num_layers * SHARDED_STEPS,
            cfg.num_layers * SHARDED_STEPS)
    if cuda and (out["fwd_launches"], out["bwd_launches"]) != want:
        fail(f"sharded 8b: flash launches fwd {out['fwd_launches']} bwd "
             f"{out['bwd_launches']}, expected {want[0]} and {want[1]}")
    for key, limit in TRAIN_PLAIN_RTOL.items():
        plural = "losses" if key == "loss" else "grad_norms"
        out[f"{key}_rel_err"] = check_rel(
            f"sharded 8b {key}", out["sharded"][plural],
            out["unsharded"][plural], limit)
    if torch.distributed.get_rank() == 0:
        log("sharded 8b: " + json.dumps(out))
    return out


def sharded_1b(torch, mesh, ckpt_dir: str, device: str,
               trained=None) -> dict:
    """Llama-3.2-1B at SHARDED_1B_LAYERS layers (b8 s1024, selective
    remat): an unsharded run_train_loop of SHARDED_STEPS +
    SHARDED_RESUME_STEPS steps (the uninterrupted run); a sharded one of
    SHARDED_STEPS steps from the same seed whose AsyncCheckpointer writes
    a sharded snapshot of the last step (every rank its shards, rank 0
    publishing); resume_train_state onto the mesh must restore it bitwise,
    and SHARDED_RESUME_STEPS more sharded steps must give the
    uninterrupted run's losses within RESUME_LOSS_RTOL.  The sharded
    steps' losses and grad norms are held to the unsharded ones
    (TRAIN_PLAIN_RTOL), and their kernel launches counted."""
    from dstack_tpu_torch.models import train
    from dstack_tpu_torch.ops import flash_attention as fa

    if trained is None:
        base, batch, seq, remat = trainer("llama3-1b")
        cfg = dataclasses.replace(base, num_layers=SHARDED_1B_LAYERS)
    else:
        cfg, batch, seq, remat = trained
    cuda = device == "cuda"
    total = SHARDED_STEPS + SHARDED_RESUME_STEPS
    opt = train.default_optimizer()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def batch_fn(step, sharded=True):
        gen = torch.Generator(device=device).manual_seed(2000 + step)
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                               generator=gen, device=device,
                               dtype=torch.int32)
        return {"tokens": stripe_of(mesh, tokens) if sharded else tokens}

    def recorder(norms, stamps):
        def on_step(step, metrics):
            norms.append(metrics["grad_norm"].item())
            sync()
            stamps.append(time.perf_counter())
        return on_step

    loop_kw = dict(unstacked=True, remat=remat, device=device)
    ref_norms, ref_stamps = [], []
    ref = train.run_train_loop(
        cfg, opt, lambda step: batch_fn(step, sharded=False), steps=total,
        generator=0, on_step=recorder(ref_norms, ref_stamps), **loop_kw)
    ref_losses = ref.losses
    del ref
    if cuda:
        torch.cuda.empty_cache()
    out = {"num_layers": cfg.num_layers, "batch": batch, "seq": seq,
           "unsharded": {"losses": ref_losses, "grad_norms": ref_norms,
                         "step_median_s": median_step(ref_stamps)}}
    out["unsharded"]["tokens_per_s"] = (
        batch * seq / out["unsharded"]["step_median_s"])

    fa.flash_attention.fwd_launches = fa.flash_attention.bwd_launches = 0
    norms, stamps = [], []
    run = train.run_train_loop(
        cfg, opt, batch_fn, steps=SHARDED_STEPS, generator=0, mesh=mesh,
        checkpoint_dir=ckpt_dir, checkpoint_every=SHARDED_STEPS,
        on_step=recorder(norms, stamps), **loop_kw)
    cp = run.checkpointer
    out["sharded"] = {"losses": run.losses, "grad_norms": norms}
    # the last step's stamp comes after its snapshot's copy: time the
    # steps between, and the resumed ones below
    walls = [b - a for a, b in zip(stamps[:-1], stamps[1:-1])]
    out.update(snapshot_bytes=cp.snapshot_bytes,
               copy_s=cp.copy_seconds.get(SHARDED_STEPS),
               write_s=cp.write_seconds.get(SHARDED_STEPS))
    for key, limit in TRAIN_PLAIN_RTOL.items():
        plural = "losses" if key == "loss" else "grad_norms"
        out[f"{key}_rel_err"] = check_rel(
            f"sharded 1b {key}", out["sharded"][plural],
            out["unsharded"][plural][:SHARDED_STEPS], limit)
    sync()
    t0 = time.perf_counter()
    restored, start = train.resume_train_state(
        ckpt_dir, cfg, opt, mesh=mesh, unstacked=True, device=device)
    sync()
    out["restore_s"] = time.perf_counter() - t0
    differ = differing(torch, local_leaves(torch, restored),
                       local_leaves(torch, run.state))
    if start != SHARDED_STEPS or differ:
        fail(f"sharded 1b: restored step {start}, leaves differing from the "
             f"state on the card: {differ[:3]}")
    del run
    step_fn = train.make_train_step(cfg, opt, mesh=mesh, remat=remat)
    resumed = []
    for step in range(SHARDED_STEPS, total):
        sync()
        t0 = time.perf_counter()
        restored, metrics = step_fn(restored, batch_fn(step))
        resumed.append(metrics["loss"].item())
        sync()
        walls.append(time.perf_counter() - t0)
    step_s = sorted(walls)[len(walls) // 2]
    out["sharded"].update(step_s=walls, step_median_s=step_s,
                          tokens_per_s=batch * seq / step_s)
    out["resumed_losses"] = resumed
    out["resumed_loss_rel_err"] = check_rel(
        "sharded 1b resumed loss", resumed, ref_losses[SHARDED_STEPS:],
        RESUME_LOSS_RTOL)
    del restored, step_fn
    out["fwd_launches"] = fa.flash_attention.fwd_launches
    out["bwd_launches"] = fa.flash_attention.bwd_launches
    per_layer = 1 if remat in (False, "none") else 2
    want = (per_layer * cfg.num_layers * total, cfg.num_layers * total)
    if cuda and (out["fwd_launches"], out["bwd_launches"]) != want:
        fail(f"sharded 1b: flash launches fwd {out['fwd_launches']} bwd "
             f"{out['bwd_launches']}, expected {want[0]} and {want[1]}")
    if torch.distributed.get_rank() == 0:
        log("sharded 1b: " + json.dumps(out))
    if cuda:
        torch.cuda.empty_cache()
    return out


def resync(torch, sharded, whole, cfg, mesh) -> None:
    """Make the unsharded state rank 0's on every rank (each rank's own
    unsharded steps differ by K2's unordered adds, and the sharded state
    is made of every rank's blocks), then the sharded state this rank's
    blocks of it: parameters, AdamW moments and step counts (both past a
    step)."""
    import torch.distributed as dist

    from dstack_tpu_torch.models import llama, moe
    from dstack_tpu_torch.parallel import mesh as mesh_lib

    if dist.get_world_size() > 1:
        for w in llama.tree_leaves(whole.params):
            dist.broadcast(w.data, 0)
            for key in ("exp_avg", "exp_avg_sq"):
                dist.broadcast(whole.opt_state.state[w][key], 0)
    specs = moe.specs_for(whole.params, cfg, llama.ShardingPolicy(), "expert")

    def copy(spec, w, s):
        mine = mesh_lib.local_tensor(s)
        with torch.no_grad():
            mine.copy_(mesh_lib.local_block(w.detach(), spec, mesh))
        theirs, ours = whole.opt_state.state[w], sharded.opt_state.state[mine]
        for key in ("exp_avg", "exp_avg_sq"):
            ours[key].copy_(mesh_lib.local_block(theirs[key], spec, mesh))
        ours["step"].copy_(theirs["step"])

    llama.map_with_specs(copy, specs, whole.params, sharded.params)


def leaf_diffs(torch, whole, other, cfg, mesh=None) -> dict:
    """Per parameter leaf (by path), the L2 norms of the unsharded state
    ``whole`` minus ``other``: its parameter and its AdamW first moment
    (zero before a state's first step).  ``other`` on ``mesh`` gives this
    rank's tensors, held to this rank's blocks of ``whole``."""
    from dstack_tpu_torch.models import llama, moe
    from dstack_tpu_torch.parallel import mesh as mesh_lib

    specs = moe.specs_for(whole.params, cfg, llama.ShardingPolicy(), "expert")
    out = {}

    def norm(a, b):
        return torch.linalg.vector_norm(a.float() - b.float()).item()

    def one(path, spec, w, o):
        mine = mesh_lib.local_tensor(o)

        def block(t):
            return t if mesh is None else mesh_lib.local_block(t, spec, mesh)

        ours = other.opt_state.state[mine].get("exp_avg")
        theirs = whole.opt_state.state[w]["exp_avg"]
        m = block(theirs)
        out[path] = (norm(block(w.detach()), mine),
                     norm(m, torch.zeros_like(m) if ours is None else ours))

    def walk(path, spec, w, o):
        if isinstance(w, dict):
            for k in w:
                walk(f"{path}.{k}", spec[k], w[k], o[k])
        elif isinstance(w, (list, tuple)):
            for i, parts in enumerate(zip(spec, w, o)):
                walk(f"{path}[{i}]", *parts)
        else:
            one(path, spec, w, o)

    with torch.no_grad():
        walk("params", specs, whole.params, other.params)
    return out


def update_rel(err: dict, base: dict) -> dict:
    """Each leaf's difference from the unsharded state after a step over
    the unsharded update's norm (:func:`leaf_diffs` of the two states,
    and of the unsharded state after and before the step), the largest
    over the leaves for the parameters and the first moments, and where
    each is."""
    out = {}
    for i, key in enumerate(("param", "exp_avg")):
        rel = {p: err[p][i] / base[p][i] if base[p][i] else (
            0.0 if err[p][i] == 0 else math.inf) for p in err}
        worst = max(rel, key=rel.get)
        out[key], out[f"{key}_leaf"] = rel[worst], worst
    return out


def sharded_moe(torch, device: str, trained=None) -> dict:
    """Mixtral width at MOE_TRAIN_LAYERS layers (b4 s2048, remat: each
    layer recomputed whole): SHARDED_STEPS steps unsharded and on the mesh
    MeshSpec(expert=world) (MeshSpec.auto of the world where it does not
    divide the experts), both from one seed and batch, each rank its
    stripe of the batch and its experts.  Each step runs on both from the
    same state (the sharded state is set to its blocks of the unsharded
    one before each step after the first): two free-running unsharded
    runs of these steps differ by more than the limits themselves (K2's
    unordered dq adds, amplified by the router), so only a step from a
    shared state holds the sharded function to TRAIN_PLAIN_RTOL.  After
    each step the sharded state's parameters and first moments are held
    to this rank's blocks of the unsharded state's, each leaf's
    difference over the norm of its unsharded update, within
    MOE_UPDATE_RTOL (MOE_UPDATE_RTOL_MESH on more than one rank, where
    the routing of near-ties differs); the first step also runs unsharded
    a second time from the seed's state, whose difference (``repeat``)
    is the reference's own.  Counts the flash kernels' launches on the sharded
    steps (twice a layer a step forward, once backward)."""
    from dstack_tpu_torch.models import moe, train
    from dstack_tpu_torch.ops import flash_attention as fa
    from dstack_tpu_torch.parallel import mesh as mesh_lib

    if trained is None:
        cfg = dataclasses.replace(moe.MoEConfig.mixtral_8x7b(),
                                  num_layers=MOE_TRAIN_LAYERS)
        batch, seq = MOE_TRAIN_BATCH, MOE_TRAIN_SEQ
    else:
        cfg, batch, seq = trained
    cuda = device == "cuda"
    world = torch.distributed.get_world_size()
    spec = (mesh_lib.MeshSpec(expert=world) if cfg.num_experts % world == 0
            else mesh_lib.MeshSpec.auto(world))
    mesh = mesh_lib.build_mesh(spec, device)
    opt = train.default_optimizer()
    out = {"num_layers": cfg.num_layers, "batch": batch, "seq": seq,
           "steps": SHARDED_STEPS,
           "mesh": {k: v for k, v in spec.sizes.items() if v > 1} or
           {"expert": 1}}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def start(**kw):
        gen = torch.Generator(device=device).manual_seed(0)
        state = moe.create_state(gen, cfg, opt, unstacked=True,
                                 device=device, **kw)
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                               generator=gen, device=device,
                               dtype=torch.int32)
        return state, tokens, moe.make_train_step(cfg, opt, **kw)

    runs = {r: {"losses": [], "aux_losses": [], "grad_norms": [],
                "step_s": [], "update_rel": []}
            for r in ("unsharded", "sharded", "repeat")}

    def step(route, fn, state, batch_):
        sync()
        t0 = time.perf_counter()
        state, metrics = fn(state, batch_)
        sync()
        run = runs[route]
        run["step_s"].append(time.perf_counter() - t0)
        run["losses"].append(metrics["loss"].item())
        run["aux_losses"].append(metrics["aux_loss"].item())
        run["grad_norms"].append(metrics["grad_norm"].item())
        return state

    # step 1 unsharded twice from the seed's state: the reference's spread
    whole, tokens, whole_step = start()
    again, _, _ = start()
    whole = step("unsharded", whole_step, whole, {"tokens": tokens})
    base = leaf_diffs(torch, whole, again, cfg)
    again = step("repeat", whole_step, again, {"tokens": tokens})
    runs["repeat"]["update_rel"].append(
        update_rel(leaf_diffs(torch, whole, again, cfg), base))
    del again
    if cuda:
        torch.cuda.empty_cache()
    part, _, part_step = start(mesh=mesh)
    stripe = {"tokens": stripe_of(mesh, tokens)}
    fwd = bwd = 0
    for i in range(SHARDED_STEPS):
        if i:
            resync(torch, part, whole, cfg, mesh)
            whole = step("unsharded", whole_step, whole, {"tokens": tokens})
            base = leaf_diffs(torch, whole, part, cfg, mesh)
        f0, b0 = fa.flash_attention.fwd_launches, \
            fa.flash_attention.bwd_launches
        part = step("sharded", part_step, part, stripe)
        fwd += fa.flash_attention.fwd_launches - f0
        bwd += fa.flash_attention.bwd_launches - b0
        runs["sharded"]["update_rel"].append(
            update_rel(leaf_diffs(torch, whole, part, cfg, mesh), base))
    del whole, part, whole_step, part_step
    if cuda:
        torch.cuda.empty_cache()
    for route, run in runs.items():
        steps = run["step_s"][1:] or run["step_s"]
        step_s = sorted(steps)[len(steps) // 2]
        run.update(step_median_s=step_s, tokens_per_s=batch * seq / step_s)
        out[route] = run
    out["fwd_launches"], out["bwd_launches"] = fwd, bwd
    want = (2 * cfg.num_layers * SHARDED_STEPS, cfg.num_layers * SHARDED_STEPS)
    if cuda and (fwd, bwd) != want:
        fail(f"sharded moe: flash launches fwd {fwd} bwd {bwd}, expected "
             f"{want[0]} and {want[1]}")
    for key, limit in TRAIN_PLAIN_RTOL.items():
        plural = "losses" if key == "loss" else "grad_norms"
        out[f"{key}_rel_err"] = check_rel(
            f"sharded moe {key}", out["sharded"][plural],
            out["unsharded"][plural], limit)
    limits = MOE_UPDATE_RTOL if world == 1 else MOE_UPDATE_RTOL_MESH
    over = [(i + 1, key, rel[f"{key}_leaf"], rel[key])
            for i, rel in enumerate(runs["sharded"]["update_rel"])
            for key, limit in limits.items()
            if not rel[key] <= limit]
    if over:
        fail(f"sharded moe: (step, state, leaf, its difference from the "
             f"unsharded step over that step's update) past "
             f"{limits}: {over}; every step: "
             f"{runs['sharded']['update_rel']}; the unsharded step's own: "
             f"{runs['repeat']['update_rel']}")
    if torch.distributed.get_rank() == 0:
        log("sharded moe: " + json.dumps(out))
    return out


def sharded_rank(torch, out_path: str, ckpt_dir: str, tensor: str = "1",
                 device: str = "cuda", trained: dict = None) -> dict:
    """One rank of phase 12: the process group from the control plane's
    variables (initialize(force=True): NCCL on the card), the mesh of
    MeshSpec.auto(world, tensor=tensor) with the default ShardingPolicy,
    then the 8B and 1B sharded runs and the MoE one (sharded_moe).  Rank 0
    writes the result to ``out_path``; the group is destroyed however the
    phase ends.  ``trained`` (name -> config, batch, seq, remat; "mixtral"
    -> config, batch, seq) replaces the trainers for a CPU rehearsal
    (``device="cpu"``: a gloo group)."""
    import torch.distributed as dist

    from dstack_tpu_torch.parallel import distributed
    from dstack_tpu_torch.parallel import mesh as mesh_lib

    trained = trained or {}
    distributed.initialize(force=True, device=device)
    try:
        world = dist.get_world_size()
        backend = dist.get_backend()
        if device == "cuda" and backend != "nccl":
            fail(f"sharded: the process group's backend is {backend}")
        spec = mesh_lib.MeshSpec.auto(world, tensor=int(tensor))
        mesh = mesh_lib.build_mesh(spec, device)
        out = {"world": world, "backend": backend,
               "mesh": {k: v for k, v in spec.sizes.items() if v > 1} or
               {"fsdp": 1},
               "llama3-8b-fit": sharded_8b(torch, mesh, device,
                                           trained.get("llama3-8b-fit")),
               "llama3-1b": sharded_1b(torch, mesh, ckpt_dir, device,
                                       trained.get("llama3-1b")),
               "mixtral": sharded_moe(torch, device, trained.get("mixtral"))}
        if dist.get_rank() == 0:
            Path(out_path).write_text(json.dumps(out))
        return out
    finally:
        dist.destroy_process_group()


def sharded_phase(torch, tensor: int = 1) -> dict:
    """Phase 12 in fresh processes, one rank per visible card (its process
    group never meets the other phases): the control plane's variables
    for one node of that many cards and a free coordinator port; fails
    unless every rank exits 0 within SHARDED_TIMEOUT_S.  ``tensor``, the
    tensor-parallel degree of the mesh (the rest is FSDP), must divide
    the card count; the script's own run leaves it at 1."""
    import shutil
    import tempfile

    n = torch.cuda.device_count()
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-sharded-"))
    env = dict(os.environ, DSTACK_MASTER_NODE_IP="127.0.0.1",
               DSTACK_NODES_NUM="1", DSTACK_NODE_RANK="0",
               DSTACK_GPUS_PER_NODE=str(n),
               DSTACK_COORDINATOR_PORT=str(free_port()))
    env.pop("DSTACK_GPUS_NUM", None)
    out_path = tmp / "result.json"
    procs = []
    try:
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--sharded-rank",
             str(out_path), str(tmp / "snapshots"), str(tensor)],
            env={**env, "LOCAL_RANK": str(r)}) for r in range(n)]
        deadline = time.time() + SHARDED_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
        codes = [p.returncode for p in procs]
        if any(codes) or not out_path.exists():
            fail(f"sharded: ranks exited {codes}")
        out = json.loads(out_path.read_text())
    except subprocess.TimeoutExpired:
        fail(f"sharded: ranks still running after {SHARDED_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# -- phase 9: HF import ------------------------------------------------------


def write_safetensors(torch, path: Path, tensors: dict) -> None:
    """The safetensors format: a little-endian u64 header length, a JSON
    header (each name's dtype, shape, byte range in the buffer), padded
    with spaces to 8 bytes, then the tensors' bytes in header order."""
    import struct

    names = {"torch.bfloat16": "BF16", "torch.float16": "F16",
             "torch.float32": "F32"}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[str(t.dtype)], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            f.write(t.contiguous().cpu().reshape(-1).view(torch.uint8)
                    .numpy())


def hf_tensors(torch, cfg, device: str, seed: int = 7) -> dict:
    """Llama weights under HF's names and [out, in] layout, random bf16 on
    the device: linear weights with std 1/sqrt(fan_in), norms near 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d, f = cfg.hidden_size, cfg.intermediate_size

    def lin(out_f, in_f):
        return (torch.randn((out_f, in_f), generator=gen, device=device)
                * in_f ** -0.5).to(torch.bfloat16)

    def norm():
        return (1 + 0.1 * torch.randn((d,), generator=gen, device=device)
                ).to(torch.bfloat16)

    t = {"model.embed_tokens.weight": lin(cfg.vocab_size, d),
         "model.norm.weight": norm()}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": norm(),
                  p + "post_attention_layernorm.weight": norm(),
                  p + "self_attn.q_proj.weight": lin(cfg.q_dim, d),
                  p + "self_attn.k_proj.weight": lin(cfg.kv_dim, d),
                  p + "self_attn.v_proj.weight": lin(cfg.kv_dim, d),
                  p + "self_attn.o_proj.weight": lin(d, cfg.q_dim),
                  p + "mlp.gate_proj.weight": lin(f, d),
                  p + "mlp.up_proj.weight": lin(f, d),
                  p + "mlp.down_proj.weight": lin(d, f)})
    if not cfg.tie_embeddings:
        t["lm_head.weight"] = lin(cfg.vocab_size, d)
    return t


def hf_import_phase(torch, cfg=None, device: str = "cuda") -> dict:
    """Writes Llama-3.2-1B (full width and depth, random bf16 weights from
    a seed) as an HF checkpoint in HF_SHARDS safetensors shards with its
    config.json, loads it with load_hf_llama: config_from_hf must give the
    config, every loaded leaf must equal its source tensor (transposed
    where HF stores [out, in]); then a paged engine decodes greedy tokens
    from the loaded weights through the paged-decode kernel, each checked
    against a plain forward (run_engine).  ``cfg`` defaults to the
    chip's; a CPU rehearsal passes a small one and ``device="cpu"``."""
    import shutil
    import tempfile

    from dstack_tpu_torch.models.checkpoint import (
        config_from_hf,
        load_hf_llama,
    )
    from dstack_tpu_torch.models.llama import LlamaConfig
    from dstack_tpu_torch.ops.rotary import RopeScaling

    rs = HF_ROPE_SCALING
    scaling = RopeScaling(rs["factor"], rs["low_freq_factor"],
                          rs["high_freq_factor"],
                          rs["original_max_position_embeddings"])
    if cfg is None:
        cfg = LlamaConfig.llama3_1b(rope_scaling=scaling)
    cuda = device == "cuda"
    src = hf_tensors(torch, cfg, device)
    nbytes = sum(t.numel() * t.element_size() for t in src.values())
    root = Path(tempfile.mkdtemp(prefix="chip-smoke-hf-"))
    out = {"num_layers": cfg.num_layers, "bytes": nbytes}
    try:
        t0 = time.perf_counter()
        names = sorted(src)
        for k in range(HF_SHARDS):
            shard = f"model-{k + 1:05d}-of-{HF_SHARDS:05d}.safetensors"
            write_safetensors(torch, root / shard,
                              {n: src[n] for n in names[k::HF_SHARDS]})
        (root / "config.json").write_text(json.dumps({
            "architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim, "rope_theta": cfg.rope_theta,
            "rope_scaling": rs if cfg.rope_scaling else None,
            "rms_norm_eps": cfg.rms_eps,
            "max_position_embeddings": cfg.max_seq_len,
            "tie_word_embeddings": cfg.tie_embeddings,
            "torch_dtype": "bfloat16"}))
        out["write_s"] = time.perf_counter() - t0
        if config_from_hf(root) != cfg:
            fail(f"hf-import: config_from_hf gave {config_from_hf(root)}, "
                 f"wanted {cfg}")
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_cfg, params = load_hf_llama(root, device=device)
        if cuda:
            torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        out["load_gb_per_s"] = nbytes / out["load_s"] / 1e9
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if got_cfg != cfg:
        fail(f"hf-import: load_hf_llama gave {got_cfg}")
    # (tree key, HF name, layer): linear weights come back transposed
    pairs = [("embed", "model.embed_tokens.weight", None),
             ("final_norm", "model.norm.weight", None)]
    hf_names = {"attn_norm": "input_layernorm", "wq": "self_attn.q_proj",
                "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
                "wo": "self_attn.o_proj",
                "mlp_norm": "post_attention_layernorm",
                "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
                "w_down": "mlp.down_proj"}
    for key, hf in hf_names.items():
        pairs += [(key, f"model.layers.{i}.{hf}.weight", i)
                  for i in range(cfg.num_layers)]
    if not cfg.tie_embeddings:
        pairs.append(("lm_head", "lm_head.weight", None))
    differ = []
    for key, name, layer in pairs:
        got = params[key] if layer is None else params["layers"][key][layer]
        want = src[name] if key in ("embed", "final_norm", "attn_norm",
                                    "mlp_norm") else src[name].T
        if got.dtype != torch.bfloat16 or not torch.equal(got, want):
            differ.append(name)
    if differ or sorted(params) != sorted(
            ["embed", "layers", "final_norm"]
            + ([] if cfg.tie_embeddings else ["lm_head"])):
        fail(f"hf-import: loaded leaves differ from the written ones: "
             f"{differ[:3]}")
    out["leaves_checked"] = len(pairs)
    del src
    out["launches"] = run_engine(torch, cfg, None,
                                 f"hf-import {cfg.num_layers}-layer bf16 "
                                 f"pages", device=device,
                                 params=params)["launches"]
    log("hf-import: " + json.dumps(out))
    return out


# -- phase 10: the rest of one-card serving -----------------------------------


def features_prefix(torch, cfg, params, device: str) -> dict:
    """Prefix caching on a paged bf16 engine (block 32, chunks of 512),
    two waves, 16 tokens a request.  Chunked: one request of a 512-token
    prefix and a 40-token suffix (a miss), then 7 with that prefix and
    suffixes of 17-89 tokens, each admitted in chunks from past the 16
    reused blocks.  Whole: a miss of a 256-token prefix and a 30-token
    suffix, then 7 with suffixes of 20-56 tokens, each prompt within one
    chunk, so each hit takes the whole-prompt prefill of its suffix over
    8 reused blocks.  Each hit must reuse its prefix's blocks and prefill
    only its suffix; the kernel launches layers x decode steps exactly
    over both; each greedy token is the plain forward's argmax within
    0.1 std."""
    from dstack_tpu_torch.ops import flash_attention as fa
    from dstack_tpu_torch.serving.engine import InferenceEngine, Request
    from dstack_tpu_torch.telemetry.serving import EngineTelemetry

    tel = EngineTelemetry()
    bs = 32
    engine = InferenceEngine(cfg, params=params, batch_size=8, max_len=1024,
                             paged=True, kv_block_size=bs, prefix_cache=True,
                             prefill_chunk=512, telemetry=tel, device=device)
    reused = {}
    reserve = engine._reserve_blocks

    def spy(slot_id, req):
        ok = reserve(slot_id, req)
        if ok:
            reused[id(req)] = engine._slot_prefix[slot_id][0] // bs
        return ok

    engine._reserve_blocks = spy
    # the card's first calls of each shape, outside the measured run: a
    # prompt as long as the first miss, of other tokens
    drive(torch, engine, [Request(tokens=[(i * 5 + 3) % 256
                                          for i in range(552)],
                                  max_new_tokens=4)])
    out = {}
    done = []
    fa.paged_decode_attention.launches = 0
    steps0 = engine.decode_steps
    for name, prefix, miss_len, lengths in (
            ("chunked", [(i * 37 + 11) % 256 for i in range(512)], 40,
             [17 + 12 * i for i in range(7)]),
            ("whole", [(i * 11 + 5) % 256 for i in range(256)], 30,
             [20 + 6 * i for i in range(7)])):
        # a request's clock starts when it is made
        miss = Request(tokens=prefix + [(i * 7 + 1) % 256
                                        for i in range(miss_len)],
                       max_new_tokens=16)
        miss_s = drive(torch, engine, [miss])
        # each suffix starts with its own token, so no two share a block
        # past the prefix
        wave = [Request(tokens=prefix + [(i * 13 + j * 5 + 200 + i) % 256
                                         for j in range(n)],
                        max_new_tokens=16) for i, n in enumerate(lengths)]
        before = tel.prefill_tokens.value
        wave_s = drive(torch, engine, wave)
        suffix_tokens = sum(lengths)
        prefilled = tel.prefill_tokens.value - before
        hits = [reused[id(r)] for r in wave]
        blocks = len(prefix) // bs
        if reused[id(miss)] != 0 or hits != [blocks] * len(wave):
            fail(f"prefix {name}: reused blocks {reused[id(miss)]} then "
                 f"{hits}, wanted 0 then {blocks} each")
        if prefilled != suffix_tokens:
            fail(f"prefix {name}: the wave prefilled {prefilled} tokens, "
                 f"its suffixes are {suffix_tokens}")
        out[name] = {
            "reused_blocks": hits, "wave_prefill_tokens": prefilled,
            "miss_ttft_s": miss.first_token_at - miss.submitted_at,
            "hit_ttft_s": sorted(r.first_token_at - r.submitted_at
                                 for r in wave),
            "miss_wall_s": miss_s, "wave_wall_s": wave_s}
        done += [miss] + wave
    launches = fa.paged_decode_attention.launches
    steps = engine.decode_steps - steps0
    if device == "cuda" and launches != cfg.num_layers * steps:
        fail(f"prefix: {launches} kernel launches over {steps} decode "
             f"steps x {cfg.num_layers} layers")
    out.update(launches=launches, decode_steps=steps,
               worst_gap_std=greedy_gaps(torch, params, cfg, done, 0.1,
                                         "prefix", 16))
    log("features prefix: " + json.dumps(out))
    return out


def features_speculation(torch, cfg, params, device: str) -> dict:
    """n-gram speculation on a dense bf16 engine, k = 2: a sampled request
    alone must take the plain window (no verification step counted); then
    eight greedy prompts, one a slot, each repeating a 32-token pattern
    four times, 64 tokens each, must see drafts accepted, each token
    within 0.1 std of the plain forward's argmax.  The same greedy
    prompts on the plain dense window first give the decode rate to
    compare (each rate from the last first token to the last token)."""
    from dstack_tpu_torch.serving.engine import InferenceEngine, Request

    prompts = [[(i * 29 + 7 * p) % 256 for i in range(32)] * 4
               for p in range(8)]
    out = {}
    for spec in (None, "ngram"):
        engine = InferenceEngine(cfg, params=params, batch_size=8,
                                 max_len=1024, speculation=spec,
                                 speculation_k=2, rng_seed=1, device=device)
        drive(torch, engine, [Request(tokens=list(range(40)),
                                      max_new_tokens=4)])
        if spec:
            sampled = Request(tokens=prompts[0], max_new_tokens=16,
                              temperature=1.0)
            steps0 = engine.spec_stats["steps"]
            drive(torch, engine, [sampled])
            if (engine.spec_stats["steps"] != steps0
                    or len(sampled.output) != 16):
                fail(f"speculation: the sampled request counted "
                     f"{engine.spec_stats['steps'] - steps0} verification "
                     f"steps")
            engine.spec_stats.update(steps=0, accepted=0)
        reqs = [Request(tokens=list(p), max_new_tokens=64) for p in prompts]
        drive(torch, engine, reqs)
        name = "spec" if spec else "plain"
        out[f"{name}_decode_tok_per_s"] = decode_rate(reqs)
        out[f"{name}_tokens"] = [r.output for r in reqs]
        if spec:
            stats = dict(engine.spec_stats)
            out["worst_gap_std"] = greedy_gaps(torch, params, cfg, reqs, 0.1,
                                               "speculation", 64)
        del engine
    if stats["accepted"] <= 0:
        fail(f"speculation: no draft accepted ({stats})")
    pairs = list(zip(out.pop("spec_tokens"), out.pop("plain_tokens")))
    # where bf16 near-ties first flip (the 3-wide verify sums in another
    # order than the plain step): 64 = never
    first_diff = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                       len(a)) for a, b in pairs]
    out.update(spec_stats=stats, first_difference=first_diff,
               tokens_per_verify_step=1 + stats["accepted"] / stats["steps"],
               speedup=(out["spec_decode_tok_per_s"]
                        / out["plain_decode_tok_per_s"]))
    log("features speculation: " + json.dumps(out))
    return out


def features_int4(torch, cfg, params, device: str) -> dict:
    """int4 KV: quantize_kv4/dequantize_kv4 on the device against the same
    call on the CPU at 8B's [tokens, 8, 128] rows (bitwise); then dense
    and paged engines with bf16 weights, int4 KV and, to compare, bf16 KV
    (run_engine): 12 tokens for each of two prompts, each within
    INT4_GAP_STD (int4) or 0.1 (bf16) std of the plain forward's argmax
    (finite logits); then 64 tokens for each of eight prompts, one a
    slot, for the decode rate.  The kernel must launch exactly layers x
    decode steps on bf16 pages and never on int4 KV."""
    from dstack_tpu_torch.serving.quant import dequantize_kv4, quantize_kv4

    gen = torch.Generator(device=device).manual_seed(5)
    rows = torch.randn((1024, cfg.num_kv_heads, cfg.head_dim), generator=gen,
                       device=device).to(cfg.dtype)
    q4, s = quantize_kv4(rows)
    cq4, cs = quantize_kv4(rows.cpu())
    back = dequantize_kv4(q4, s, cfg.dtype).cpu()
    differ = {"bytes": (q4.cpu() != cq4).sum().item(),
              "scales": (s.cpu() != cs).sum().item(),
              "values": (back != dequantize_kv4(cq4, cs, cfg.dtype)
                         ).sum().item()}
    if any(differ.values()):
        fail(f"int4: quantize_kv4/dequantize_kv4 on the device differ from "
             f"the CPU in {differ}")
    rms = ((back.float() - rows.cpu().float()).pow(2).mean().sqrt()
           / rows.float().pow(2).mean().sqrt()).item()
    out = {"kv4_rms_rel_err": rms}
    for kv in (None, "int4"):
        for paged in (False, True):
            label = f"{kv or 'bf16'} {'paged' if paged else 'dense'}"
            out[label] = run_engine(
                torch, cfg, kv, f"int4 phase {label}", device=device,
                params=params, paged=paged,
                margin=INT4_GAP_STD if kv else 0.1, exact=True, rate=True)
    log("features int4: " + json.dumps(out))
    return out


def features_pd(torch, cfg, params, device: str) -> dict:
    """Prefill/decode disaggregation: prefill_export of a 300-token prompt
    on a dense engine, a round trip of its K/V and logits through the
    server's wire codec (bitwise), the install into a paged bf16 engine
    and 16 tokens decoded through the kernel (launches = layers x decode
    steps), equal to the same prompt prefilled on that engine or each
    within 0.1 std of the plain forward's argmax."""
    from dstack_tpu_torch.ops import flash_attention as fa
    from dstack_tpu_torch.serving.engine import InferenceEngine, Request
    from dstack_tpu_torch.serving.server import _arr_from_wire, _arr_to_wire

    prompt = [(i * 53 + 17) % 256 for i in range(300)]
    exporter = InferenceEngine(cfg, params=params, batch_size=1, max_len=1024,
                               device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp = exporter.prefill_export(prompt, max_new_tokens=16)
    export_s = time.perf_counter() - t0
    del exporter
    t0 = time.perf_counter()
    text = json.dumps({k: _arr_to_wire(exp[k])
                       for k in ("ks", "vs", "logits")})
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wire = {k: _arr_from_wire(v) for k, v in json.loads(text).items()}
    decode_s = time.perf_counter() - t0
    for k, v in wire.items():
        if v.dtype != exp[k].dtype or not torch.equal(v, exp[k]):
            fail(f"pd: {k} changed on the wire")
    engine = InferenceEngine(cfg, params=params, batch_size=8, max_len=1024,
                             paged=True, device=device)
    drive(torch, engine, [Request(tokens=list(range(40)), max_new_tokens=4)])
    installed = Request(tokens=prompt, max_new_tokens=16, prefill=dict(
        wire, first_token=exp["first_token"], length=exp["length"]))
    fa.paged_decode_attention.launches = 0
    steps0 = engine.decode_steps
    install_s = drive(torch, engine, [installed])
    launches = fa.paged_decode_attention.launches
    steps = engine.decode_steps - steps0
    if device == "cuda" and launches != cfg.num_layers * steps:
        fail(f"pd: {launches} kernel launches over {steps} decode steps x "
             f"{cfg.num_layers} layers")
    colocated = Request(tokens=prompt, max_new_tokens=16)
    colocated_s = drive(torch, engine, [colocated])
    same = installed.output == colocated.output
    worst = 0.0 if same else greedy_gaps(torch, params, cfg, [installed],
                                         0.1, "pd install", 16)
    out = {"wire_bytes": len(text), "kv_bytes": sum(
               exp[k].numel() * exp[k].element_size() for k in ("ks", "vs")),
           "export_s": export_s, "encode_s": encode_s, "decode_s": decode_s,
           "install_and_decode_s": install_s, "colocated_s": colocated_s,
           "launches": launches, "decode_steps": steps,
           "same_as_colocated": same, "worst_gap_std": worst}
    log("features pd: " + json.dumps(out))
    return out


def serving_features_phase(torch, cfg=None, device: str = "cuda") -> dict:
    """Prefix caching, n-gram speculation, int4 KV and PD export/install
    at Llama-3-8B (full width and depth) with one set of random bf16
    weights (seed 1) shared by every engine, batch 8, max_len 1024.
    Returns each part's numbers and the kernel's launches over the phase.
    ``cfg`` defaults to the chip's; a CPU rehearsal passes a small one and
    ``device="cpu"`` (launch counts are then not checked)."""
    from dstack_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = cfg or LlamaConfig.llama3_8b()
    params = init_params(cfg, device,
                         torch.Generator(device=device).manual_seed(1))
    out = {"prefix": features_prefix(torch, cfg, params, device),
           "speculation": features_speculation(torch, cfg, params, device),
           "int4": features_int4(torch, cfg, params, device),
           "pd": features_pd(torch, cfg, params, device)}
    out["launches"] = (out["prefix"]["launches"] + out["pd"]["launches"]
                       + sum(v["launches"] for v in out["int4"].values()
                             if isinstance(v, dict)))
    del params
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


# -- phase 11: Mixtral-style MoE ---------------------------------------------


def int8_moe_params(torch, cfg, device: str, seed: int) -> dict:
    """An MoE tree drawn as ``moe.init_params`` draws it (the same
    generator calls in the same order, each matrix rounded to
    ``cfg.dtype``), every layer matrix and the head quantized to int8 by
    ``quantize_weight`` one (layer, expert) matrix at a time as it is
    drawn, and a tied model given an int8 head copy: equal to
    ``quantize_params(init_params(...), tied_head_copy=tie_embeddings)``
    with no full-precision tree on the device (Mixtral-8x7B's is 93.4 GB
    in bf16)."""
    from dstack_tpu_torch.models import moe
    from dstack_tpu_torch.serving.quant import _LAYER_WEIGHTS, quantize_weight

    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, fan_in, dtype):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * fan_in ** -0.5).to(dtype)

    def leaf(name, meta):
        if "norm" in name:
            return torch.ones(meta.shape, dtype=meta.dtype, device=device)
        if name == "embed":  # [V, D], fan-in D
            return draw(meta.shape, meta.shape[-1], meta.dtype)
        lead, shape = meta.shape[:-2], meta.shape[-2:]  # [..., in, out]
        if name not in _LAYER_WEIGHTS + ("lm_head",):  # the f32 router
            out = torch.empty(meta.shape, dtype=meta.dtype, device=device)
            for part in out.view((-1,) + shape):
                part.copy_(draw(shape, shape[0], meta.dtype))
            return out
        q = torch.empty(meta.shape, dtype=torch.int8, device=device)
        s = torch.empty(lead + shape[-1:], dtype=torch.float32,
                        device=device)
        for qp, sp in zip(q.view((-1,) + shape), s.view((-1, shape[-1]))):
            w = quantize_weight(draw(shape, shape[0], meta.dtype))
            qp.copy_(w["q"])
            sp.copy_(w["s"])
        return {"q": q, "s": s}

    # the generator's calls in init_params' order: embed, layers, head
    out = {k: ({n: leaf(n, m) for n, m in v.items()} if k == "layers"
               else leaf(k, v))
           for k, v in moe.init_params(cfg, "meta", None).items()}
    if cfg.tie_embeddings:
        out["lm_head"] = quantize_weight(out["embed"].T)
    return out


def dequantized_dense(torch, params, dtype) -> dict:
    """``params`` with its attention matrices and head dequantized to
    ``dtype`` and its expert stacks left int8: the tree ``moe.forward``
    takes (its attention multiplies plain tensors, its experts take int8
    as the reference's ``qeinsum`` does)."""
    def deq(w):
        return (w["q"].to(dtype) * w["s"][..., None, :].to(dtype)
                if isinstance(w, dict) else w)

    out = dict(params, layers={
        k: deq(w) if k in ("wq", "wk", "wv", "wo") else w
        for k, w in params["layers"].items()})
    if "lm_head" in params:
        out["lm_head"] = deq(params["lm_head"])
    return out


class RouteTap:
    """Within ``with``: the router logits of every ``moe._route`` call, in
    call order (one call a layer of each forward the engine runs)."""

    def __enter__(self):
        from dstack_tpu_torch.models import moe

        self.moe, self.route, self.calls = moe, moe._route, []

        def tap(logits, k, capacity, token_mask=None, layout=None):
            self.calls.append(logits.detach())
            return self.route(logits, k, capacity, token_mask, layout)

        moe._route = tap
        return self

    def __exit__(self, *exc):
        self.moe._route = self.route


def engine_routes(torch, calls, reqs, num_layers: int, chunk: int) -> list:
    """Each request's router logits as the engine computed them, [L,
    positions, E] for every position the engine fed (the prompt and each
    output token but the last), from the calls of one drive of ``reqs``
    submitted at once on an idle engine: their prefills in order (chunks of
    ``chunk``, one call a layer, rows past the chunk padding), then decode
    steps in lockstep (one call a layer, row b the slot of request b,
    which holds its token j at step j)."""
    i, routes = 0, []
    for r in reqs:
        rows = [[] for _ in range(num_layers)]
        for done in range(0, len(r.tokens), chunk):
            m = min(chunk, len(r.tokens) - done)
            for l in range(num_layers):
                rows[l].append(calls[i][:m])
                i += 1
        routes.append(rows)
    if (len(calls) - i) % num_layers:
        fail(f"moe: {len(calls) - i} decode-step router calls, not a "
             f"multiple of {num_layers} layers")
    for j in range((len(calls) - i) // num_layers):
        for l in range(num_layers):
            for b, r in enumerate(reqs):
                if j < len(r.output) - 1:
                    routes[b][l].append(calls[i][b:b + 1])
            i += 1
    return [torch.stack([torch.cat(rows) for rows in r]) for r in routes]


def moe_check_tokens(torch, params, cfg, runs, label: str) -> dict:
    """Each request's greedy tokens against ``moe.forward`` over its prompt
    and tokens (one teacher-forced forward a request, at its exact length)
    routed as the engine routed: layer by layer, wherever the engine's
    top-k experts at a position differ from the forward's, the forward
    takes the engine's router logits there, and the forward's own gap
    between its k-th and (k+1)-th logits there must be below MOE_TIE_EPS;
    everywhere the engine's router logits must be within MOE_TIE_EPS of
    the forward's.  Every token must then be the forward's argmax within
    0.1 std of the logits.  ``runs``: (requests, their engine_routes).  Returns the worst
    gap, the tokens checked, the routing flips and their largest gap, and
    the largest router-logit difference where the two routed alike."""
    from dstack_tpu_torch.models import moe

    k = cfg.experts_per_token
    route = moe._route
    device = params["embed"].device
    stats = {"worst_gap_std": 0.0, "tokens_checked": 0, "flips": 0,
             "flip_max_router_gap": 0.0, "router_max_abs_diff": 0.0}

    def topk(x):
        return torch.sort(x, dim=-1, descending=True, stable=True)

    for reqs, routes in runs:
        for r, eng in zip(reqs, routes):
            layer = iter(eng)

            def replay(logits, k_, capacity, token_mask=None, layout=None):
                e = next(layer).to(logits.dtype)
                n = e.shape[0]
                mine, theirs = topk(logits[:n]), topk(e)
                flip = (mine.indices[:, :k].sort(-1).values
                        != theirs.indices[:, :k].sort(-1).values).any(-1)
                gap = mine.values[:, k - 1] - mine.values[:, k]
                if flip.any():
                    worst = gap[flip].max().item()
                    if worst >= MOE_TIE_EPS:
                        fail(f"{label}: the engine routed a token to other "
                             f"experts than the forward where their gap is "
                             f"{worst:.4f}")
                    stats["flips"] += int(flip.sum())
                    stats["flip_max_router_gap"] = max(
                        stats["flip_max_router_gap"], worst)
                    logits = logits.clone()
                    logits[:n][flip] = e[flip]
                diff = (logits[:n] - e).abs().amax().item()
                if diff > MOE_TIE_EPS:
                    fail(f"{label}: the engine's router logits differ from "
                         f"the forward's by {diff:.4f}")
                stats["router_max_abs_diff"] = max(
                    stats["router_max_abs_diff"], diff)
                return route(logits, k_, capacity, token_mask, layout)

            seq = list(r.tokens) + list(r.output)
            if eng.shape[:2] != (cfg.num_layers, len(seq) - 1):
                fail(f"{label}: engine routes {tuple(eng.shape)} for a "
                     f"sequence of {len(seq)}")
            moe._route = replay
            try:
                with torch.no_grad():
                    logits = moe.forward(params, torch.tensor(
                        [seq], device=device), cfg)[0, len(r.tokens) - 1:-1]
            finally:
                moe._route = route
            if not torch.isfinite(logits).all():
                fail(f"{label}: non-finite logits")
            out = torch.tensor(r.output, device=device)[:, None]
            gaps = ((logits.max(-1).values - logits.gather(1, out)[:, 0])
                    / logits.std(-1)).tolist()
            i = max(range(len(gaps)), key=gaps.__getitem__)
            if gaps[i] > 0.1:
                fail(f"{label}: token {i} ({r.output[i]}) is {gaps[i]:.3f} "
                     f"std below the argmax of moe.forward routed as the "
                     f"engine routed")
            stats["worst_gap_std"] = max(stats["worst_gap_std"], gaps[i])
            stats["tokens_checked"] += len(gaps)
    return stats


def moe_serve(torch, cfg, params, label: str, device: str, paged: bool,
              long_prompt: bool) -> dict:
    """An engine (batch 8, max_len 1024, chunks of 512) over ``params``:
    a warm-up request; one 64-token prompt alone (its TTFT); the burst of
    BURST_PROMPTS, 64 tokens each (the decode rate at a full batch); with
    ``long_prompt`` a prompt of MOE_LONG_PROMPT tokens (two chunks, the
    second padded).  Paged on the card, the paged-decode kernel must
    launch exactly layers x decode steps; dense, never.  Returns the
    numbers and, for each drive, its requests and the engine's router
    logits for them (engine_routes), which moe_check_tokens checks."""
    from dstack_tpu_torch.ops import flash_attention as fa
    from dstack_tpu_torch.serving.engine import InferenceEngine, Request

    engine = InferenceEngine(cfg, params=params, batch_size=8, max_len=1024,
                             paged=paged, prefill_chunk=512, device=device)
    drive(torch, engine, [Request(tokens=list(range(40)), max_new_tokens=4)])
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.paged_decode_attention.launches = 0
    steps0 = engine.decode_steps
    runs = []

    def run(reqs):
        with RouteTap() as tap:
            wall = drive(torch, engine, reqs)
        runs.append((reqs, engine_routes(torch, tap.calls, reqs,
                                         cfg.num_layers, 512)))
        return wall

    single = Request(tokens=list(BURST_PROMPTS[2][:64]), max_new_tokens=16)
    run([single])
    burst = [Request(tokens=list(p), max_new_tokens=64)
             for p in BURST_PROMPTS]
    burst_s = run(burst)
    if any(len(r.output) != 64 for r in burst):
        fail(f"{label}: a burst request ended short of 64 tokens")
    out = {"ttft_s": single.first_token_at - single.submitted_at,
           "decode_tok_per_s": decode_rate(burst), "burst_wall_s": burst_s}
    if long_prompt:
        long = Request(tokens=[(i * 53 + 17) % 256
                               for i in range(MOE_LONG_PROMPT)],
                       max_new_tokens=16)
        out["long_wall_s"] = run([long])
        out["long_ttft_s"] = long.first_token_at - long.submitted_at
    launches = fa.paged_decode_attention.launches
    steps = engine.decode_steps - steps0
    want = cfg.num_layers * steps if paged else 0
    if steps <= 0 or cuda and launches != want:
        fail(f"{label}: {launches} kernel launches over {steps} decode "
             f"steps x {cfg.num_layers} layers (paged: {paged})")
    out.update(launches=launches, decode_steps=steps,
               # 8 slots decode one token each a step
               decode_step_s=8 / out["decode_tok_per_s"])
    if cuda:
        out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del engine
    return out, runs


def moe_train(torch, cfg, device: str, batch: int, seq: int,
              steps: int) -> dict:
    """``steps`` MoE train steps (remat=True, unstacked, seed 0) on one
    repeated batch of random tokens: the cross entropy finite and falling,
    the aux loss finite, the flash kernels launched exactly twice per
    layer per step forward (the backward recomputes each layer) and once
    backward.  Then one step through the kernels and one through
    ``flash_attention_plain`` from the same fresh state and batch (b2,
    remat off): loss and grad norm within TRAIN_PLAIN_RTOL."""
    from dstack_tpu_torch.models import moe, train
    from dstack_tpu_torch.ops import flash_attention as fa

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    opt = train.default_optimizer()
    gen = torch.Generator(device=device).manual_seed(0)
    state = moe.create_state(gen, cfg, opt, unstacked=True, device=device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                           device=device, dtype=torch.int32)
    step_fn = moe.make_train_step(cfg, opt)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.fwd_launches = fa.flash_attention.bwd_launches = 0
    losses, auxes, norms, times = [], [], [], []
    for _ in range(steps):
        t = time.time()
        state, metrics = step_fn(state, {"tokens": tokens})
        losses.append(metrics["loss"].item())
        auxes.append(metrics["aux_loss"].item())
        norms.append(metrics["grad_norm"].item())
        sync()
        times.append(time.time() - t)
    fwd, bwd = fa.flash_attention.fwd_launches, fa.flash_attention.bwd_launches
    want_fwd, want_bwd = 2 * cfg.num_layers * steps, cfg.num_layers * steps
    if cuda and (fwd != want_fwd or bwd != want_bwd):
        fail(f"moe train: flash launches fwd {fwd} bwd {bwd}, expected "
             f"{want_fwd} and {want_bwd}")
    if not all(map(math.isfinite, losses + auxes + norms)):
        fail(f"moe train: non-finite loss, aux loss or grad norm: {losses} "
             f"{auxes} {norms}")
    if not losses[-1] < losses[0]:
        fail(f"moe train: loss did not fall: {losses}")
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    out = {"num_layers": cfg.num_layers, "num_params": cfg.num_params(),
           "batch": batch, "seq": seq, "steps": steps, "losses": losses,
           "aux_losses": auxes, "grad_norms": norms, "step_s": times,
           "step_median_s": step_s, "tokens_per_s": batch * seq / step_s,
           "fwd_launches": fwd, "bwd_launches": bwd}
    if cuda:
        out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state, step_fn, metrics
    if cuda:
        torch.cuda.empty_cache()
    kernel_fn, routes = fa.flash_attention, {}
    for route in ("kernel", "plain"):
        gen = torch.Generator(device=device).manual_seed(1)
        state = moe.create_state(gen, cfg, opt, unstacked=True,
                                 device=device)
        plain_batch = torch.randint(0, cfg.vocab_size, (TRAIN_PLAIN_BATCH,
                                                        seq + 1),
                                    generator=gen, device=device,
                                    dtype=torch.int32)
        if route == "plain":
            fa.flash_attention = fa.flash_attention_plain
        try:
            _, metrics = moe.make_train_step(cfg, opt, remat=False)(
                state, {"tokens": plain_batch})
            routes[route] = {"loss": metrics["loss"].item(),
                             "grad_norm": metrics["grad_norm"].item()}
        finally:
            fa.flash_attention = kernel_fn
        del state, metrics
        if cuda:
            torch.cuda.empty_cache()
    for key, limit in TRAIN_PLAIN_RTOL.items():
        got, want = routes["kernel"][key], routes["plain"][key]
        rel = abs(got - want) / abs(want)
        routes[f"{key}_rel_err"] = rel
        if not (math.isfinite(got) and rel <= limit):
            fail(f"moe train-plain: {key} {got} through the kernels vs "
                 f"{want} through the plain versions (rel {rel:.2e} > "
                 f"{limit})")
    out["plain"] = routes
    return out


def moe_phase(torch, cfg=None, device: str = "cuda",
              seq: int = MOE_TRAIN_SEQ) -> dict:
    """Mixtral-style MoE on one card, in three parts, each freed before the
    next is built: Mixtral-8x7B at full size with int8 weights (seed 2,
    drawn by int8_moe_params) served paged, with chunked prefill of a long
    prompt; its layers at MOE_BF16_LAYERS deep with bf16 experts (seed 3)
    served on a dense cache; training at MOE_TRAIN_LAYERS layers
    (moe_train).  Each served greedy token is held to ``moe.forward`` on
    the same weights (int8 experts; attention and head dequantized, as
    the forward multiplies plain tensors).  ``cfg`` defaults to
    Mixtral-8x7B; a CPU rehearsal passes a small one, ``device="cpu"`` and
    a short ``seq`` (launch counts are then not checked)."""
    from dstack_tpu_torch.models.llama import tree_leaves
    from dstack_tpu_torch.models.moe import MoEConfig, init_params

    cuda = device == "cuda"
    base = cfg or MoEConfig.mixtral_8x7b()
    serve_cfg = dataclasses.replace(
        base, capacity_factor=MOE_SERVE_CAPACITY_FACTOR)
    out = {}

    params = int8_moe_params(torch, serve_cfg, device, seed=2)
    out["int8_weight_bytes"] = sum(
        t.numel() * t.element_size() for t in tree_leaves(params))
    out["int8"], runs = moe_serve(torch, serve_cfg, params, "moe int8 paged",
                                  device, paged=True, long_prompt=True)
    out["int8"].update(moe_check_tokens(
        torch, dequantized_dense(torch, params, serve_cfg.dtype), serve_cfg,
        runs, "moe int8 paged"))
    log("moe int8: " + json.dumps(out["int8"]))
    del params, runs
    if cuda:
        torch.cuda.empty_cache()

    bf16_cfg = dataclasses.replace(
        serve_cfg, num_layers=min(MOE_BF16_LAYERS, serve_cfg.num_layers))
    params = init_params(bf16_cfg, device,
                         torch.Generator(device=device).manual_seed(3))
    out["bf16_weight_bytes"] = sum(
        t.numel() * t.element_size() for t in tree_leaves(params))
    out["bf16"], runs = moe_serve(torch, bf16_cfg, params, "moe bf16 dense",
                                  device, paged=False, long_prompt=False)
    out["bf16"].update(moe_check_tokens(torch, params, bf16_cfg, runs,
                                        "moe bf16 dense"))
    log("moe bf16: " + json.dumps(out["bf16"]))
    del params, runs
    if cuda:
        torch.cuda.empty_cache()

    train_cfg = dataclasses.replace(base, num_layers=MOE_TRAIN_LAYERS)
    out["train"] = moe_train(torch, train_cfg, device, MOE_TRAIN_BATCH, seq,
                             MOE_TRAIN_STEPS)
    log("moe train: " + json.dumps(out["train"]))
    return out


# -- phase 13: serving under a mesh --------------------------------------------

#: phase 13: two ranks share card 0 under gloo (NCCL refuses two ranks on
#: one device; gloo takes the all-reduce, all-gather and broadcast of CUDA
#: tensors that serving needs: PERF.md records the card run that showed
#: it).  On four cards and more, the layers of Llama-3-70B that the
#: one-card forward holding its tokens runs (the full depth, 141 GB, fits
#: no card: its engine is timed beside this cut one)
MESH_CUT_LAYERS = 4
MESH_SERVE_TIMEOUT_S = 600
#: the mesh engines' shape: batch 8, max_len 1024, paged, block 32
MESH_ENGINE_KW = dict(batch_size=8, max_len=1024, paged=True)


def mesh_cases(n: int) -> dict:
    """Phase 13's engines on ``n`` cards: ``nccl``, the world of the cards
    (in this process at one card); ``gloo``, two ranks on card 0;
    ``server``, the model ``--tensor-parallel n`` serves (None at one
    card).  A case with ``"held": False`` is timed only; a cut-depth case
    of the same model and mesh beside it is held to a one-card forward."""
    nccl = [{"name": f"llama3-8b-t{n}-{kv or 'bf16'}", "model": "llama3-8b",
             "mesh": {"tensor": n}, "seed": 1, "kv": kv}
            for kv in (None, "int8")]
    if n >= 4 and 8 % n == 0:
        nccl += [{"name": f"llama3-70b-t{n}", "model": "llama3-70b",
                  "mesh": {"tensor": n}, "seed": 1, "held": False},
                 {"name": f"llama3-70b-t{n}-cut", "model": "llama3-70b",
                  "layers": MESH_CUT_LAYERS, "mesh": {"tensor": n},
                  "seed": 1},
                 {"name": f"mixtral-e{n}", "model": "mixtral",
                  "mesh": {"expert": n}, "seed": 3, "held": False},
                 {"name": f"mixtral-e{n}-cut", "model": "mixtral",
                  "layers": MOE_BF16_LAYERS, "mesh": {"expert": n},
                  "seed": 3}]
    gloo = [{"name": "llama3-8b-t2", "model": "llama3-8b",
             "mesh": {"tensor": 2}, "seed": 1},
            {"name": "mixtral-e2", "model": "mixtral",
             "layers": MOE_BF16_LAYERS, "mesh": {"expert": 2}, "seed": 3}]
    server = None if n == 1 else "llama3-70b" if n >= 4 else "llama3-8b"
    return {"nccl": nccl, "gloo": gloo, "server": server}


def k5_label(model: str, tensor: int) -> str:
    """The K5 row of a served model at a tensor degree (Mixtral's
    attention is Llama-3-8B's: Hq 32, Hkv 8, D=128)."""
    base = "llama3-8b" if model == "mixtral" else model
    return base if tensor == 1 else f"{base}/tensor={tensor}"


def mesh_k5_rows(n: int) -> dict:
    """label -> (kv heads, query heads per kv head, page types) of every
    K5 shape that phase 13 runs under a tensor degree above 1 on ``n``
    cards."""
    cases = mesh_cases(n)
    runs = [(c["model"], c["mesh"].get("tensor", 1), c.get("kv") or "bf16")
            for c in cases["nccl"] + cases["gloo"]]
    if cases["server"]:
        runs.append((cases["server"], n, "bf16"))
    rows = {}
    for model, t, variant in runs:
        if t > 1:
            cfg = mesh_cfg(model)
            hkv, g, variants = rows.setdefault(
                k5_label(model, t), (cfg.num_kv_heads // t,
                                     cfg.num_heads // cfg.num_kv_heads, set()))
            variants.add(variant)
    return rows


def k5_row(case: dict) -> str:
    """The kernels line's K5 entry a phase-13 case launches."""
    return (f"paged_decode_attention[{case.get('kv') or 'bf16'},"
            f"{k5_label(case['model'], case['mesh'].get('tensor', 1))}]")


def mesh_cfg(name: str, layers=None):
    """A served config of phase 13: "llama3-8b", "llama3-70b" or
    "mixtral" (Mixtral-8x7B, dropless at MOE_SERVE_CAPACITY_FACTOR), cut
    to ``layers`` when given."""
    from dstack_tpu_torch.models.llama import LlamaConfig
    from dstack_tpu_torch.models.moe import MoEConfig

    cfg = {"llama3-8b": LlamaConfig.llama3_8b,
           "llama3-70b": LlamaConfig.llama3_70b,
           "mixtral": lambda: MoEConfig.mixtral_8x7b(
               capacity_factor=MOE_SERVE_CAPACITY_FACTOR)}[name]()
    return cfg if layers is None else dataclasses.replace(
        cfg, num_layers=layers)


def mesh_engine(cfg, seed: int, kv, mesh=None, params=None):
    from dstack_tpu_torch.serving.engine import InferenceEngine

    return InferenceEngine(cfg, params=params, rng_seed=seed, kv_quantize=kv,
                           mesh=mesh, device="cuda" if mesh is None else None,
                           **MESH_ENGINE_KW)


def counted_run(torch, engine, cfg, moe_routes: bool) -> tuple:
    """Phase 13's requests on a paged engine (one card's or rank 0's of a
    mesh): a warm-up; one 64-token prompt alone (TTFT); ENGINE_PROMPTS at
    12 tokens each, submitted at once (the tokens checked; with
    ``moe_routes`` the engine's router logits for them, engine_routes);
    BURST_PROMPTS at 64 tokens each (the decode step at a full batch).
    The paged-decode kernel's launches and the engine's decode steps are
    counted over the whole run.  Returns (numbers, the checked requests,
    their routes or None)."""
    from dstack_tpu_torch.ops import flash_attention as fa
    from dstack_tpu_torch.serving.engine import Request

    fa.paged_decode_attention.launches = 0
    steps0 = engine.decode_steps
    drive(torch, engine, [Request(tokens=list(range(40)), max_new_tokens=4)])
    single = Request(tokens=list(BURST_PROMPTS[2][:64]), max_new_tokens=16)
    drive(torch, engine, [single])
    checked = [Request(tokens=list(p), max_new_tokens=12)
               for p in ENGINE_PROMPTS]
    routes = None
    if moe_routes:
        with RouteTap() as tap:
            drive(torch, engine, checked)
        routes = engine_routes(torch, tap.calls, checked, cfg.num_layers,
                               engine.max_len)
    else:
        drive(torch, engine, checked)
    burst = [Request(tokens=list(p), max_new_tokens=64)
             for p in BURST_PROMPTS]
    drive(torch, engine, burst)
    if any(len(r.output) != 64 for r in burst):
        fail("mesh serving: a burst request ended short of 64 tokens")
    rate = decode_rate(burst)
    return ({"ttft_s": single.first_token_at - single.submitted_at,
             "decode_tok_per_s": rate, "decode_step_s": 8 / rate,
             "tokens": [r.output for r in checked],
             "launches": fa.paged_decode_attention.launches,
             "decode_steps": engine.decode_steps - steps0}, checked, routes)


def check_launches(label: str, cfg, runs: list) -> None:
    """Every rank's paged-decode launches = layers x its decode steps."""
    for r, run in enumerate(runs):
        if run["decode_steps"] <= 0 or (
                run["launches"] != cfg.num_layers * run["decode_steps"]):
            fail(f"{label}: rank {r} launched the paged-decode kernel "
                 f"{run['launches']} times over {run['decode_steps']} "
                 f"decode steps x {cfg.num_layers} layers")


def as_requests(prompts, outputs) -> list:
    from dstack_tpu_torch.serving.engine import Request

    reqs = []
    for p, out in zip(prompts, outputs):
        reqs.append(Request(tokens=list(p), max_new_tokens=len(out)))
        reqs[-1].output = list(out)
    return reqs


def mesh_serve_rank(torch, out_dir: str, spec_path: str) -> None:
    """One rank of a phase-13 world in its own process: the process group
    from the control plane's variables (``backend`` of the spec: NCCL, one
    card a rank; or gloo, ranks sharing a card), then each case's engine
    on its mesh, drawn from its seed (each rank its blocks): rank 0 runs
    counted_run and closes the engine, the others follow it.  Each
    rank writes its launches, decode steps and lockstep counts to
    ``rank<r>.json``; rank 0 adds its numbers and tokens, and the MoE
    cases' routes to ``routes_<case>.pt``."""
    import torch.distributed as dist

    from dstack_tpu_torch.ops import flash_attention as fa
    from dstack_tpu_torch.parallel import distributed
    from dstack_tpu_torch.parallel import mesh as mesh_lib

    spec = json.loads(Path(spec_path).read_text())
    backend = spec["backend"]
    distributed.initialize(force=True, device="cuda", backend=backend)
    try:
        rank, out = dist.get_rank(), {"backend": dist.get_backend()}
        for case in spec["cases"]:
            cfg = mesh_cfg(case["model"], case.get("layers"))
            mesh = mesh_lib.build_mesh(
                mesh_lib.MeshSpec(**case["mesh"]), "cuda",
                backend="gloo" if backend == "gloo" else None)
            engine = mesh_engine(cfg, case["seed"], case.get("kv"),
                                 mesh=mesh)
            if rank == 0:
                run, _, routes = counted_run(torch, engine, cfg,
                                             case["model"] == "mixtral")
                leader = engine._leader
                engine.close()
                run["checks_sent"] = leader.checks_sent if leader else 0
                if routes is not None:
                    torch.save([r.cpu() for r in routes],
                               Path(out_dir) / f"routes_{case['name']}.pt")
            else:
                fa.paged_decode_attention.launches = 0
                steps0 = engine.decode_steps
                run = engine.follow()
                run.update(launches=fa.paged_decode_attention.launches,
                           decode_steps=engine.decode_steps - steps0)
            torch.cuda.synchronize()
            run["max_memory_allocated_gb"] = (
                torch.cuda.max_memory_allocated() / 1e9)
            out[case["name"]] = run
            del engine
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def mesh_world(torch, backend: str, ranks: int, cases: list) -> tuple:
    """Run ``cases`` in a fresh world of ``ranks`` processes
    (mesh_serve_rank): under NCCL one card a rank (one node of ``ranks``
    cards), under gloo every rank on card 0 (``ranks`` nodes of one card
    on this host).  Fails unless every rank exits 0 within
    MESH_SERVE_TIMEOUT_S; returns (each rank's results, the MoE cases'
    routes)."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-mesh-"))
    spec_path = tmp / "spec.json"
    spec_path.write_text(json.dumps({"backend": backend, "cases": cases}))
    port = free_port()

    def env(r):
        one_node = backend == "nccl"
        e = dict(os.environ, DSTACK_MASTER_NODE_IP="127.0.0.1",
                 DSTACK_NODES_NUM="1" if one_node else str(ranks),
                 DSTACK_NODE_RANK="0" if one_node else str(r),
                 DSTACK_GPUS_PER_NODE=str(ranks) if one_node else "1",
                 LOCAL_RANK=str(r) if one_node else "0",
                 DSTACK_COORDINATOR_PORT=str(port))
        e.pop("DSTACK_GPUS_NUM", None)
        return e

    procs = []
    try:
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-serve-rank",
             str(tmp), str(spec_path)], env=env(r)) for r in range(ranks)]
        deadline = time.time() + MESH_SERVE_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
        codes = [p.returncode for p in procs]
        if any(codes):
            fail(f"mesh serving ({backend}, {ranks} ranks): ranks exited "
                 f"{codes}")
        results = [json.loads((tmp / f"rank{r}.json").read_text())
                   for r in range(ranks)]
        routes = {c["name"]: torch.load(tmp / f"routes_{c['name']}.pt")
                  for c in cases if c["model"] == "mixtral"}
    except subprocess.TimeoutExpired:
        fail(f"mesh serving: ranks still running after "
             f"{MESH_SERVE_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return results, routes


def check_world(label: str, cfg, case: dict, results: list) -> dict:
    """A world's case: launches exact on every rank, every follower in
    lockstep with rank 0 (it checked every token array rank 0 sent)."""
    runs = [r[case["name"]] for r in results]
    check_launches(label, cfg, runs)
    sent = runs[0]["checks_sent"]
    checked = [run["checked"] for run in runs[1:]]
    if sent <= 0 or any(c != sent for c in checked):
        fail(f"{label}: followers checked {checked} of rank 0's {sent} "
             f"token arrays")
    out = dict(runs[0])
    out.update(ranks=len(runs), followers_checked=checked,
               rank_launches=[run["launches"] for run in runs],
               rank_decode_steps=[run["decode_steps"] for run in runs],
               rank_max_memory_gb=[run["max_memory_allocated_gb"]
                                   for run in runs])
    return out


def hold_tokens(torch, params, cfg, outputs, label: str) -> float:
    """The checked requests' tokens, each the plain forward's argmax
    within phase 5's margin (0.1 std) on the one-card weights."""
    return greedy_gaps(torch, params, cfg,
                       as_requests(ENGINE_PROMPTS, outputs), 0.1, label, 12)


def drive_tp_server(n: int, config: str, layers: int) -> dict:
    """``--tensor-parallel n`` over HTTP (``config``, paged, seed 1): up,
    one-token completions (TTFT), five concurrent 64-token ones; rank 0's
    paged-decode launches (``/stats``) exactly layers x decode steps."""
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    log_path = ROOT / "dstack_tpu_torch" / "build" / "chip_smoke_tp.log"
    cmd = [sys.executable, "-m", "dstack_tpu_torch.serving.server",
           "--config", config, "--paged", "--batch-size", "8",
           "--max-len", "1024", "--seed", "1", "--port", str(port),
           "--tensor-parallel", str(n)]
    log("tp server: " + " ".join(cmd[1:]))
    with open(log_path, "w") as f:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=dict(
            os.environ, PYTHONPATH=str(ROOT)), stdout=f,
            stderr=subprocess.STDOUT)
    try:
        t0 = time.time()
        while http_ok(base + "/health") is False:
            if proc.poll() is not None or time.time() - t0 > 600:
                fail(f"tp server not up: {proc.poll()}")
            time.sleep(1.0)
        ttfts = []
        for i in range(4):
            t = time.time()
            status, body, _ = http(base + "/v1/completions", {
                "prompt": PROMPT.format(i=i), "max_tokens": 1})
            ttfts.append(time.time() - t)
            if status != 200:
                fail(f"tp server: one-token completion {status}")
        before = json.loads(http(base + "/stats")[1])
        results = [None] * 5

        def complete(i):
            status, body, _ = http(base + "/v1/completions", {
                "prompt": PROMPT.format(i=i), "max_tokens": 64})
            results[i] = (status, json.loads(body)["usage"][
                "completion_tokens"])

        threads = [threading.Thread(target=complete, args=(i,))
                   for i in range(5)]
        t_run = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.time() - t_run
        if any(r != (200, 64) for r in results):
            fail(f"tp server: completions {results}")
        after = json.loads(http(base + "/stats")[1])
        launches = (after["kernels"]["paged_decode_attention"]["launches"]
                    - before["kernels"]["paged_decode_attention"]["launches"])
        steps = after["decode_steps"] - before["decode_steps"]
        if steps <= 0 or launches != layers * steps:
            fail(f"tp server: {launches} launches over {steps} steps x "
                 f"{layers} layers")
        return {"ttft_s": sorted(ttfts[1:])[1], "launches": launches,
                "decode_steps": steps, "burst_wall_s": wall}
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def http_ok(url: str) -> bool:
    try:
        return http(url, timeout=5)[0] == 200
    except OSError:
        return False


def mesh_serving_phase(torch) -> dict:
    """Phase 13: the engine under a mesh, against the one-card engine on
    the same weights (Llama-3-8B, seed 1: bf16 and int8 pages).

    (a) The world of the visible cards under NCCL (:func:`mesh_cases`): at
    one card in this process (a group of one, mesh MeshSpec(tensor=1));
    at N cards a world of N rank processes and the server's
    ``--tensor-parallel N`` over HTTP.  (b) Two rank processes on card 0
    under gloo: Llama-3-8B at tensor=2, then Mixtral-8x7B at
    MOE_BF16_LAYERS layers in bf16 at expert=2 (seed 3).  Each held
    engine's checked tokens are held to the plain forward of the same
    seed's weights on one card within 0.1 std (Mixtral: moe_check_tokens
    with rank 0's routing replayed); K5 launches layers x decode steps on
    every rank, every follower checks rank 0's tokens equal to its own.
    Prints the decode step and TTFT of each beside the one-card
    engine's; each run names its K5 row (``k5_row``)."""
    from dstack_tpu_torch.models import moe
    from dstack_tpu_torch.models.llama import init_params
    from dstack_tpu_torch.parallel import distributed
    from dstack_tpu_torch.parallel import mesh as mesh_lib

    n = torch.cuda.device_count()
    cases = mesh_cases(n)
    cfg = mesh_cfg("llama3-8b")
    params = init_params(cfg, "cuda",
                         torch.Generator(device="cuda").manual_seed(1))
    out = {"cards": n}
    moe_held, moe_routes = [], {}
    for kv in (None, "int8"):
        label = f"mesh one-card {kv or 'bf16'}"
        engine = mesh_engine(cfg, 1, kv, params=params)
        run, reqs, _ = counted_run(torch, engine, cfg, False)
        check_launches(label, cfg, [run])
        run["worst_gap_std"] = greedy_gaps(torch, params, cfg, reqs, 0.1,
                                           label, 12)
        run["k5_row"] = k5_row({"model": "llama3-8b", "mesh": {}, "kv": kv})
        out[f"one_card_{kv or 'bf16'}"] = run
        log(f"{label}: " + json.dumps(run))
        del engine
        torch.cuda.empty_cache()

    if n == 1:
        env0 = dict(os.environ)
        os.environ.update(DSTACK_MASTER_NODE_IP="127.0.0.1",
                          DSTACK_NODES_NUM="1", DSTACK_NODE_RANK="0",
                          DSTACK_GPUS_PER_NODE="1", LOCAL_RANK="0",
                          DSTACK_COORDINATOR_PORT=str(free_port()))
        distributed.initialize(force=True)
        try:
            backend = torch.distributed.get_backend()
            if backend != "nccl":
                fail(f"mesh serving: the world's backend is {backend}")
            mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(tensor=1))
            for case in cases["nccl"]:
                kv = case["kv"]
                label = f"mesh nccl world 1 {kv or 'bf16'}"
                engine = mesh_engine(cfg, 1, kv, mesh=mesh)
                run, reqs, _ = counted_run(torch, engine, cfg, False)
                check_launches(label, cfg, [run])
                run["worst_gap_std"] = greedy_gaps(torch, params, cfg, reqs,
                                                   0.1, label, 12)
                run["k5_row"] = k5_row(case)
                out[f"nccl_world1_{kv or 'bf16'}"] = run
                log(f"{label}: " + json.dumps(run))
                del engine
                torch.cuda.empty_cache()
        finally:
            torch.distributed.destroy_process_group()
            os.environ.clear()
            os.environ.update(env0)
    else:
        results, moe_routes = mesh_world(torch, "nccl", n, cases["nccl"])
        for case in cases["nccl"]:
            label = f"mesh nccl world {n} {case['name']}"
            case_cfg = mesh_cfg(case["model"], case.get("layers"))
            run = check_world(label, case_cfg, case, results)
            run["k5_row"] = k5_row(case)
            out[f"nccl_world{n}_{case['name']}"] = run
            if not case.get("held", True):
                if any(len(t) != 12 for t in run["tokens"]):
                    fail(f"{label}: tokens {run['tokens']}")
            elif case["model"] == "mixtral":
                moe_held.append((label, case, run))
                continue
            elif case["model"] == "llama3-8b":
                run["worst_gap_std"] = hold_tokens(torch, params, cfg,
                                                   run["tokens"], label)
            else:
                cut = init_params(case_cfg, "cuda", torch.Generator(
                    device="cuda").manual_seed(case["seed"]))
                run["worst_gap_std"] = hold_tokens(torch, cut, case_cfg,
                                                   run["tokens"], label)
                del cut
                torch.cuda.empty_cache()
            log(f"{label}: " + json.dumps(run))
        server = cases["server"]
        out[f"tp_server_{n}"] = drive_tp_server(
            n, server, mesh_cfg(server).num_layers)
        out[f"tp_server_{n}"]["k5_row"] = k5_row(
            {"model": server, "mesh": {"tensor": n}})
        log(f"mesh tp server ({server}): "
            + json.dumps(out[f"tp_server_{n}"]))

    gloo = cases["gloo"]
    results, routes = mesh_world(torch, "gloo", 2, gloo)
    moe_routes.update(routes)
    if any(r["backend"] != "gloo" for r in results):
        fail(f"mesh serving: gloo world backends {results}")
    run = check_world("mesh gloo llama3-8b t2", cfg, gloo[0], results)
    run["worst_gap_std"] = hold_tokens(torch, params, cfg, run["tokens"],
                                       "mesh gloo llama3-8b t2")
    run["k5_row"] = k5_row(gloo[0])
    out["gloo_llama3-8b-t2"] = run
    log("mesh gloo llama3-8b t2: " + json.dumps(run))
    del params
    torch.cuda.empty_cache()
    moe_cfg = mesh_cfg("mixtral", MOE_BF16_LAYERS)
    mparams = moe.init_params(
        moe_cfg, "cuda", torch.Generator(device="cuda").manual_seed(3))
    engine = mesh_engine(moe_cfg, 3, None, params=mparams)
    one, _, _ = counted_run(torch, engine, moe_cfg, False)
    check_launches("mesh one-card mixtral", moe_cfg, [one])
    one["k5_row"] = k5_row({"model": "mixtral", "mesh": {}})
    out["one_card_mixtral"] = one
    del engine
    torch.cuda.empty_cache()
    run = check_world("mesh gloo mixtral e2", moe_cfg, gloo[1], results)
    run["k5_row"] = k5_row(gloo[1])
    out["gloo_mixtral-e2"] = run
    # the Mixtral cases of every world, each with its rank 0's routing
    for label, case, run in moe_held + [("mesh gloo mixtral e2", gloo[1],
                                         run)]:
        run.update(moe_check_tokens(
            torch, mparams, moe_cfg,
            [(as_requests(ENGINE_PROMPTS, run["tokens"]),
              [r.to("cuda") for r in moe_routes[case["name"]]])], label))
        log(f"{label}: " + json.dumps(run))
    del mparams
    torch.cuda.empty_cache()
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
    if sys.argv[1:2] == ["--sharded-rank"]:
        sharded_rank(torch, *sys.argv[2:5])
        return 0
    if sys.argv[1:2] == ["--mesh-serve-rank"]:
        mesh_serve_rank(torch, *sys.argv[2:4])
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if sys.argv[1:] == ["--wrapper-host"]:
        log(json.dumps({"wrapper_host_us": wrapper_host_report(torch)}))
        return 0

    from dstack_tpu_torch.models.llama import LlamaConfig
    from dstack_tpu_torch.ops import _build

    t0 = time.time()
    logs = _build.build()
    log(f"build: {time.time() - t0:.1f} s")
    for name, text in logs.items():
        log(f"nvcc {name}:\n{text.strip()}")

    kernels, paged = check_kernels(torch,
                                   mesh_k5_rows(torch.cuda.device_count()))
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
                                  f"{cfg_name} {variant} pages")["launches"]
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
    resumed = resume_phase(torch)
    for way in ("fwd", "bwd"):
        kernels[f"flash_attention_{way}[llama3-1b,D=64]"]["launches"] += \
            resumed[f"{way}_launches"]
    sharded = sharded_phase(torch)
    for way in ("fwd", "bwd"):
        # Mixtral's attention has the 8B geometry's shapes
        for name, row in (("llama3-8b-fit", "llama3-8b-fit,D=128"),
                          ("llama3-1b", "llama3-1b,D=64"),
                          ("mixtral", "llama3-8b-fit,D=128")):
            kernels[f"flash_attention_{way}[{row}]"]["launches"] += \
                sharded[name][f"{way}_launches"]
    imported = hf_import_phase(torch)
    kernels["paged_decode_attention[bf16,llama3-1b]"]["launches"] += \
        imported["launches"]
    features = serving_features_phase(torch)
    kernels["paged_decode_attention[bf16,llama3-8b]"]["launches"] += \
        features["launches"]
    # Mixtral's attention is Llama-3-8B's (32 query heads, 8 kv heads,
    # head_dim 128): its launches run the rows' shapes
    mixtral = moe_phase(torch)
    kernels["paged_decode_attention[bf16,llama3-8b]"]["launches"] += \
        mixtral["int8"]["launches"]
    for way in ("fwd", "bwd"):
        kernels[f"flash_attention_{way}[llama3-8b-fit,D=128]"][
            "launches"] += mixtral["train"][f"{way}_launches"]
    meshed = mesh_serving_phase(torch)
    for run in meshed.values():
        # every rank's launches, each on its Hkv / tensor kv heads (its
        # row's shape); the server's count rank 0's
        if isinstance(run, dict) and "k5_row" in run:
            kernels[run["k5_row"]]["launches"] += sum(
                run.get("rank_launches", [run["launches"]]))
    for k in kernels.values():
        if k["launches"] <= 0:
            fail(f"{k['name']} was not launched on its path")
    log("server summary: " + json.dumps(served))
    log("share summary: " + json.dumps(share))
    log("paged-decode cases: " + json.dumps(paged))
    for run in trained:
        log("train summary: " + json.dumps(
            {k: run[k] for k in ("config", "tokens_per_s", "mfu_6nd",
                                 "step_median_s", "max_memory_allocated_gb",
                                 "losses")}))
    log("train-plain summary: " + json.dumps(plain))
    log("resume summary: " + json.dumps(
        {k: resumed[k] for k in ("snapshot_bytes", "copy_s", "write_s",
                                 "restore_s", "step_median_s",
                                 "tokens_per_s", "telemetry_tokens_per_s",
                                 "telemetry_mfu", "resumed_loss_rel_err")}))
    log("sharded summary: " + json.dumps({
        "card": card, "world": sharded["world"],
        "backend": sharded["backend"], "mesh": sharded["mesh"],
        **{name: {k: sharded[name][k] for k in (
            "unsharded", "sharded", "loss_rel_err", "grad_norm_rel_err",
            "fwd_launches", "bwd_launches")} for name in (
                "llama3-8b-fit", "llama3-1b", "mixtral")},
        "mixtral_mesh": sharded["mixtral"]["mesh"],
        "snapshot": {k: sharded["llama3-1b"][k] for k in (
            "snapshot_bytes", "copy_s", "write_s", "restore_s",
            "resumed_loss_rel_err")}}))
    log("hf-import summary: " + json.dumps(
        {k: imported[k] for k in ("bytes", "load_s", "load_gb_per_s",
                                  "launches")}))
    log("serving-features summary: " + json.dumps(features))
    log("moe summary: " + json.dumps(
        {"weight_bytes": {k: mixtral[f"{k}_weight_bytes"]
                          for k in ("int8", "bf16")},
         **{k: {n: v for n, v in mixtral[k].items()
                if n in ("ttft_s", "long_ttft_s", "decode_tok_per_s",
                         "decode_step_s", "max_memory_allocated_gb",
                         "tokens_checked", "flips", "flip_max_router_gap",
                         "router_max_abs_diff", "worst_gap_std")}
            for k in ("int8", "bf16")},
         "train": {n: mixtral["train"][n] for n in (
             "step_median_s", "tokens_per_s", "max_memory_allocated_gb",
             "losses", "aux_losses")},
         "train_plain": {n: mixtral["train"]["plain"][n] for n in (
             "loss_rel_err", "grad_norm_rel_err")}}))
    log("mesh-serving summary: " + json.dumps({
        "card": card, **{name: ({k: run[k] for k in (
            "ttft_s", "decode_step_s", "decode_tok_per_s", "launches",
            "decode_steps", "rank_launches", "followers_checked",
            "worst_gap_std", "flips", "rank_max_memory_gb") if k in run}
            if isinstance(run, dict) else run)
            for name, run in meshed.items()}}))
    # again here, so that the end of a long log still says which card
    log(f"card: {card}")
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
