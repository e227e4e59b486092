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
             Llama-3-8B geometry b4 s2048 D=128) and at the whole sequence
             of half the heads that a Ulysses rank holds at seq=2 in
             phase 14 (b1 s8192, Hq 16, Hkv 4, D=64 and D=128); times each
             kernel, its
             plain version and, as a yardstick only,
             scaled_dot_product_attention, beside the card's least time
             (bound).  Then the windowed forward and backward kernels
             (a sliding window) held to the windowed plain versions at
             edge shapes and at Trinity-Mini's launch (b8 s8192, Hq 32,
             Hkv 4, D=128, window 2048; two batch rows held), timed
             beside the causal kernels at that shape, their bound and
             SDPA given the window as a mask.  Then the row kernel
             (RMSNorm and its rotation epilogue, forward and backward)
             held to its plain versions in bf16 ulps (ROWNORM_ULPS) at
             edge cases and at the training cells' launches
             (ROWNORM_ROWS: Trinity-Mini's q/k at b8 s8192 with and
             without the rotation and its [65,536, 2048] norms;
             the Llama-3-8B geometry's and Mixtral's rotation at b4
             s2048, as phases 6 and 11 launch it, and [8192, 4096]
             norms), each timed beside its bytes bound, its plain
             versions and the eager autograd chain it replaced.  Then the
             AdamW kernel (the global-norm clip folded in) held to the
             plain three passes at the three training cells' leaf sets
             (ADAMW_CELLS, stacked as the cells hold them) and at
             ADAMW_EDGES over three steps, the norm above the clip,
             below it, above: given the plain path's norm, p, m and v
             bit for bit (ADAMW_ULPS); its own norm within
             ADAMW_NORM_RTOL, and the elements that then differ
             reported; each cell's set timed (both passes, and each
             alone) beside its bytes bound (16 B a bf16 parameter) and
             the plain path.  Then the
             loss's f32 logits from bf16 inputs against an f32 matmul.
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
             steps (forward x2 under remat), the row kernel exactly
             (want_row_launches: 2 norms a layer and the final one, q and
             k's rotation once a layer, forward x2), the AdamW kernel
             exactly (want_adamw_launches: a norm launch and a step
             launch a leaf dtype, each per 64 leaves of the unstacked
             state), and tokens/s, MFU and peak memory are printed.
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
             6 steps (loss falls, aux loss finite, flash, row-kernel
             and AdamW launches exact)
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
14. context-pipeline — sequence and pipeline parallelism on two rank
             processes sharing card 0 under gloo (initialize(force=True)
             from the control plane's variables, as phase 13's gloo pair),
             each run beside the same seed's weights and batch unsharded
             in this process (selective remat): (a) Ulysses, Llama-3.2-1B
             at full width and depth, b1 s8192 at seq=2 (a rank holds
             4096 positions and, after the all-to-all, the whole sequence
             of 16 query heads), 3 steps, and the Llama-3-8B geometry at
             CP_8B_LAYERS layers, b1 s8192, 2 steps; (b) ring, the same
             1B run (f32 blocks, no kernel); (c) the GPipe pipeline, the
             1B at stage=2 (8 layers a stage), b8 s1024,
             CP_PIPE_MICRO microbatches, 3 steps.  Fails unless every
             rank's losses are within CP_RTOL of the unsharded run's
             (loss 1e-3, grad norm 5e-3), both ranks run gloo, and each
             rank's flash launches are exactly (fwd, bwd) = (2 L S, L S)
             for Ulysses over S steps, none for ring, and (2 T S, T S)
             for the pipeline with T = (L / stages) x (M + stages - 1)
             ticks.  Prints each run's median step and tokens/s beside
             the unsharded run's, the collectives' share of one more step
             traced by torch.profiler (their collective.* host ranges
             over its wall: under gloo the whole collective, host copies
             included) and every rank's peak memory.  Gloo takes CUDA
             tensors in all-reduce, broadcast, both all-gathers,
             reduce-scatter and all_to_all_single, not in send/recv
             ("Bad address" on the H100), so ppermute goes through host
             memory under gloo.  context_pipeline_phase(torch,
             backend="nccl", ranks=4) runs the same at seq=4 and stage=4,
             a card a rank.
15. elastic — a replica's cold start (dstack_tpu_torch/elastic/),
             Llama-3.2-1B at full width and depth (bf16, paged), each
             replica a `python -m dstack_tpu_torch.serving.server`
             process: seeder A (weights from seed 5, published as a
             snapshot, --compile-cache) warms and puts its row-kernel
             and paged-decode libraries into its cache root; joiner B, from a copy of the
             package with an empty build/ and another seed, pulls A's
             weights and library (--weight-peers, --compile-cache-peers)
             as a --standby; cold replica C the same without a cache
             peer.  Fails unless B reports warming on /load and answers
             503 until POST /elastic/standby/activate, B ran no nvcc
             (compile_cache_misses 0, a peer hit) and C one a library, B's
             and C's weights came from A and their greedy tokens are A's,
             and every replica launched K5 exactly layers x decode steps.
             Then two trainer processes (the 1B at 2 layers, b1 s1024)
             through one cache root: T1 from the checkout (hits 3, puts
             3: K3/K4 and the row kernel), T2 from a copy with an empty
             build/ (misses 0, hits 3),
             each step's loss within 1e-3 of the same step in process and
             K3/K4 launched once a layer.  Prints the snapshot's bytes and
             write seconds, the pull's GB/s (timed in process), each
             replica's seconds from start to ready, B's and C's TTFT
             right after activation and each library's resolve seconds
             (C's: the nvcc leg).

16. mesh-serving-rest — (run right after phase 13) Llama-3-8B (full
             size, seed 1, batch 8, max_len 1024, paged) on one card
             beside two rank processes sharing it under gloo: (a)
             prefill/decode at tensor=2 both ways (a 300-token prompt's
             export through the wire codec, bitwise; the pair's export
             held to the one-card one within PD_EXPORT_RTOL, its first
             token its own logits' argmax, held with the decoded tokens
             to the plain forward; its agreement with the one-card
             token printed: the pair's row-parallel sums differ in
             bf16, so a near-tie may fall either way; each install
             decoded 16 tokens); (b) the
             weights over fsdp (MeshSpec(fsdp=2), each rank half the
             matrices, a layer gathered at use) in bf16, then with int8
             weights; (c) a one-card engine made under
             DSTACK_TPU_RAGGED_DECODE=0 (K5 over the full block-table
             span) beside the ragged one (both held to the plain
             forward; their agreement printed: K5's split count follows
             the table's width, so a near-tie may fall either way); (d)
             llama.decode_step on Llama-3.2-1B (full size), 16 greedy
             steps, and quant.memory_bytes of its bf16 and int8 trees.
             Every greedy token within 0.1 std of the plain forward (int8
             weights: of the dequantized tree), K5 launches exactly layers
             x decode steps on every rank, every follower checks every
             token array rank 0 produced.  Prints the export's worst
             errors, each engine's decode step and TTFT beside the
             one-card engine's, every rank's weights and peak memory.  On
             N cards phase 13's --tensor-parallel server also takes a
             prefill leg and a decode leg carrying its prefill_result,
             whose tokens must equal a colocated request's.
17. moe-dispatch — (run right after phase 14) MoE training under the
             mesh layouts the reference runs and phases 11-12 did not:
             two rank processes sharing card 0 under gloo (as phase 14's
             pair), Mixtral-8x7B's width at MOE_TRAIN_LAYERS layers, b4
             s2048, remat, bf16, SHARDED_STEPS steps of each run from seed
             0, one run after another: (a) MeshSpec(expert=2) with the
             batch over ("dcn", "data", "fsdp", "expert"), each rank b2
             and 4 of the 8 experts, each stripe's dispatch exchanged
             over expert to the experts' ranks and their outputs back;
             (b) MeshSpec(seq=2) with seq_axis="seq" and (c)
             MeshSpec(stage=2) with stage_axis="stage", replicas as in
             the reference's MoE (each rank the whole batch, sequence and
             model).  The unsharded run first, in this process (its state
             after step 1 written leaf by leaf to a temporary directory,
             its card memory freed before the pair starts).  Fails unless
             each rank's step 1 loss is within 1e-3 and grad norm within
             5e-3 of the unsharded step's, every leaf's parameter and
             first moment after step 1 is within MOE_UPDATE_RTOL_MESH of
             the rank's block of the unsharded update, run (a)'s expert
             leaves hold 4 experts a rank, both ranks run gloo, and each
             rank's flash launches are exactly (2 L S, L S).  Steps 2-3
             run free: their losses are printed beside the unsharded
             run's.  Prints each run's median step and tokens/s beside
             the unsharded run's, the exchange's bytes a layer a rank,
             the collective.* share of one more traced step and every
             rank's peak memory.  moe_dispatch_phase(torch,
             backend="nccl", ranks=4) runs (a) at data=2 x expert=2 and
             (b), (c) at seq=4 and stage=4, a card a rank.
18. trinity — (run right after phase 11) Trinity-Mini (afmoe) at its
             published widths, cut as the benchmark's cell cuts it
             (AFMOE_CUT: 8 layers, two dense, then two periods of three
             windowed and one full; 16 of the router's 128 experts held;
             a vocabulary of 25,024), AFMOE_STEPS steps at b8 s8192 from
             seed 0 through afmoe.make_train_step, selective remat.  Fails
             unless the loss falls, the expert bias moves with a zero
             mean, and a step launches the windowed kernels exactly
             (2 x 6, 6) times and the causal ones (2 x 2, 2), the row
             kernel's norms (65, 33) and q/k prologue (16, 8) times,
             of which the sliding layers' (12, 6) rotate, and AdamW's
             one norm launch and one step launch a leaf dtype; the windowed
             launches are the windowed rows' counts in the kernels'
             record, and the prologue's, by whether they rotated, the
             q/k rows'.  Prints the step, tokens/s, dropped tokens
             and peak memory.

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

from portbench.frozen.bounds import _least, flash_bounds, paged_decode_bound

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
#: train phase: steps of each trainer of :func:`trainer`: Llama-3.2-1B at
#: b8 s1024 and the Llama-3-8B layer geometry at L=6, b4 s2048, both with
#: selective remat (as the JAX package's bench trains them)
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
#: phase 14, context and pipeline parallelism on two gloo ranks sharing
#: the card: the sequence of the Ulysses and ring runs (b1; each rank
#: holds half), their steps, the Llama-3-8B geometry's depth and steps
#: there, the pipeline's batch, sequence and microbatches (stage=2), and
#: the seconds the ranks get in all
CP_SEQ, CP_STEPS = 8192, 3
CP_8B_LAYERS, CP_8B_STEPS = 4, 2
CP_PIPE_BATCH, CP_PIPE_SEQ, CP_PIPE_MICRO = 8, 1024, 4
CP_TIMEOUT_S = 480
#: each scheme's limits on its losses and grad norms against the
#: unsharded run's, relative (phase 12's)
CP_RTOL = {"ulysses": TRAIN_PLAIN_RTOL, "ring": TRAIN_PLAIN_RTOL,
           "pipeline": TRAIN_PLAIN_RTOL}
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
                bound_ms, bound_by, nbytes, flops = paged_decode_bound(
                    lengths, d, quant, hkv, g, BS)
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


def flash_rows() -> dict:
    """Row name -> (B, S, Hq, Hkv, D) of each timed flash shape: the
    trainers' (phase 6), and the whole sequence of half the heads that a
    Ulysses rank holds at seq=2 in phase 14 (b1 s8192, Hq 16, Hkv 4) at
    both head dims."""
    rows = {}
    for cfg_name in TRAIN_STEPS:
        cfg, batch, seq, _ = trainer(cfg_name)
        rows[cfg_name] = (batch, seq, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim)
    for cfg_name, d in (("llama3-1b", 64), ("llama3-8b-fit", 128)):
        rows[f"{cfg_name}/seq=2"] = (1, CP_SEQ, 16, 4, d)
    return rows


def check_flash_kernels(torch) -> dict:
    """Hold the forward (o, lse) and backward (dq, dk, dv) kernels to their
    plain versions at the shapes of flash_rows, and at FLASH_EDGE_SHAPES,
    and time each at flash_rows' shapes beside its plain version,
    scaled_dot_product_attention (the yardstick, never called by the
    port) and its bound."""
    import torch.nn.functional as F

    from dstack_tpu_torch.ops import flash_attention as fa

    for shape in FLASH_EDGE_SHAPES:
        errs = checked_flash_errors(torch, fa, shape, shape[4] ** -0.5)[2]
        log(f"kernel flash (B, S, Hq, Hkv, D) = {shape}: max err " + " ".join(
            f"{n} {e:.3e}" for n, e in errs.items()))
    out = {}
    for row, shape in flash_rows().items():
        d = shape[4]
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
            name = f"flash_attention_{part}[{row},D={d}]"
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
        log(f"kernel flash fwd+bwd [{row}]: kernels "
            f"{(times['fwd'] + times['bwd']) * 1e3:.1f} us, sdpa "
            f"{times['fwd_bwd_sdpa'] * 1e3:.1f} us")
        del q, k, v, do, o, lse, qt, kt, vt
        torch.cuda.empty_cache()
    return out


#: the windowed kernels' shapes, (B, S, Hq, Hkv, D, window): edge shapes
#: for correctness (a window inside one block, across two, not a multiple
#: of the block, MQA, D=64), then Trinity-Mini's training launch (b8
#: s8192, window 2048), held and timed
WINDOW_EDGE_SHAPES = ((2, 384, 4, 2, 128, 64), (1, 512, 8, 1, 128, 200),
                      (2, 640, 4, 4, 64, 130), (1, 256, 4, 2, 64, 2))
WINDOW_ROWS = {"trinity-mini": (8, 8192, 32, 4, 128, 2048)}
#: batch rows of a timed windowed launch held to the plain versions (the
#: plain scores of one row are 8.6 GB in f32 at s8192, Hq 32)
WINDOW_CHECK_ROWS = (0, 7)


def window_errors(torch, fa, shape, window: int, rows=None):
    """Both windowed kernels once at ``shape``, held to the plain versions
    (batch ``rows`` of it only, when given): (inputs, (o, lse), errors)
    as :func:`flash_errors` gives them."""
    q, k, v, do = flash_case(torch, shape, seed=shape[4] + window)
    scale = shape[4] ** -0.5
    o, lse = fa._flash_fwd_kernel(q, k, v, scale, window)
    grads = fa._flash_bwd_kernel(q, k, v, o, lse, do, scale, window)
    torch.cuda.synchronize()
    errs = {}
    for r in (range(shape[0]) if rows is None else rows):
        one = [t[r:r + 1] for t in (q, k, v, o, do)]
        want_o, want_lse = fa.flash_attention_fwd_plain(*one[:3], scale,
                                                        window)
        want_grads = fa.flash_attention_bwd_plain(
            *one[:3], one[3], lse[r:r + 1], one[4], scale, window)
        got = {"lse": lse[r:r + 1], "o": one[3]}
        got.update(zip(("dq", "dk", "dv"), (g[r:r + 1] for g in grads)))
        want = {"lse": want_lse, "o": want_o}
        want.update(zip(("dq", "dk", "dv"), want_grads))
        for n in got:
            e = (got[n].float() - want[n].float()).abs().max().item()
            errs[n] = max(errs.get(n, 0.0), e)
            if n != "lse":
                errs[n + "_row"] = max(errs.get(n + "_row", 0.0),
                                       row_rel_err(torch, got[n], want[n]))
        del want_o, want_lse, want_grads, want
        torch.cuda.empty_cache()
    return (q, k, v, do), (o, lse), errs


def checked_window_errors(torch, fa, shape, window: int, rows=None):
    out = window_errors(torch, fa, shape, window, rows)
    bad = flash_violations(out[2])
    if bad:
        fail(f"windowed flash kernels at (B, S, Hq, Hkv, D) = {shape}, "
             f"window {window} disagree with the plain versions: {bad} "
             f"(limits {FLASH_LIMITS})")
    return out


def check_window_kernels(torch) -> dict:
    """Hold the windowed forward and backward kernels to their plain
    versions at WINDOW_EDGE_SHAPES and WINDOW_ROWS, then time each
    WINDOW_ROWS launch beside its bound (the causal launch's bytes, the
    operations over the pairs the window keeps),
    the causal kernels at the same shape, and
    ``scaled_dot_product_attention`` given the window as a mask (the
    heads repeated for the grouped-query read, so a masked backend takes
    it; "not measured" where none does).  Checks the wrapper's windowed
    launch counters."""
    import torch.nn.functional as F

    from dstack_tpu_torch.ops import flash_attention as fa

    for *shape, window in WINDOW_EDGE_SHAPES:
        shape = tuple(shape)
        errs = checked_window_errors(torch, fa, shape, window)[2]
        log(f"kernel flash window {window} (B, S, Hq, Hkv, D) = {shape}: "
            f"max err " + " ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    before = (fa.flash_attention.window_fwd_launches,
              fa.flash_attention.window_bwd_launches,
              fa.flash_attention.fwd_launches, fa.flash_attention.bwd_launches)
    out = {}
    for row, (*shape, window) in WINDOW_ROWS.items():
        shape = tuple(shape)
        d = shape[4]
        scale = d ** -0.5
        (q, k, v, do), (o, lse), errs = checked_window_errors(
            torch, fa, shape, window, WINDOW_CHECK_ROWS)
        times = {
            "fwd": time_ms(torch, lambda: fa._flash_fwd_kernel(
                q, k, v, scale, window), 20),
            "bwd": time_ms(torch, lambda: fa._flash_bwd_kernel(
                q, k, v, o, lse, do, scale, window), 20),
            "fwd_causal": time_ms(torch, lambda: fa._flash_fwd_kernel(
                q, k, v, scale), 20),
        }
        _, causal_lse = fa._flash_fwd_kernel(q, k, v, scale)
        times["bwd_causal"] = time_ms(torch, lambda: fa._flash_bwd_kernel(
            q, k, v, o, causal_lse, do, scale), 20)
        group = shape[2] // shape[3]
        qt, kt, vt = (x.transpose(1, 2).repeat_interleave(
            group if x is not q else 1, dim=1).detach().requires_grad_()
            for x in (q, k, v))
        pos = torch.arange(shape[1], device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & (
            pos[:, None] - pos[None, :] < window)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask, scale=scale)

        try:
            with torch.no_grad():
                times["fwd_sdpa"] = time_ms(torch, sdpa, 5)
            ref = sdpa()
            times["bwd_sdpa"] = time_ms(torch, lambda: torch.autograd.grad(
                ref, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 5)
            del ref
        except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
            log(f"kernel flash window sdpa: not measured ({e})"[:300])
        del qt, kt, vt, mask
        torch.cuda.empty_cache()
        from portbench.families.afmoe import window_pairs

        pairs = shape[0] * shape[2] * window_pairs(shape[1], window)
        bounds = {part: _least(flash_bounds(shape)[part][2], mul * d * pairs)
                  for part, mul in (("fwd", 4), ("bwd", 10))}
        for part, errs_shown in (("fwd", ("o", "lse", "o_row")),
                                 ("bwd", ("dq", "dk", "dv", "dq_row",
                                          "dk_row", "dv_row"))):
            name = f"flash_attention_{part}[{row},D={d},window={window}]"
            bound_ms, bound_by, nbytes, flops = bounds[part]
            sdpa_ms = times.get(part + "_sdpa")
            out[name] = {
                "name": name, "route": "cuda", "source": FLASH_SOURCES[part],
                "replaces": "(new: Trinity's sliding-window layers)",
                "launches": 0,
                "max_abs_err": max(errs[n] for n in errs_shown
                                   if not n.endswith("_row")),
                "ms": times[part], "causal_ms": times[part + "_causal"],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": sdpa_ms,
            }
            log(f"kernel {name}: max err " + " ".join(
                f"{n} {errs[n]:.3e}" for n in errs_shown)
                + f"  kernel {times[part] * 1e3:.1f} us  causal "
                f"{times[part + '_causal'] * 1e3:.1f} us  bound "
                f"{bound_ms * 1e3:.1f} us by {bound_by} ({nbytes} B, "
                f"{flops} flop)  {flops / times[part] / 1e9:.1f} TFLOP/s, "
                f"{bound_ms / times[part]:.3f} of the bound, sdpa "
                + (f"{sdpa_ms * 1e3:.1f} us, "
                   f"{times[part] / sdpa_ms:.2f}x sdpa" if sdpa_ms
                   else "not measured"))
        del q, k, v, do, o, lse, causal_lse
        torch.cuda.empty_cache()
    after = (fa.flash_attention.window_fwd_launches,
             fa.flash_attention.window_bwd_launches,
             fa.flash_attention.fwd_launches, fa.flash_attention.bwd_launches)
    counted = [a - b for a, b in zip(after, before)]
    if counted[0] == 0 or counted[1] == 0:
        fail(f"flash window: the wrapper counted no windowed launch "
             f"({counted})")
    log(f"kernel flash window launches counted: windowed fwd/bwd "
        f"{counted[0]}/{counted[1]}, causal {counted[2]}/{counted[3]}")
    return out


#: latent attention's kernels (mla_fwd_kernel / mla_bwd_kernel, QK width
#: 192, V width 128, one kv head a query head): edge shapes (B, S, H) for
#: correctness (one 128-row tile, one head, an odd head count, a ragged
#: last 64-row tile), then Kanana-2-30B-A3B's training launch (b4 s16384,
#: 32 heads), held on the (batch row, head) pairs of MLA_CHECK_HEADS (the
#: plain scores of one head are 1 GB in f32 at s16384) and timed
MLA_WIDTHS = (192, 128)
MLA_EDGE_SHAPES = ((2, 128, 4), (1, 256, 1), (2, 384, 3), (1, 192, 5))
MLA_ROWS = {"kanana2-30b-a3b": (4, 16384, 32)}
MLA_CHECK_HEADS = ((0, 0), (3, 31))


def mla_case(torch, shape, seed: int):
    """Unit-normal bf16 q, k [B, S, H, 192] and v, do [B, S, H, 128]."""
    b, s, h = shape
    dq, dv = MLA_WIDTHS
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(d):
        return torch.randn((b, s, h, d), generator=gen, device="cuda").to(
            torch.bfloat16)

    return randn(dq), randn(dq), randn(dv), randn(dv)


def mla_errors(torch, fa, shape, heads=None):
    """Both latent-attention kernels once at ``shape``, held to the plain
    versions (on the (batch row, head) pairs ``heads`` alone, when given):
    (inputs, (o, lse), errors) as :func:`flash_errors` gives them."""
    q, k, v, do = mla_case(torch, shape, seed=sum(shape))
    scale = MLA_WIDTHS[0] ** -0.5
    o, lse = fa._flash_fwd_kernel(q, k, v, scale)
    grads = fa._flash_bwd_kernel(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    if heads is None:
        heads = [(r, h) for r in range(shape[0]) for h in range(shape[2])]
    errs = {}
    for r, h in heads:
        one = [t[r:r + 1, :, h:h + 1] for t in (q, k, v, o, do)]
        want_o, want_lse = fa.flash_attention_fwd_plain(*one[:3], scale)
        want_grads = fa.flash_attention_bwd_plain(
            *one[:3], one[3], lse[r:r + 1, h:h + 1], one[4], scale)
        got = {"lse": lse[r:r + 1, h:h + 1], "o": one[3]}
        got.update(zip(("dq", "dk", "dv"),
                       (g[r:r + 1, :, h:h + 1] for g in grads)))
        want = {"lse": want_lse, "o": want_o}
        want.update(zip(("dq", "dk", "dv"), want_grads))
        for n in got:
            e = (got[n].float() - want[n].float()).abs().max().item()
            errs[n] = max(errs.get(n, 0.0), e)
            if n != "lse":
                errs[n + "_row"] = max(errs.get(n + "_row", 0.0),
                                       row_rel_err(torch, got[n], want[n]))
        del want_o, want_lse, want_grads, want
    torch.cuda.empty_cache()
    return (q, k, v, do), (o, lse), errs


def checked_mla_errors(torch, fa, shape, heads=None):
    out = mla_errors(torch, fa, shape, heads)
    bad = flash_violations(out[2])
    if bad:
        fail(f"latent-attention flash kernels at (B, S, H) = {shape} "
             f"disagree with the plain versions: {bad} (limits "
             f"{FLASH_LIMITS})")
    return out


def check_mla_kernels(torch) -> dict:
    """Hold latent attention's forward and backward kernels to their plain
    versions at MLA_EDGE_SHAPES and MLA_ROWS, then time each MLA_ROWS
    launch beside its bound (``portbench.families.deepseek_v3.mla_bounds``:
    the operations of 2 * (192 + 128) forward and 2 * (3 * 192 + 2 * 128)
    backward a kept pair and head) and ``scaled_dot_product_attention``
    (the yardstick, never called by the port; "not measured" where no
    backend takes the widths).  Checks the wrapper's launch counters."""
    import torch.nn.functional as F

    from dstack_tpu_torch.ops import flash_attention as fa
    from portbench.families.deepseek_v3 import mla_bounds

    before = (fa.flash_attention.mla_fwd_launches,
              fa.flash_attention.mla_bwd_launches,
              fa.flash_attention.fwd_launches, fa.flash_attention.bwd_launches)
    for shape in MLA_EDGE_SHAPES:
        errs = checked_mla_errors(torch, fa, shape)[2]
        log(f"kernel flash mla (B, S, H) = {shape}: max err " + " ".join(
            f"{n} {e:.3e}" for n, e in errs.items()))
    out = {}
    dq_w, dv_w = MLA_WIDTHS
    for row, shape in MLA_ROWS.items():
        scale = dq_w ** -0.5
        (q, k, v, do), (o, lse), errs = checked_mla_errors(
            torch, fa, shape, MLA_CHECK_HEADS)
        times = {
            "fwd": time_ms(torch, lambda: fa._flash_fwd_kernel(
                q, k, v, scale), 10),
            "bwd": time_ms(torch, lambda: fa._flash_bwd_kernel(
                q, k, v, o, lse, do, scale), 10),
        }
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  scale=scale)

        try:
            with torch.no_grad():
                times["fwd_sdpa"] = time_ms(torch, sdpa, 5)
            ref = sdpa()
            times["bwd_sdpa"] = time_ms(torch, lambda: torch.autograd.grad(
                ref, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 5)
            del ref
        except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
            log(f"kernel flash mla sdpa: not measured ({e})"[:300])
        del qt, kt, vt
        torch.cuda.empty_cache()
        bounds = mla_bounds(*shape, dq_w, dv_w)
        for part, errs_shown in (("fwd", ("o", "lse", "o_row")),
                                 ("bwd", ("dq", "dk", "dv", "dq_row",
                                          "dk_row", "dv_row"))):
            name = f"flash_attention_{part}[{row},D={dq_w}/{dv_w}]"
            bound_ms, bound_by, nbytes, flops = bounds[part]
            sdpa_ms = times.get(part + "_sdpa")
            out[name] = {
                "name": name, "route": "cuda", "source": FLASH_SOURCES[part],
                "replaces": "(new: multi-head latent attention)",
                "launches": 0,
                "max_abs_err": max(errs[n] for n in errs_shown
                                   if not n.endswith("_row")),
                "ms": times[part], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": sdpa_ms,
            }
            log(f"kernel {name}: max err " + " ".join(
                f"{n} {errs[n]:.3e}" for n in errs_shown)
                + f"  kernel {times[part] * 1e3:.1f} us  bound "
                f"{bound_ms * 1e3:.1f} us by {bound_by} ({nbytes} B, "
                f"{flops} flop)  {flops / times[part] / 1e9:.1f} TFLOP/s, "
                f"{bound_ms / times[part]:.3f} of the bound, sdpa "
                + (f"{sdpa_ms * 1e3:.1f} us, "
                   f"{times[part] / sdpa_ms:.2f}x sdpa" if sdpa_ms
                   else "not measured"))
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    after = (fa.flash_attention.mla_fwd_launches,
             fa.flash_attention.mla_bwd_launches,
             fa.flash_attention.fwd_launches, fa.flash_attention.bwd_launches)
    counted = [a - b for a, b in zip(after, before)]
    if counted[0] == 0 or counted[1] == 0 or counted[2] or counted[3]:
        fail(f"flash mla: the wrapper counted {counted} (mla fwd/bwd, "
             f"causal fwd/bwd); expected latent launches alone")
    log(f"kernel flash mla launches counted: fwd/bwd {counted[0]}/"
        f"{counted[1]}")
    return out


#: the row kernel's cases (csrc/rownorm.cu): name -> (shapes, rows dtype,
#: weight dtype or None for no norm, rotation, positions a batch row).  One
#: shape: D-wide rows [T, n]; two: q and k [B, S, H, D] in one launch.  The
#: training cells' launches (Trinity-Mini's q/k at b8 s8192 with and without
#: the rotation and its [65,536, 2048] norms; the Llama-3-8B geometry's and
#: Mixtral's rotation at b4 s2048, as phases 6 and 11 train them, and their
#: [8192, 4096] norms: the Mistral and Mixtral cells' b2 s4096 launches
#: have the same 8192 x 40 head rows and rows, and a table of twice the
#: positions), held and timed; then
#: edge cases, held only: heads that leave threads of a row idle and row
#: counts that leave a block's rows, f32 rows with bf16 weights and the
#: other way round, a position table a batch row, the widest f32 rows
ROWNORM_ROWS = {
    "trinity-mini q/k norm+rope": (((8, 8192, 32, 128), (8, 8192, 4, 128)),
                                   "bf16", "bf16", True, False),
    "trinity-mini q/k norm": (((8, 8192, 32, 128), (8, 8192, 4, 128)),
                              "bf16", "bf16", False, False),
    "trinity-mini rows": (((65536, 2048),), "bf16", "bf16", False, False),
    "8b/mixtral q/k rope": (((4, 2048, 32, 128), (4, 2048, 8, 128)),
                            "bf16", None, True, False),
    "8b/mixtral rows": (((8192, 4096),), "bf16", "bf16", False, False),
}
ROWNORM_EDGES = {
    "q/k f32 norm+rope, D 96, positions a row": (
        ((3, 37, 5, 96), (3, 37, 1, 96)), "f32", "bf16", True, True),
    "q/k rope, D 64, Hq 7": (((2, 100, 7, 64), (2, 100, 1, 64)), "bf16",
                             None, True, False),
    "rows 999 x 3072, f32 weight": (((999, 3072),), "bf16", "f32", False,
                                    False),
    "rows 77 x 8192 f32": (((77, 8192),), "f32", "f32", False, False),
    "rows 5 x 64": (((5, 64),), "bf16", "bf16", False, False),
}
#: the kernel against its plain versions, in bf16 ulps of the row's largest
#: value (rows: the last dimension; dw: the whole vector): the two sum the
#: squares, the backward's dot product and dw's rows in another order,
#: which moves rstd and dot by a few f32 ulps and so may flip a bf16
#: rounding by one ulp; with the rotation, a flip of the normed value
#: carries into the rotated one, whose own rounding may flip too: 2 ulps.
#: An f32 output (rows, or a weight's gradient) has no bf16 rounding to
#: flip: its limit is 0.01 of those ulps (8e-5 of the row's largest)
ROWNORM_ULPS = {"bf16": 2.0, "f32": 0.01}
ROWNORM_RSTD_RTOL = 1e-5
ROWNORM_EPS = 1e-5


def rownorm_ulps(torch, got, want) -> float:
    """The largest |got - want| in bf16 ulps of its row's largest |want|."""
    got, want = got.float(), want.float()
    top = want.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return ((got - want).abs() / ulp).max().item()


def rownorm_case(torch, spec, device: str, seed: int):
    """(xs, ws, table, dys) of a row-kernel case drawn from ``seed``."""
    from dstack_tpu_torch.ops.rotary import rope_frequencies, rope_table

    shapes, dtype, wdtype, rope, batch_positions = spec
    types = {"bf16": torch.bfloat16, "f32": torch.float32}
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    xs = [(randn(s) * 3).to(types[dtype]) for s in shapes]
    ws = [None if wdtype is None else
          (1 + randn(s[-1:], 0.1)).to(types[wdtype]) for s in shapes]
    dys = [randn(s).to(types[dtype]) for s in shapes]
    table = None
    if rope:
        b, s, _, d = shapes[0]
        positions = torch.arange(s, device=device)[None, :]
        if batch_positions:
            positions = positions + 1000 * torch.arange(b, device=device)[
                :, None]
        inv = torch.from_numpy(rope_frequencies(d, 10_000.0)).to(device)
        table = rope_table(positions, inv)
    return xs, ws, table, dys


def rownorm_bounds(xs, ws, table) -> dict:
    """Least ms of the forward and the backward at a case's shapes, by
    bytes: each input read once and each output written once (forward: x,
    w, table -> y, rstd; backward: x, dy, w, rstd, table -> dx, dw; x and
    rstd only with a norm).  A few flops an element: bytes bound it."""
    norm = ws[0] is not None
    rows = sum(x.numel() // x.shape[-1] for x in xs)
    elems = sum(x.numel() * x.element_size() for x in xs)
    wbytes = sum(w.numel() * w.element_size() for w in ws) if norm else 0
    tbytes = 0 if table is None else table.numel() * 4
    rbytes = 4 * rows if norm else 0
    fwd = 2 * elems + wbytes + tbytes + rbytes
    bwd = (3 if norm else 2) * elems + 2 * wbytes + tbytes + rbytes
    return {"fwd": (fwd / PEAK_BYTES_PER_S * 1e3, fwd),
            "bwd": (bwd / PEAK_BYTES_PER_S * 1e3, bwd)}


def rownorm_errors(torch, spec, device: str, seed: int, fwd, bwd) -> tuple:
    """Run ``fwd``/``bwd`` (the kernel's, or on the CPU the plain ones) on
    a case and hold them to the plain versions; returns (inputs, the
    forward's rstds, errors by name)."""
    import types

    from dstack_tpu_torch.ops import rownorm

    xs, ws, table, dys = rownorm_case(torch, spec, device, seed)
    counter = types.SimpleNamespace(launches=0, bwd_launches=0,
                                    rope_launches=0, rope_bwd_launches=0)
    ys, rstds = fwd(xs, ws, table, ROWNORM_EPS, counter)
    dxs, dws = bwd(xs, ws, table, rstds, dys, [True] * len(xs), counter)
    errs, limits = {}, {}

    def held(name, got, want):
        errs[name] = rownorm_ulps(torch, got, want)
        limits[name] = ROWNORM_ULPS[
            "bf16" if got.dtype == torch.bfloat16 else "f32"]

    for i, (x, w, y, r, dy, dx, dw) in enumerate(zip(xs, ws, ys, rstds, dys,
                                                     dxs, dws)):
        want_y, want_r = rownorm.rows_fwd_plain(x, w, table, ROWNORM_EPS)
        want_dx, want_dw = rownorm.rows_bwd_plain(x, w, table, want_r, dy)
        held(f"y{i}", y, want_y)
        held(f"dx{i}", dx, want_dx)
        if w is not None:
            held(f"dw{i}", dw, want_dw)
            errs[f"rstd{i}"] = ((r - want_r).abs() / want_r).max().item()
            limits[f"rstd{i}"] = ROWNORM_RSTD_RTOL
        errs[f"y{i}_bitwise_share"] = (y == want_y).float().mean().item()
    bad = {n: e for n, e in errs.items() if n in limits and not
           e <= limits[n]}
    if bad:
        fail(f"row kernel at {spec} disagrees with the plain versions: {bad} "
             f"(limits {limits})")
    return (xs, ws, table, dys), rstds, errs


def check_rownorm_kernels(torch, device: str = "cuda", rows=None,
                          edges=None, kernels=None, iters: int = 20) -> dict:
    """Hold the row kernel (forward and backward) to its plain versions at
    ROWNORM_EDGES and ROWNORM_ROWS, then time each ROWNORM_ROWS launch
    beside its bytes bound, the plain versions and the eager autograd
    chain the layers ran before (rms_norm's and apply_rope's operations,
    forward with autograd saving, then backward).  ``kernels``: the
    (fwd, bwd) to hold (default the kernel's; a CPU rehearsal passes the
    plain ones, and times nothing)."""
    import types

    from dstack_tpu_torch.ops import rownorm

    fwd, bwd = kernels or (rownorm._kernel_fwd, rownorm._kernel_bwd)
    timed = device == "cuda"
    for name, spec in (ROWNORM_EDGES if edges is None else edges).items():
        errs = rownorm_errors(torch, spec, device, 5, fwd, bwd)[2]
        log(f"kernel rownorm [{name}]: " + " ".join(
            f"{n} {e:.3g}" for n, e in errs.items()))
    out = {}
    for row, spec in (ROWNORM_ROWS if rows is None else rows).items():
        (xs, ws, table, dys), rstds, errs = rownorm_errors(
            torch, spec, device, 7, fwd, bwd)
        counter = types.SimpleNamespace(launches=0, bwd_launches=0,
                                        rope_launches=0, rope_bwd_launches=0)
        need = [True] * len(xs)
        bounds = rownorm_bounds(xs, ws, table)
        times = {}
        if timed:
            times["fwd"] = time_ms(torch, lambda: fwd(
                xs, ws, table, ROWNORM_EPS, counter), iters)
            times["bwd"] = time_ms(torch, lambda: bwd(
                xs, ws, table, rstds, dys, need, counter), iters)
            plain = [rownorm.rows_fwd_plain(x, w, table, ROWNORM_EPS)[1]
                     for x, w in zip(xs, ws)]
            times["fwd_plain"] = time_ms(torch, lambda: [
                rownorm.rows_fwd_plain(x, w, table, ROWNORM_EPS)
                for x, w in zip(xs, ws)], 3)
            times["bwd_plain"] = time_ms(torch, lambda: [
                rownorm.rows_bwd_plain(x, w, table, r, dy)
                for x, w, r, dy in zip(xs, ws, plain, dys)], 3)
            del plain
            leaves = [t.detach().requires_grad_() for t in (*xs, *ws)
                      if t is not None]
            cos_sin = None if table is None else rownorm.table_cos_sin(table)

            def eager():
                outs = []
                for x, w in zip(leaves[:len(xs)], leaves[len(xs):] or
                                [None] * len(xs)):
                    y = x if w is None else rownorm.rows_fwd_plain(
                        x, w, None, ROWNORM_EPS)[0]
                    outs.append(y if cos_sin is None
                                else rownorm.rotate_half(y, *cos_sin))
                return outs

            times["fwd_eager"] = time_ms(torch, eager, 3)
            ref = eager()
            times["bwd_eager"] = time_ms(torch, lambda: torch.autograd.grad(
                ref, leaves, dys, retain_graph=True), 3)
            del ref, leaves
        shapes = " + ".join(str(tuple(x.shape)) for x in xs)
        for part in ("fwd", "bwd"):
            name = f"rownorm_{part}[{row}]"
            bound_ms, nbytes = bounds[part]
            out[name] = {
                "name": name, "route": "cuda",
                "source": "dstack_tpu_torch/ops/csrc/rownorm.cu",
                "replaces": "(none: the JAX package leaves this to XLA)",
                "shapes": shapes, "launches": 0,
                "max_err_ulps": max(e for n, e in errs.items()
                                    if n[0] in "yd"
                                    and not n.endswith("_share")),
                "ms": times.get(part), "bound_ms": bound_ms,
                "bound_by": "bytes", "bytes": nbytes,
                "plain_ms": times.get(part + "_plain"),
                "eager_ms": times.get(part + "_eager")}
            if timed:
                log(f"kernel {name} {shapes}: kernel "
                    f"{times[part] * 1e3:.1f} us, bound {bound_ms * 1e3:.1f}"
                    f" us ({nbytes} B), {bound_ms / times[part]:.3f} of the "
                    f"bound, plain {times[part + '_plain'] * 1e3:.1f} us, "
                    f"eager chain {times[part + '_eager'] * 1e3:.1f} us")
        log(f"kernel rownorm [{row}] errors: " + " ".join(
            f"{n} {e:.3g}" for n, e in errs.items()))
        del xs, ws, table, dys, rstds
        if timed:
            torch.cuda.empty_cache()
    return out


def row_launches() -> dict:
    """The row kernel's launch counters (rms_norm's D-wide rows, q and k's
    prologue), by name."""
    from dstack_tpu_torch.ops import rmsnorm, rotary

    return {"rms_norm": rmsnorm.rms_norm.launches,
            "rms_norm_bwd": rmsnorm.rms_norm.bwd_launches,
            "qk_prologue": rotary.qk_prologue.launches,
            "qk_prologue_bwd": rotary.qk_prologue.bwd_launches,
            "qk_prologue_rope": rotary.qk_prologue.rope_launches,
            "qk_prologue_rope_bwd": rotary.qk_prologue.rope_bwd_launches}


def want_row_launches(layers: int, norms: int, steps: int,
                      remat: bool = True, rotated=None) -> dict:
    """A train step's row-kernel launches: ``norms`` D-wide norms a layer
    and the final norm, q and k's prologue once a layer (with a rotation
    on ``rotated`` of the layers, default all), each forward twice under
    remat (every layer region is recomputed once) and once backward."""
    passes = 2 if remat else 1
    rotated = layers if rotated is None else rotated
    return {"rms_norm": steps * (passes * norms * layers + 1),
            "rms_norm_bwd": steps * (norms * layers + 1),
            "qk_prologue": steps * passes * layers,
            "qk_prologue_bwd": steps * layers,
            "qk_prologue_rope": steps * passes * rotated,
            "qk_prologue_rope_bwd": steps * rotated}


def counted_row_launches(before: dict) -> dict:
    return {n: v - before[n] for n, v in row_launches().items()}


def adamw_launches() -> dict:
    """The AdamW kernel's launch counters, by name."""
    from dstack_tpu_torch.ops import adamw

    return {"norm": adamw.norm_launches, "step": adamw.step_launches}


def want_adamw_launches(leaves, steps: int) -> dict:
    """``steps`` train steps' AdamW launches over the state's ``leaves``:
    one norm launch, and one step launch a leaf dtype present, for every
    ``adamw.MAX_LEAVES`` leaves (an unstacked state's hundreds take
    more)."""
    from collections import Counter

    from dstack_tpu_torch.ops import adamw

    def chunks(n: int) -> int:
        return -(-n // adamw.MAX_LEAVES)

    dtypes = Counter(p.dtype for p in leaves)
    return {"norm": steps * chunks(len(leaves)),
            "step": steps * sum(map(chunks, dtypes.values()))}


def counted_adamw_launches(before: dict) -> dict:
    return {n: v - before[n] for n, v in adamw_launches().items()}


#: the training cells whose leaf sets (stacked, as the cells hold them) the
#: AdamW kernel is held and timed at
ADAMW_CELLS = ("mixtral-train-s4096", "mistral7b-train-s4096",
               "trinity-train-s8192")
#: further leaf sets it is held at, for correctness only: (shape, dtype,
#: offset in elements) a leaf: lengths off the 16-byte vectors, bf16 and
#: f32 leaves mixed, leaves that are not 16-byte aligned (the scalar
#: path), and more leaves than one launch takes
ADAMW_EDGES = {
    "odd lengths": [((37, 5), "bf16", 0), ((3,), "f32", 0),
                    ((13, 8, 3), "bf16", 0), ((4099,), "bf16", 0)],
    "unaligned": [((1000,), "bf16", 1), ((999,), "f32", 3),
                  ((64, 64), "bf16", 0)],
    "130 leaves": [((1 + i * 37 % 200,), "f32" if i % 3 == 0 else "bf16", 0)
                   for i in range(130)]}
#: each checked step's gradients: N(0, 1) scaled to about this global
#: norm, above the clip of 1 at steps 1 and 3, below it at step 2
ADAMW_GRAD_NORMS = (30.0, 1e-3, 30.0)
#: the most the kernel's p, m and v may differ from the plain path's, in
#: ulps of the leaf's dtype, when its step pass is given the plain path's
#: norm: none, the arithmetic is the same operation for operation (bit for
#: bit on an H100 at the three cells' ~8e9 parameters, two steps each)
ADAMW_ULPS = 0
#: the most the kernel's norm may differ from the plain path's, relative:
#: both are f32 sums of up to ~4e9 squares in their own orders (the
#: kernel's threads each add ~14,000 in a row, ~sqrt(14,000) * 2^-24 =
#: 7e-6 relative), ~10x that.  Where the two norms differ, an f32 leaf's
#: clipped gradient differs in its last bits, and so may a bf16 one's
#: where the coefficient's rounding to bf16 sits on a tie: the kernel's
#: own steps are reported against the plain path's, not held
ADAMW_NORM_RTOL = 1e-4


def adamw_leaf_sets(torch, device: str) -> dict:
    """name -> a maker of the leaves: each of ADAMW_CELLS' program
    parameters (seed 0), then ADAMW_EDGES' (seed 3)."""
    from dstack_tpu_torch.models import llama
    from portbench import spec

    def cell(name):
        c = spec.find(name)
        return lambda: llama.tree_leaves(
            c.family.program_params(c.model_config(), 0, device))

    def edge(leaves):
        def make():
            gen = torch.Generator(device=device).manual_seed(3)
            types = {"bf16": torch.bfloat16, "f32": torch.float32}
            return [torch.randn(math.prod(shape) + offset, generator=gen,
                                device=device).mul_(0.02).to(types[dt])
                    [offset:].view(shape) for shape, dt, offset in leaves]
        return make

    return {**{name: cell(name) for name in ADAMW_CELLS},
            **{name: edge(leaves) for name, leaves in ADAMW_EDGES.items()}}


def adamw_diff(torch, got, want) -> tuple:
    """(elements that differ, the largest difference in ulps of their
    dtype) of two tensors of one dtype, bf16 or f32 (ordered bit patterns,
    in slices to keep the int64 copies small)."""
    itype, mag = {torch.bfloat16: (torch.int16, 0x7FFF),
                  torch.float32: (torch.int32, 0x7FFFFFFF)}[got.dtype]
    a, b = got.reshape(-1).view(itype), want.reshape(-1).view(itype)
    differ, worst, piece = 0, 0, 1 << 25
    for i in range(0, a.numel(), piece):
        x, y = a[i:i + piece].long(), b[i:i + piece].long()
        x = torch.where(x < 0, -(x & mag), x)
        y = torch.where(y < 0, -(y & mag), y)
        d = (x - y).abs()
        differ += int((d != 0).sum())
        worst = max(worst, int(d.max()))
    return differ, worst


def adamw_diffs(torch, name: str, ours, theirs, ours_opt,
                theirs_opt) -> dict:
    """{leaf dtype: (share of the p, m and v elements that differ, the
    largest difference in ulps)} of two states; their step counts must be
    equal."""
    acc = {}
    for p, q in zip(ours, theirs):
        a, b = ours_opt.state[p], theirs_opt.state[q]
        if a["step"].item() != b["step"].item():
            fail(f"adamw [{name}]: step {a['step'].item()} against the "
                 f"plain path's {b['step'].item()}")
        n, d, w = acc.get(str(p.dtype), (0, 0, 0))
        for x, y in ((p, q), (a["exp_avg"], b["exp_avg"]),
                     (a["exp_avg_sq"], b["exp_avg_sq"])):
            dx, wx = adamw_diff(torch, x, y)
            n, d, w = n + x.numel(), d + dx, max(w, wx)
        acc[str(p.dtype)] = (n, d, w)
    return {k: (d / n, w) for k, (n, d, w) in acc.items()}


def adamw_steps(torch, name, make, device: str, update) -> tuple:
    """Both sides from ``make()``'s leaves and fresh states, stepped
    len(ADAMW_GRAD_NORMS) times with random gradients: ours by ``update``,
    or (``update`` None) by the kernel's norm pass and its step pass given
    the plain path's norm; theirs by the plain path.  Returns (ours,
    theirs, both optimizers, the last gradients, each step's norms (ours,
    the plain path's), the diffs after step 1 and after the last)."""
    from dstack_tpu_torch.models import train
    from dstack_tpu_torch.ops import adamw

    opt = train.default_optimizer()
    ours = make()
    theirs = [p.clone() for p in ours]
    ours_opt, theirs_opt = opt.init(ours), opt.init(theirs)
    hyper = adamw._hyper(ours_opt, opt.grad_clip)
    scale = sum(p.numel() for p in ours) ** -0.5
    gen = torch.Generator(device=device).manual_seed(11)
    norms, diffs = [], {}
    for i, target in enumerate(ADAMW_GRAD_NORMS):
        grads = [torch.empty_like(p).normal_(generator=gen).mul_(
            target * scale) for p in ours]
        copies = [g.clone() for g in grads]
        want = adamw.update_plain(theirs, copies, theirs_opt, opt.grad_clip)
        del copies
        if update is not None:
            got = update(ours, grads, ours_opt, opt.grad_clip)
        else:
            states = [adamw.state_of(ours_opt, p) for p in ours]
            table = adamw._table(ours, grads, states, [True] * len(ours))
            got = adamw._norm_pass(table, ours[0].device).sqrt()
            # sqrt(fl(x * x)) is x in binary floating point: the step
            # pass clips by the plain path's norm exactly
            echoed = adamw._step_pass(table, want * want, hyper)
            if echoed.item() != want.item():
                fail(f"adamw [{name}]: the step pass read the norm "
                     f"{echoed.item()} for {want.item()}")
        norms.append((got.item(), want.item()))
        if i in (0, len(ADAMW_GRAD_NORMS) - 1):
            diffs[f"step{i + 1}"] = adamw_diffs(torch, name, ours, theirs,
                                                ours_opt, theirs_opt)
    return ours, theirs, ours_opt, theirs_opt, grads, norms, diffs


def check_adamw_kernels(torch, sets=None, device: str = "cuda",
                        update=None, iters: int = 10) -> dict:
    """Hold the AdamW kernel to the plain three passes at each leaf set of
    ``sets`` (default adamw_leaf_sets(): the training cells', stacked as
    they hold them, then ADAMW_EDGES), both sides from the same
    parameters and fresh states, len(ADAMW_GRAD_NORMS) steps of random
    gradients (the norm above the clip, below it, above; adamw_steps).
    First the kernel's step pass given the plain path's norm: p, m and v
    after step 1 and after the last within ADAMW_ULPS, and the kernel's
    norm within ADAMW_NORM_RTOL of the plain path's.  Then the kernel's
    whole step (its own norm): the share of elements that differ and the
    largest difference, by leaf dtype, reported.  Then times each of
    ADAMW_CELLS' whole step, its norm pass and its step pass, beside their
    bytes bounds (16 B a bf16 parameter, 32 an f32 one; 2 and 4 of them
    the norm's), and the plain path.  ``update``: the whole step held to
    the plain path (default the kernel's; a CPU rehearsal passes
    ``adamw.update_plain``, skips the step pass alone and times
    nothing)."""
    from dstack_tpu_torch.models import train
    from dstack_tpu_torch.ops import adamw

    on_card = device == "cuda"
    clip = train.default_optimizer().grad_clip
    out = {}
    for name, make in (sets or adamw_leaf_sets(torch, device)).items():
        before = adamw_launches()
        checked = {}
        if on_card:
            checked["same_norm"] = adamw_steps(torch, name, make, device,
                                               None)[-2:]
            torch.cuda.empty_cache()
        ours, theirs, ours_opt, theirs_opt, grads, norms, diffs = \
            adamw_steps(torch, name, make, device,
                        update or adamw._kernel_update)
        checked["kernel"] = (norms, diffs)
        launches = counted_adamw_launches(before)
        numel = {dt: sum(p.numel() for p in ours if p.dtype == dt)
                 for dt in (torch.bfloat16, torch.float32)}
        norm_bytes = sum(n * dt.itemsize for dt, n in numel.items())
        times = {}
        if on_card and name in ADAMW_CELLS:
            times["update"] = time_ms(torch, lambda: adamw._kernel_update(
                ours, grads, ours_opt, clip), iters)
            states = [ours_opt.state[p] for p in ours]
            table = adamw._table(ours, grads, states, [True] * len(ours))
            hyper = adamw._hyper(ours_opt, clip)
            sumsq = adamw._norm_pass(table, ours[0].device)
            times["norm"] = time_ms(torch, lambda: adamw._norm_pass(
                table, ours[0].device), iters)
            times["step"] = time_ms(torch, lambda: adamw._step_pass(
                table, sumsq, hyper), iters)
            plain_grads = [g.clone() for g in grads]
            times["plain"] = time_ms(torch, lambda: adamw.update_plain(
                theirs, plain_grads, theirs_opt, clip), 3)
            del table, sumsq, plain_grads
        bound = {part: k * norm_bytes / PEAK_BYTES_PER_S * 1e3
                 for part, k in (("update", 8), ("norm", 1), ("step", 7))}
        rel = {way: [abs(a - b) / b for a, b in norms]
               for way, (norms, _) in checked.items()}
        row = {"name": f"adamw[{name}]", "route": "cuda",
               "source": "dstack_tpu_torch/ops/csrc/adamw.cu",
               "replaces": "(none: the JAX package leaves optax's clip and "
                           "adamw to XLA)",
               "shapes": f"{len(ours)} leaves, "
                         f"{numel[torch.bfloat16]} bf16 + "
                         f"{numel[torch.float32]} f32 parameters",
               "launches": launches["norm"] + launches["step"],
               "launches_by_pass": launches, "norm_rel_err": rel,
               "diffs": {way: d for way, (_, d) in checked.items()},
               "ms": times.get("update"), "bound_ms": bound["update"],
               "bound_by": "bytes", "bytes": 8 * norm_bytes,
               "norm_ms": times.get("norm"), "norm_bound_ms": bound["norm"],
               "step_ms": times.get("step"), "step_bound_ms": bound["step"],
               "plain_ms": times.get("plain")}
        log(f"kernel adamw [{name}]: " + json.dumps(row))
        if times:
            out[row["name"]] = row
            log(f"kernel adamw [{name}] {row['shapes']}: " + ", ".join(
                f"{part} {times[part] * 1e3:.1f} us (bound "
                f"{bound[part] * 1e3:.1f} us, "
                f"{bound[part] / times[part]:.3f} of it)"
                for part in ("update", "norm", "step"))
                + f"; plain {times['plain'] * 1e3:.1f} us")
        bad = [f"norm {e:.3g}" for e in rel["kernel"]
               if not e <= ADAMW_NORM_RTOL]
        for step, by_dtype in checked.get("same_norm", (0, {}))[1].items():
            bad += [f"{step} {dtype}: {ulps} ulps"
                    for dtype, (_, ulps) in by_dtype.items()
                    if not ulps <= ADAMW_ULPS]
        del ours, theirs, ours_opt, theirs_opt, grads
        if on_card:
            torch.cuda.empty_cache()
        if bad:
            fail(f"adamw [{name}] disagrees with the plain path: {bad} "
                 f"(limits {ADAMW_NORM_RTOL} relative, {ADAMW_ULPS} ulps)")
    return out


#: Trinity-Mini's training cut as the benchmark's cell runs it: the first
#: 8 layers (both dense ones, then two periods of three windowed and one
#: full), 16 of the router's 128 experts held, an eighth of the vocabulary;
#: b8 s8192, the windowed rows' launch shape
AFMOE_CUT = dict(num_layers=8, held_experts=(0, 16), vocab_size=25_024)
AFMOE_BATCH, AFMOE_SEQ, AFMOE_STEPS = 8, 8192, 4


def afmoe_phase(torch, cfg=None, device: str = "cuda", batch: int = AFMOE_BATCH,
                seq: int = AFMOE_SEQ, steps: int = AFMOE_STEPS) -> dict:
    """Trinity-Mini at its published widths (``AFMOE_CUT``) trained
    ``steps`` steps through ``afmoe.make_train_step`` at the port's default
    remat, on one repeated batch of random tokens from seed 0.  Checks the
    loss is finite and falls, the expert bias moved with a zero mean, and,
    on the card, that the windowed kernels ran once a sliding layer a step
    backward and twice forward (selective remat recomputes the layer) and
    the causal ones so on the full layers."""
    from dstack_tpu_torch.models import afmoe, train
    from dstack_tpu_torch.models.llama import tree_leaves
    from dstack_tpu_torch.ops import flash_attention as fa

    cfg = cfg or afmoe.AfmoeConfig.trinity_mini(**AFMOE_CUT)
    gen = torch.Generator(device=device).manual_seed(0)
    opt = train.default_optimizer()
    t0 = time.time()
    state = afmoe.create_state(gen, cfg, opt, device=device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                           device=device, dtype=torch.int32)
    step_fn = afmoe.make_train_step(cfg, opt)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    init_s = time.time() - t0
    counters = ("fwd_launches", "bwd_launches", "window_fwd_launches",
                "window_bwd_launches")
    for name in counters:
        setattr(fa.flash_attention, name, 0)
    rows_before, adamw_before = row_launches(), adamw_launches()
    losses, norms, dropped, times = [], [], [], []
    for _ in range(steps):
        t = time.time()
        state, metrics = step_fn(state, {"tokens": tokens})
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        dropped.append(metrics["dropped_tokens"].sum().item())
        if device == "cuda":
            torch.cuda.synchronize()
        times.append(time.time() - t)
    launches = {name: getattr(fa.flash_attention, name) for name in counters}
    sliding = sum(map(cfg.sliding, range(cfg.num_layers)))
    full = cfg.num_layers - sliding
    want = {"fwd_launches": 2 * full * steps, "bwd_launches": full * steps,
            "window_fwd_launches": 2 * sliding * steps,
            "window_bwd_launches": sliding * steps}
    if device == "cuda" and launches != want:
        fail(f"train trinity-mini: flash launches {launches}, expected "
             f"{want}")
    # four D-wide norms a layer (attention's and the MLP's, before and
    # after), q and k normed on every layer and rotated on the sliding ones
    rows = counted_row_launches(rows_before)
    want_rows = want_row_launches(cfg.num_layers, 4, steps, rotated=sliding)
    if device == "cuda" and rows != want_rows:
        fail(f"train trinity-mini: row-kernel launches {rows}, expected "
             f"{want_rows}")
    adam = counted_adamw_launches(adamw_before)
    want_adam = want_adamw_launches(tree_leaves(state.params), steps)
    if device == "cuda" and adam != want_adam:
        fail(f"train trinity-mini: AdamW launches {adam}, expected "
             f"{want_adam}")
    if not all(map(math.isfinite, losses + norms)):
        fail(f"train trinity-mini: non-finite loss or grad norm: {losses} "
             f"{norms}")
    if not losses[-1] < losses[0]:
        fail(f"train trinity-mini: loss did not fall: {losses}")
    bias = state.buffers["expert_bias"]
    if not (bias.abs().amax() > 0
            and bias.sum(-1).abs().amax() < 1e-6 * cfg.num_experts):
        fail(f"train trinity-mini: the expert bias did not move with a "
             f"zero mean: {bias.sum(-1).tolist()}")
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    out = {"config": "trinity-mini", "num_layers": cfg.num_layers,
           "held_experts": cfg.held_experts, "batch": batch,
           "seq": seq, "steps": steps, "init_s": init_s, "losses": losses,
           "grad_norms": norms, "dropped_tokens": dropped, "step_s": times,
           "step_median_s": step_s, "tokens_per_s": batch * seq / step_s,
           "max_memory_allocated_gb": (torch.cuda.max_memory_allocated() / 1e9
                                       if device == "cuda" else None),
           "sliding_layers": sliding, "row_launches": rows,
           "adamw_launches": adam, **launches}
    log("train: " + json.dumps(out))
    del state, step_fn
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


#: Kanana-2-30B-A3B's training cut as the benchmark's cell runs it: the
#: first 12 of 48 layers (the dense one, then 11 routed), 16 of the
#: router's 128 experts held, an eighth of the vocabulary; b4 s16384
KANANA_CUT = dict(num_layers=12, held_experts=(0, 16), vocab_size=16_032)
KANANA_BATCH, KANANA_SEQ, KANANA_STEPS = 4, 16384, 4


def kanana_phase(torch, cfg=None, device: str = "cuda",
                 batch: int = KANANA_BATCH, seq: int = KANANA_SEQ,
                 steps: int = KANANA_STEPS) -> dict:
    """Kanana-2-30B-A3B at its published widths (``KANANA_CUT``) trained
    ``steps`` steps through ``deepseek.make_train_step`` at the port's
    default remat, on one repeated batch of random tokens from seed 0.
    Checks the loss is finite and falls, the expert bias moved with a
    zero mean, and, on the card, that latent attention's kernels ran once
    a layer a step backward and twice forward (selective remat recomputes
    the layer) and no other flash kernel ran; the row kernel and AdamW
    as their counts say (three norms a layer: attention's, the latent's
    and the MLP's; no q/k prologue: the rotation is plain torch)."""
    from dstack_tpu_torch.models import deepseek, train
    from dstack_tpu_torch.models.llama import tree_leaves
    from dstack_tpu_torch.ops import flash_attention as fa

    cfg = cfg or deepseek.DeepseekV3Config.kanana2_30b_a3b(**KANANA_CUT)
    gen = torch.Generator(device=device).manual_seed(0)
    opt = train.default_optimizer()
    t0 = time.time()
    state = deepseek.create_state(gen, cfg, opt, device=device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                           device=device, dtype=torch.int32)
    step_fn = deepseek.make_train_step(cfg, opt)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    init_s = time.time() - t0
    counters = ("fwd_launches", "bwd_launches", "window_fwd_launches",
                "window_bwd_launches", "mla_fwd_launches",
                "mla_bwd_launches")
    for name in counters:
        setattr(fa.flash_attention, name, 0)
    rows_before, adamw_before = row_launches(), adamw_launches()
    losses, norms, dropped, times = [], [], [], []
    for _ in range(steps):
        t = time.time()
        state, metrics = step_fn(state, {"tokens": tokens})
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        dropped.append(metrics["dropped_tokens"].sum().item())
        if device == "cuda":
            torch.cuda.synchronize()
        times.append(time.time() - t)
    launches = {name: getattr(fa.flash_attention, name) for name in counters}
    want = dict.fromkeys(counters, 0)
    want.update(mla_fwd_launches=2 * cfg.num_layers * steps,
                mla_bwd_launches=cfg.num_layers * steps)
    if device == "cuda" and launches != want:
        fail(f"train kanana2: flash launches {launches}, expected {want}")
    rows = counted_row_launches(rows_before)
    want_rows = {name: 0 if name.startswith("qk_prologue") else n
                 for name, n in want_row_launches(cfg.num_layers, 3,
                                                  steps).items()}
    if device == "cuda" and rows != want_rows:
        fail(f"train kanana2: row-kernel launches {rows}, expected "
             f"{want_rows}")
    adam = counted_adamw_launches(adamw_before)
    want_adam = want_adamw_launches(tree_leaves(state.params), steps)
    if device == "cuda" and adam != want_adam:
        fail(f"train kanana2: AdamW launches {adam}, expected {want_adam}")
    if not all(map(math.isfinite, losses + norms)):
        fail(f"train kanana2: non-finite loss or grad norm: {losses} "
             f"{norms}")
    if not losses[-1] < losses[0]:
        fail(f"train kanana2: loss did not fall: {losses}")
    bias = state.buffers["expert_bias"]
    if not (bias.abs().amax() > 0
            and bias.sum(-1).abs().amax() < 1e-6 * cfg.num_experts):
        fail(f"train kanana2: the expert bias did not move with a zero "
             f"mean: {bias.sum(-1).tolist()}")
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    out = {"config": "kanana2-30b-a3b", "num_layers": cfg.num_layers,
           "held_experts": cfg.held_experts, "batch": batch,
           "seq": seq, "steps": steps, "init_s": init_s, "losses": losses,
           "grad_norms": norms, "dropped_tokens": dropped, "step_s": times,
           "step_median_s": step_s, "tokens_per_s": batch * seq / step_s,
           "max_memory_allocated_gb": (torch.cuda.max_memory_allocated() / 1e9
                                       if device == "cuda" else None),
           "row_launches": rows, "adamw_launches": adam, **launches}
    log("train: " + json.dumps(out))
    del state, step_fn
    if device == "cuda":
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
    """(config, batch, seq, remat) of one of the trainers: Llama-3.2-1B
    at b8 s1024 ("llama3-1b") and the Llama-3-8B layer geometry at L=6,
    b4 s2048 ("llama3-8b-fit"), both with selective remat, as the JAX
    package's bench.py trains them (its ``_measure`` passes remat=True)."""
    from dstack_tpu_torch.models.llama import LlamaConfig

    if name == "llama3-1b":
        return LlamaConfig.llama3_1b(), 8, 1024, True
    if name == "llama3-8b-fit":
        return LlamaConfig.llama3_8b_fit(num_layers=6), 4, 2048, True
    raise KeyError(name)


def run_train(torch, cfg_name: str, steps: int) -> dict:
    """``steps`` train steps of the trainer ``cfg_name`` on one repeated
    batch of random tokens, from a random init (seed 0), unstacked.  Checks the loss is finite and falls, and that
    the flash kernels ran exactly once per layer per step forward (twice
    under remat: the backward recomputes the layer) and once backward."""
    from dstack_tpu_torch.models import train
    from dstack_tpu_torch.models.llama import tree_leaves
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
    rows_before, adamw_before = row_launches(), adamw_launches()
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
    rows = counted_row_launches(rows_before)
    want_rows = want_row_launches(cfg.num_layers, 2, steps, per_layer == 2)
    if rows != want_rows:
        fail(f"train {cfg_name}: row-kernel launches {rows}, expected "
             f"{want_rows}")
    adam = counted_adamw_launches(adamw_before)
    want_adam = want_adamw_launches(tree_leaves(state.params), steps)
    if adam != want_adam:
        fail(f"train {cfg_name}: AdamW launches {adam}, expected "
             f"{want_adam}")
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
           "fwd_launches": fwd, "bwd_launches": bwd, "row_launches": rows,
           "adamw_launches": adam}
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
    from dstack_tpu_torch.telemetry.training import (TrainTelemetry,
                                                     step_flops)

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

        def record_step(self, wall, tokens, n_devices=1, recompiled=False,
                        flops=None):
            self.walls.append(wall)
            super().record_step(wall, tokens, n_devices, recompiled, flops)

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
            return step_flops(cfg, batch, seq) / wall / PEAK_BF16_FLOPS

        out.update(losses=base.losses, step_median_s=step_s,
                   tokens_per_s=tokens / step_s, mfu=mfu(step_s),
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
    from dstack_tpu_torch.models.data import rank_tokens
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
            tokens = rank_tokens(tokens, mesh)
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
    from dstack_tpu_torch.models.data import rank_tokens
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
        return {"tokens": rank_tokens(tokens, mesh) if sharded else tokens}

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
    from dstack_tpu_torch.models import moe
    from dstack_tpu_torch.models.data import rank_tokens
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
    out = {"num_layers": cfg.num_layers, "batch": batch, "seq": seq,
           "steps": SHARDED_STEPS,
           "mesh": {k: v for k, v in spec.sizes.items() if v > 1} or
           {"expert": 1}}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def start(**kw):
        return moe_start(torch, cfg, batch, seq, device, **kw)

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
    stripe = {"tokens": rank_tokens(tokens, mesh)}
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


def dequantized_dense(torch, params, dtype,
                      names=("wq", "wk", "wv", "wo")) -> dict:
    """``params`` with its layer matrices ``names`` (by default the
    attention's) and head dequantized to ``dtype`` and the rest left as
    they are: with the default, the tree ``moe.forward`` takes (its
    attention multiplies plain tensors, its expert stacks take int8 as
    the reference's ``qeinsum`` does); with every matrix, a Llama tree
    the plain forward takes."""
    def deq(w):
        return (w["q"].to(dtype) * w["s"][..., None, :].to(dtype)
                if isinstance(w, dict) else w)

    out = dict(params, layers={
        k: deq(w) if k in names else w
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
    from dstack_tpu_torch.models.llama import tree_leaves
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
    rows_before, adamw_before = row_launches(), adamw_launches()
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
    rows = counted_row_launches(rows_before)
    want_rows = want_row_launches(cfg.num_layers, 2, steps)
    if cuda and rows != want_rows:
        fail(f"moe train: row-kernel launches {rows}, expected {want_rows}")
    adam = counted_adamw_launches(adamw_before)
    want_adam = want_adamw_launches(tree_leaves(state.params), steps)
    if cuda and adam != want_adam:
        fail(f"moe train: AdamW launches {adam}, expected {want_adam}")
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
           "fwd_launches": fwd, "bwd_launches": bwd, "row_launches": rows,
           "adamw_launches": adam}
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
    """A served config of phase 13 or 16: "llama3-8b", "llama3-70b" or
    "mixtral" (Mixtral-8x7B, dropless at MOE_SERVE_CAPACITY_FACTOR), or
    "tiny" for a CPU rehearsal; cut to ``layers`` when given."""
    from dstack_tpu_torch.models.llama import LlamaConfig
    from dstack_tpu_torch.models.moe import MoEConfig

    cfg = {"llama3-8b": LlamaConfig.llama3_8b,
           "llama3-70b": LlamaConfig.llama3_70b,
           # a CPU rehearsal's
           "tiny": lambda: dataclasses.replace(LlamaConfig.tiny(),
                                               max_seq_len=1024),
           "mixtral": lambda: MoEConfig.mixtral_8x7b(
               capacity_factor=MOE_SERVE_CAPACITY_FACTOR)}[name]()
    return cfg if layers is None else dataclasses.replace(
        cfg, num_layers=layers)


def mesh_engine(cfg, seed: int, kv, mesh=None, params=None,
                device: str = "cuda", **kw):
    from dstack_tpu_torch.serving.engine import InferenceEngine

    return InferenceEngine(cfg, params=params, rng_seed=seed, kv_quantize=kv,
                           mesh=mesh, device=device if mesh is None else None,
                           **MESH_ENGINE_KW, **kw)


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
    on its mesh, drawn from its seed (each rank its blocks; a case may
    name a serving ``policy`` and ``quantize``): rank 0 runs the case's
    ``run`` (counted_run by default; "pd": pd_rank_run; "light":
    light_run) and closes the engine, the others follow it.  Each rank
    writes its launches, decode steps, lockstep counts and weight bytes to
    ``rank<r>.json``; rank 0 adds its numbers and tokens, and the MoE
    cases' routes to ``routes_<case>.pt``."""
    import torch.distributed as dist

    from dstack_tpu_torch.models.llama import ShardingPolicy
    from dstack_tpu_torch.ops import flash_attention as fa
    from dstack_tpu_torch.parallel import distributed
    from dstack_tpu_torch.parallel import mesh as mesh_lib
    from dstack_tpu_torch.serving.quant import memory_bytes

    spec = json.loads(Path(spec_path).read_text())
    backend, device = spec["backend"], spec.get("device", "cuda")
    distributed.initialize(force=True, device=device, backend=backend)
    try:
        rank, out = dist.get_rank(), {"backend": dist.get_backend()}
        for case in spec["cases"]:
            cfg = mesh_cfg(case["model"], case.get("layers"))
            mesh = mesh_lib.build_mesh(
                mesh_lib.MeshSpec(**case["mesh"]), device,
                backend="gloo" if backend == "gloo" else None)
            policy = case.get("policy")
            engine = mesh_engine(
                cfg, case["seed"], case.get("kv"), mesh=mesh,
                sharding_policy=policy and ShardingPolicy(**dict(
                    policy, batch_axes=tuple(policy["batch_axes"]))),
                quantize=case.get("quantize"))
            if rank == 0:
                kind, routes = case.get("run", "counted"), None
                if kind == "pd":
                    run = pd_rank_run(torch, engine, case)
                elif kind == "light":
                    run = light_run(torch, engine, FSDP_NEW_TOKENS)
                else:
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
            run["max_memory_allocated_gb"] = None
            if device == "cuda":
                torch.cuda.synchronize()
                run["max_memory_allocated_gb"] = (
                    torch.cuda.max_memory_allocated() / 1e9)
            run["weight_gb"] = memory_bytes(engine.params) / 1e9
            out[case["name"]] = run
            del engine
            if device == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def mesh_world(torch, backend: str, ranks: int, cases: list,
               device: str = "cuda") -> tuple:
    """Run ``cases`` in a fresh world of ``ranks`` processes
    (mesh_serve_rank): under NCCL one card a rank (one node of ``ranks``
    cards), under gloo every rank on card 0 (``ranks`` nodes of one card
    on this host; ``device="cpu"``: on the CPU, a rehearsal).  Fails
    unless every rank exits 0 within MESH_SERVE_TIMEOUT_S; returns (each
    rank's results, the MoE cases' routes)."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-mesh-"))
    spec_path = tmp / "spec.json"
    spec_path.write_text(json.dumps({"backend": backend, "cases": cases,
                                     "device": device}))
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
                                   for run in runs],
               rank_weight_gb=[run["weight_gb"] for run in runs])
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
        pd = tp_server_pd_legs(base, layers)
        after = json.loads(http(base + "/stats")[1])
        launches = (after["kernels"]["paged_decode_attention"]["launches"]
                    - before["kernels"]["paged_decode_attention"]["launches"])
        steps = after["decode_steps"] - before["decode_steps"]
        if steps <= 0 or launches != layers * steps:
            fail(f"tp server: {launches} launches over {steps} steps x "
                 f"{layers} layers")
        return {"ttft_s": sorted(ttfts[1:])[1], "launches": launches,
                "decode_steps": steps, "burst_wall_s": wall, **pd}
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def tp_server_pd_legs(base: str, layers: int) -> dict:
    """Phase 16 on N cards: the ``--tensor-parallel`` server takes a
    prefill leg (every KV head of every layer in its prefill_result) and a
    decode leg carrying it, whose 16 token ids must equal a colocated
    request's."""
    from dstack_tpu_torch.serving.wire import PD_PHASE_HEADER

    payload = {"prompt": PROMPT.format(i=7), "max_tokens": 16,
               "return_token_ids": True}
    t0 = time.time()
    status, result, _ = http_json(base + "/v1/completions", payload,
                                  {PD_PHASE_HEADER: "prefill"})
    prefill_s = time.time() - t0
    if status != 200 or result["kv_k"]["shape"][0] != layers:
        fail(f"tp server pd: the prefill leg answered {status}")
    t0 = time.time()
    status, decoded, _ = http_json(
        base + "/v1/completions", dict(payload, prefill_result=result),
        {PD_PHASE_HEADER: "decode"})
    decode_s = time.time() - t0
    colocated = http_json(base + "/v1/completions", payload)[1]
    got = decoded["choices"][0]["token_ids"] if status == 200 else None
    want = colocated["choices"][0]["token_ids"]
    if got != want or len(want) != 16:
        fail(f"tp server pd: the decode leg answered {status} with {got}, "
             f"the colocated request {want}")
    return {"pd_prefill_s": prefill_s, "pd_decode_s": decode_s,
            "pd_kv_shape": result["kv_k"]["shape"]}


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


# -- phase 16: the rest of serving under a mesh -------------------------------

#: phase 16(a)'s prompt: 300 tokens, as phase 10's PD export
PD_PROMPT = tuple((i * 53 + 17) % 256 for i in range(300))
PD_NEW_TOKENS = 16
#: the gloo pair's bf16 export against the one-card engine's: the
#: largest |difference| of ks, vs and logits over each array's largest
#: |value|.  The pair's row-parallel products sum two bf16 partials
#: where one card accumulates in f32, and a layer's input carries the
#: earlier layers' differences: a few bf16 steps (2^-8) at the top of
#: the range after 32 layers
PD_EXPORT_RTOL = 5e-2
#: tokens each request of phase 16(b) decodes: every forward under fsdp
#: gathers the weights through host memory (gloo), 12-13 s a forward of
#: the whole 8B on the H100's host
FSDP_NEW_TOKENS = 8
#: phase 16(b)'s int8-weight leg's depth, cut to keep the script near
#: 800 s (at full depth its forward took 6-7 s)
FSDP_INT8_LAYERS = 8
FSDP_POLICY = {"batch_axes": ["fsdp"], "fsdp_axis": "fsdp",
               "tensor_axis": None}
#: phase 16(d): Llama-3.2-1B decode_step steps after the prompt
DECODE_API_STEPS = 16


def pd_wire(torch, exp: dict, label: str) -> str:
    """An export as the prefill leg's JSON (the server's wire codec),
    its round trip checked bitwise."""
    from dstack_tpu_torch.serving.server import _arr_from_wire, _arr_to_wire

    wire = {k: _arr_to_wire(exp[k]) for k in ("ks", "vs", "logits")}
    for k, v in wire.items():
        back = _arr_from_wire(v)
        if back.dtype != exp[k].dtype or not torch.equal(back, exp[k]):
            fail(f"{label}: {k} changed on the wire")
    return json.dumps(dict(wire, first_token=exp["first_token"],
                           length=exp["length"]))


def pd_prefill(text: str) -> dict:
    """A decode leg's ``Request.prefill`` from :func:`pd_wire`'s JSON."""
    from dstack_tpu_torch.serving.server import _arr_from_wire

    return {k: (_arr_from_wire(v) if k in ("ks", "vs", "logits") else v)
            for k, v in json.loads(text).items()}


def pd_rank_run(torch, engine, case: dict) -> dict:
    """Rank 0 of phase 16(a)'s pair: a warm-up, the one-card engine's
    export (``case["import"]``, wire JSON) installed and decoded, then the
    pair's export of the same prompt through the wire codec, written to
    ``case["export"]``.  K5 launches and decode steps over the run."""
    from dstack_tpu_torch.ops import flash_attention as fa
    from dstack_tpu_torch.serving.engine import Request

    fa.paged_decode_attention.launches = 0
    steps0 = engine.decode_steps
    drive(torch, engine, [Request(tokens=list(range(40)), max_new_tokens=4)])
    installed = Request(tokens=list(PD_PROMPT), max_new_tokens=PD_NEW_TOKENS,
                        prefill=pd_prefill(Path(case["import"]).read_text()))
    install_s = drive(torch, engine, [installed])
    t0 = time.perf_counter()
    exp = engine.prefill_export(list(PD_PROMPT),
                                max_new_tokens=PD_NEW_TOKENS)
    export_s = time.perf_counter() - t0
    text = pd_wire(torch, exp, "pd pair")
    Path(case["export"]).write_text(text)
    return {"tokens": [installed.output], "install_and_decode_s": install_s,
            "export_s": export_s, "wire_bytes": len(text),
            "launches": fa.paged_decode_attention.launches,
            "decode_steps": engine.decode_steps - steps0}


def light_run(torch, engine, new_tokens: int) -> dict:
    """ENGINE_PROMPTS submitted at once, ``new_tokens`` each, on a paged
    engine (one card's or rank 0's of a mesh): TTFT (the first prompt's
    prefill alone; no warm-up, which under fsdp would cost a forward of
    seconds), the decode step (the last first token to the last token
    over the steps decoded), the tokens, and K5 launches and decode steps
    over the run."""
    from dstack_tpu_torch.ops import flash_attention as fa
    from dstack_tpu_torch.serving.engine import Request

    fa.paged_decode_attention.launches = 0
    steps0 = engine.decode_steps
    reqs = [Request(tokens=list(p), max_new_tokens=new_tokens)
            for p in ENGINE_PROMPTS]
    drive(torch, engine, reqs)
    steps = engine.decode_steps - steps0
    return {"ttft_s": reqs[0].first_token_at - reqs[0].submitted_at,
            "decode_step_s": (max(r.finished_at for r in reqs)
                              - max(r.first_token_at for r in reqs)) / steps,
            "tokens": [r.output for r in reqs],
            "launches": fa.paged_decode_attention.launches,
            "decode_steps": steps}


def export_errors(torch, got: dict, want: dict) -> dict:
    """ks, vs and logits: the largest |got - want| over want's largest
    |value|."""
    return {k: float((got[k].float() - want[k].float()).abs().max()
                     / want[k].float().abs().max())
            for k in ("ks", "vs", "logits")}


def decode_api_part(torch, cfg=None, device: str = "cuda") -> dict:
    """Phase 16(d): ``llama.decode_step`` from ``init_kv_caches`` on
    Llama-3.2-1B (full size, seed 2): the first ENGINE_PROMPTS prompt a
    token a step, then DECODE_API_STEPS greedy steps, each token held to
    the plain forward's argmax within 0.1 std; ``memory_bytes`` of the
    bf16 tree and of its int8 quantization beside ``num_params``."""
    from dstack_tpu_torch.models.llama import (LlamaConfig, decode_step,
                                               init_kv_caches, init_params)
    from dstack_tpu_torch.serving.quant import memory_bytes, quantize_params

    cfg = cfg or LlamaConfig.llama3_1b()
    params = init_params(cfg, device,
                         torch.Generator(device=device).manual_seed(2))
    prompt = list(ENGINE_PROMPTS[0])
    cache = init_kv_caches(cfg, 1, 64, device=device)
    for t in prompt:
        logits, cache = decode_step(
            params, torch.tensor([t], device=device), cache, cfg)
    out = []
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DECODE_API_STEPS):
        token = torch.argmax(logits, dim=-1)
        out.append(token)
        logits, cache = decode_step(params, token, cache, cfg)
    if device == "cuda":
        torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / DECODE_API_STEPS
    tokens = [int(t) for t in torch.cat(out)]
    worst = greedy_gaps(torch, params, cfg, as_requests([prompt], [tokens]),
                        0.1, "decode_step 1b", DECODE_API_STEPS)
    res = {"num_params": cfg.num_params(), "step_s": step_s,
           "bf16_bytes": memory_bytes(params), "worst_gap_std": worst,
           "int8_bytes": memory_bytes(quantize_params(
               params, tied_head_copy=cfg.tie_embeddings))}
    log("mesh-rest decode_step: " + json.dumps(res))
    return res


def mesh_serving_rest_phase(torch, model: str = "llama3-8b",
                            device: str = "cuda") -> dict:
    """Phase 16: the rest of serving under a mesh, beside the one-card
    engine on the same Llama-3-8B weights (full size, seed 1, batch 8,
    max_len 1024, paged).  Two rank processes share card 0 under gloo as
    phase 13's pair does.

    (a) PD at tensor=2: the one-card engine's export of PD_PROMPT goes
    through the wire codec to the pair, which installs it (each rank its
    heads) and decodes PD_NEW_TOKENS, then exports the same prompt (each
    rank's heads gathered) through the wire to this process, where it is
    held to the one-card export (PD_EXPORT_RTOL; first_token the
    argmax of the pair's own logits, which greedy_gaps then holds to the
    plain forward with the decoded tokens) and
    installed into the one-card engine.  (b) MeshSpec(fsdp=2) with the
    weights over fsdp (FSDP_POLICY): bf16, then int8 weights; each rank
    holds half the matrices and gathers a layer at use.  (c) a one-card
    engine made under DSTACK_TPU_RAGGED_DECODE=0 (the full block-table
    span) beside the ragged one, each held to the plain forward and their
    agreement counted.  (d) decode_api_part.
    Every greedy token within 0.1 std of the plain forward (int8 weights:
    of the dequantized tree), K5 launches exactly layers x decode steps
    on every rank of every run, every follower in lockstep.  Returns each
    part's numbers and ``k5_launches``, the launches by kernels-line
    row.  A CPU rehearsal passes ``model="tiny", device="cpu"`` with
    ``fail`` patched to print (launch counts are the card's)."""
    import shutil
    import tempfile
    from collections import Counter

    from dstack_tpu_torch.models.llama import init_params
    from dstack_tpu_torch.ops import flash_attention as fa
    from dstack_tpu_torch.serving.engine import Request
    from dstack_tpu_torch.serving.quant import memory_bytes, quantize_params

    cuda = device == "cuda"
    cfg = mesh_cfg(model)
    params = init_params(cfg, device,
                         torch.Generator(device=device).manual_seed(1))
    row_8b = k5_row({"model": "llama3-8b", "mesh": {}})
    row_t2 = k5_row({"model": "llama3-8b", "mesh": {"tensor": 2}})
    k5, out = Counter(), {}
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-rest-"))
    try:
        one = mesh_engine(cfg, 1, None, params=params, device=device)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp = one.prefill_export(list(PD_PROMPT),
                                 max_new_tokens=PD_NEW_TOKENS)
        one_export_s = time.perf_counter() - t0
        (tmp / "one.json").write_text(pd_wire(torch, exp, "pd one-card"))
        int8_cfg = mesh_cfg(model, FSDP_INT8_LAYERS)
        cases = [{"name": "llama3-8b-t2-pd", "model": model,
                  "mesh": {"tensor": 2}, "seed": 1, "run": "pd",
                  "import": str(tmp / "one.json"),
                  "export": str(tmp / "pair.json")},
                 {"name": "llama3-8b-fsdp2", "model": model,
                  "mesh": {"fsdp": 2}, "seed": 1, "run": "light",
                  "policy": FSDP_POLICY},
                 {"name": "llama3-8b-fsdp2-int8", "model": model,
                  "layers": FSDP_INT8_LAYERS, "mesh": {"fsdp": 2},
                  "seed": 1, "run": "light", "policy": FSDP_POLICY,
                  "quantize": "int8"}]
        t0 = time.time()
        results, _ = mesh_world(torch, "gloo", 2, cases, device)
        out["world_s"] = time.time() - t0
        if any(r["backend"] != "gloo" for r in results):
            fail(f"mesh rest: gloo world backends {results}")

        # (a) PD at tensor=2, both ways
        pair = check_world("pd gloo t2", cfg, cases[0], results)
        k5[row_t2] += sum(pair["rank_launches"])
        pair["worst_gap_std"] = greedy_gaps(
            torch, params, cfg, as_requests([PD_PROMPT], pair["tokens"]),
            0.1, "pd install into the pair", PD_NEW_TOKENS)
        pair_exp = pd_prefill((tmp / "pair.json").read_text())
        errs = export_errors(torch, pair_exp, exp)
        pair_argmax = int(torch.argmax(pair_exp["logits"]))
        if (max(errs.values()) > PD_EXPORT_RTOL
                or pair_exp["first_token"] != pair_argmax
                or pair_exp["length"] != exp["length"]):
            fail(f"pd: the pair's export against the one-card one: {errs} "
                 f"(limit {PD_EXPORT_RTOL}), first token "
                 f"{pair_exp['first_token']} (its logits' argmax "
                 f"{pair_argmax}), length {pair_exp['length']} vs "
                 f"{exp['length']}")
        pair["export_rel_err"] = errs
        pair["first_token_agrees"] = (pair_exp["first_token"]
                                      == exp["first_token"])
        fa.paged_decode_attention.launches = 0
        steps0 = one.decode_steps
        installed = Request(tokens=list(PD_PROMPT),
                            max_new_tokens=PD_NEW_TOKENS, prefill=pair_exp)
        install_s = drive(torch, one, [installed])
        pd_one = {"launches": fa.paged_decode_attention.launches,
                  "decode_steps": one.decode_steps - steps0,
                  "install_and_decode_s": install_s,
                  "export_s": one_export_s}
        check_launches("pd install into one card", cfg, [pd_one])
        k5[row_8b] += pd_one["launches"]
        pd_one["worst_gap_std"] = greedy_gaps(
            torch, params, cfg, [installed], 0.1, "pd install into one card",
            PD_NEW_TOKENS)
        out["pd"] = {"pair": pair, "one_card": pd_one}
        log("mesh-rest pd: " + json.dumps(out["pd"]))

        # (b) the weights over fsdp, beside the one-card engine
        lone = light_run(torch, one, FSDP_NEW_TOKENS)
        lone["weight_gb"] = memory_bytes(params) / 1e9
        check_launches("fsdp one-card bf16", cfg, [lone])
        k5[row_8b] += lone["launches"]
        fsdp = check_world("fsdp gloo bf16", cfg, cases[1], results)
        k5[row_8b] += sum(fsdp["rank_launches"])
        fsdp["worst_gap_std"] = greedy_gaps(
            torch, params, cfg, as_requests(ENGINE_PROMPTS, fsdp["tokens"]),
            0.1, "fsdp bf16", FSDP_NEW_TOKENS)
        out["fsdp_bf16"] = {"one_card": lone, "fsdp2": fsdp}
        del one
        torch.cuda.empty_cache()
        ref = params if FSDP_INT8_LAYERS is None else init_params(
            int8_cfg, device, torch.Generator(device=device).manual_seed(1))
        engine = mesh_engine(int8_cfg, 1, None, params=ref, device=device,
                             quantize="int8")
        drive(torch, engine, [Request(tokens=list(range(40)),
                                      max_new_tokens=1)])  # warm, as `one`
        lone8 = light_run(torch, engine, FSDP_NEW_TOKENS)
        lone8["weight_gb"] = memory_bytes(engine.params) / 1e9
        del engine
        torch.cuda.empty_cache()
        check_launches("fsdp one-card int8", int8_cfg, [lone8])
        k5[row_8b] += lone8["launches"]
        fsdp8 = check_world("fsdp gloo int8", int8_cfg, cases[2], results)
        k5[row_8b] += sum(fsdp8["rank_launches"])
        deq = dequantized_dense(
            torch, quantize_params(ref), cfg.dtype,
            names=("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
        del ref
        fsdp8["worst_gap_std"] = greedy_gaps(
            torch, deq, int8_cfg, as_requests(ENGINE_PROMPTS,
                                              fsdp8["tokens"]),
            0.1, "fsdp int8", FSDP_NEW_TOKENS)
        del deq
        torch.cuda.empty_cache()
        out["fsdp_int8"] = {"one_card": lone8, "fsdp2": fsdp8}
        embed_gb = memory_bytes(params["embed"]) / 1e9
        for name in ("fsdp_bf16", "fsdp_int8"):
            # the embedding whole on each rank, half of everything else
            # (the norms and some int8 scales, replicated, within 2%)
            whole = out[name]["one_card"]["weight_gb"]
            half = embed_gb + (whole - embed_gb) / 2
            if max(out[name]["fsdp2"]["rank_weight_gb"]) > 1.02 * half:
                fail(f"{name}: ranks hold "
                     f"{out[name]['fsdp2']['rank_weight_gb']} GB of the "
                     f"{whole} GB of weights, not {half} GB")
            log(f"mesh-rest {name}: " + json.dumps(out[name]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (c) the full block-table span beside the ragged bucket
    runs = {}
    for name, ragged in (("ragged", "1"), ("full", "0")):
        before = os.environ.get("DSTACK_TPU_RAGGED_DECODE")
        os.environ["DSTACK_TPU_RAGGED_DECODE"] = ragged
        try:
            engine = mesh_engine(cfg, 1, None, params=params, device=device)
        finally:
            if before is None:
                os.environ.pop("DSTACK_TPU_RAGGED_DECODE")
            else:
                os.environ["DSTACK_TPU_RAGGED_DECODE"] = before
        run, reqs, _ = counted_run(torch, engine, cfg, False)
        check_launches(f"{name} span", cfg, [run])
        k5[row_8b] += run["launches"]
        runs[name] = {k: run[k] for k in ("ttft_s", "decode_step_s",
                                          "decode_tok_per_s", "launches",
                                          "decode_steps", "tokens")}
        runs[name]["worst_gap_std"] = greedy_gaps(
            torch, params, cfg, reqs, 0.1, f"{name} span", 12)
        del engine
        torch.cuda.empty_cache()
    # K5 splits the full span into other partial sums than the ragged
    # bucket (its split count follows the table's width), so the two
    # agree to rounding, and a near-tie may fall either way: each engine
    # is held to the plain forward, and the agreement is printed
    ragged, full = runs["ragged"]["tokens"], runs["full"]["tokens"]
    runs["same_tokens"] = sum(
        next((i for i, (a, b) in enumerate(zip(r, f)) if a != b), len(r))
        for r, f in zip(ragged, full))
    runs["tokens_checked"] = sum(len(r) for r in ragged)
    out["span"] = runs
    log("mesh-rest span: " + json.dumps(runs))
    del params
    torch.cuda.empty_cache()

    # (d) the plain-cache decode
    out["decode_api"] = decode_api_part(
        torch, None if cuda else mesh_cfg("tiny"), device)
    out["k5_launches"] = dict(k5)
    return out


# -- phase 14: context and pipeline parallelism -------------------------------


def cp_runs(small: bool = False, n: int = 2) -> list:
    """Phase 14's sharded runs on ``n`` ranks: Ulysses (Llama-3.2-1B at
    full width and depth and the Llama-3-8B layer geometry at
    CP_8B_LAYERS, b1 s8192, seq=n), ring (the 1B, seq=n) and the pipeline
    (the 1B, stage=n, CP_PIPE_MICRO microbatches, b8 s1024).  ``small``:
    the tiny config, s256 and b4 s128 (a CPU rehearsal)."""
    seq, pipe = (256, (4, 128)) if small else (CP_SEQ, (
        CP_PIPE_BATCH, CP_PIPE_SEQ))
    one = ("tiny", 4) if small else ("llama3-1b", None)
    eight = ("tiny", 4) if small else ("llama3-8b-fit", CP_8B_LAYERS)
    return [
        {"name": "ulysses-1b", "model": one, "batch": 1, "seq": seq,
         "steps": CP_STEPS, "mesh": {"seq": n},
         "policy": {"seq_axis": "seq", "seq_scheme": "ulysses"}},
        {"name": "ulysses-8b", "model": eight, "batch": 1, "seq": seq,
         "steps": CP_8B_STEPS, "mesh": {"seq": n},
         "policy": {"seq_axis": "seq", "seq_scheme": "ulysses"}},
        {"name": "ring-1b", "model": one, "batch": 1, "seq": seq,
         "steps": CP_STEPS, "mesh": {"seq": n},
         "policy": {"seq_axis": "seq", "seq_scheme": "ring"}},
        {"name": "pipeline-1b", "model": one, "batch": pipe[0],
         "seq": pipe[1], "steps": CP_STEPS, "mesh": {"stage": n},
         "policy": {"stage_axis": "stage",
                    "num_microbatches": CP_PIPE_MICRO}},
    ]


def cp_cfg(model):
    """(name, layers) -> the config: "llama3-1b", "llama3-8b-fit" (the 8B
    layer geometry) or "tiny", cut to ``layers`` when given."""
    from dstack_tpu_torch.models.llama import LlamaConfig

    name, layers = model
    cfg = {"llama3-1b": LlamaConfig.llama3_1b,
           "llama3-8b-fit": LlamaConfig.llama3_8b_fit,
           "tiny": LlamaConfig.tiny}[name]()
    return cfg if layers is None else dataclasses.replace(
        cfg, num_layers=layers)


def cp_want_launches(run: dict) -> tuple:
    """(fwd, bwd) flash launches a rank makes on ``run``'s steps, selective
    remat (the forward twice): Ulysses layers x steps; ring none; the
    pipeline (layers / stages) x (M + stages - 1) ticks x steps."""
    cfg = cp_cfg(run["model"])
    per_step = {"ulysses": cfg.num_layers, "ring": 0}.get(
        run["policy"].get("seq_scheme"))
    if per_step is None:
        stages = run["mesh"]["stage"]
        per_step = (cfg.num_layers // stages) * (
            run["policy"]["num_microbatches"] + stages - 1)
    return 2 * per_step * run["steps"], per_step * run["steps"]


def cp_train(torch, run: dict, device: str, mesh=None) -> dict:
    """``run``'s steps with selective remat from a seed-0 init and one
    batch of random tokens from the same generator: unsharded (``mesh``
    None, unstacked layers) or this rank's part on ``mesh`` (stacked
    under the pipeline, whose stage shards the layer dim).  Each rank of a
    mesh draws every matrix whole and keeps its blocks, so both see the
    same weights and tokens.  Returns the losses, grad norms, median step,
    tokens/s (of the global batch), peak memory, flash launches over the
    steps and, on a mesh, the collectives' share of one more step traced
    by torch.profiler (their host ranges over its wall)."""
    from torch.profiler import ProfilerActivity, profile

    from dstack_tpu_torch.models import train
    from dstack_tpu_torch.models.data import rank_tokens
    from dstack_tpu_torch.models.llama import ShardingPolicy
    from dstack_tpu_torch.ops import flash_attention as fa

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = cp_cfg(run["model"])
    if not cuda:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    policy = ShardingPolicy(**run["policy"]) if mesh is not None else None
    pipelined = "stage_axis" in run["policy"]
    opt = train.default_optimizer()
    gen = torch.Generator(device=device).manual_seed(0)
    state = train.create_state(
        gen, cfg, opt, mesh=mesh, policy=policy,
        unstacked=mesh is None or not pipelined, device=device)
    tokens = torch.randint(0, cfg.vocab_size, (run["batch"], run["seq"] + 1),
                           generator=gen, device=device, dtype=torch.int32)
    if mesh is not None:
        tokens = rank_tokens(tokens, mesh, policy).contiguous()
    step_fn = train.make_train_step(cfg, opt, mesh=mesh, policy=policy,
                                    remat="selective")
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.fwd_launches = fa.flash_attention.bwd_launches = 0
    losses, norms, stamps = [], [], [time.perf_counter()]
    for _ in range(run["steps"]):
        state, metrics = step_fn(state, {"tokens": tokens})
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        sync()
        stamps.append(time.perf_counter())
    step_s = median_step(stamps[1:]) if run["steps"] > 2 else \
        stamps[-1] - stamps[-2]
    out = {"losses": losses, "grad_norms": norms,
           "step_s": [b - a for a, b in zip(stamps, stamps[1:])],
           "step_median_s": step_s,
           "tokens_per_s": run["batch"] * run["seq"] / step_s,
           "fwd_launches": fa.flash_attention.fwd_launches,
           "bwd_launches": fa.flash_attention.bwd_launches,
           "max_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                             if cuda else None)}
    if mesh is not None:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            state, metrics = step_fn(state, {"tokens": tokens})
            metrics["loss"].item()
            sync()
            wall = time.perf_counter() - t0
        spans = {e.key: e.cpu_time_total / 1e6 for e in prof.key_averages()
                 if e.key.startswith("collective.")}
        out.update(traced_step_s=wall, collectives_s=spans,
                   collectives_share=sum(spans.values()) / wall)
    del state, step_fn
    if cuda:
        torch.cuda.empty_cache()
    return out


def cp_rank(torch, out_dir: str, spec_path: str) -> None:
    """One rank of phase 14 in its own process: the process group from the
    control plane's variables (the spec's backend: gloo, the ranks sharing
    card 0; or NCCL, a card a rank), then every run of the spec on its
    mesh.  Writes ``rank<r>.json`` with the backend and each run's
    results."""
    import torch.distributed as dist

    from dstack_tpu_torch.parallel import distributed
    from dstack_tpu_torch.parallel import mesh as mesh_lib

    spec = json.loads(Path(spec_path).read_text())
    device, backend = spec["device"], spec["backend"]
    distributed.initialize(force=True, device=device, backend=backend)
    try:
        out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
        for run in spec["runs"]:
            mesh = mesh_lib.build_mesh(
                mesh_lib.MeshSpec(**run["mesh"]), device,
                backend="gloo" if backend == "gloo" else None)
            out[run["name"]] = cp_train(torch, run, device, mesh=mesh)
        (Path(out_dir) / f"rank{dist.get_rank()}.json").write_text(
            json.dumps(out))
    finally:
        dist.destroy_process_group()


def rank_world(flag: str, spec: dict, label: str, timeout_s: float,
               backend: str, ranks: int) -> list:
    """``ranks`` rank processes (``chip_smoke.py FLAG DIR SPEC``) given
    ``spec``: under gloo each a one-card "node" of the control plane's
    variables, all on card 0 (NCCL refuses two ranks on one device);
    under NCCL one node of ``ranks`` cards, a card a rank.  Fails unless
    every rank exits 0 within ``timeout_s``; returns each rank's
    ``rank<r>.json``."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-ranks-"))
    spec_path = tmp / "spec.json"
    spec_path.write_text(json.dumps(spec))
    port = free_port()
    nodes = 1 if backend == "nccl" else ranks
    procs = []
    try:
        for r in range(ranks):
            env = dict(os.environ, DSTACK_MASTER_NODE_IP="127.0.0.1",
                       DSTACK_NODES_NUM=str(nodes),
                       DSTACK_NODE_RANK="0" if nodes == 1 else str(r),
                       DSTACK_GPUS_PER_NODE=str(ranks // nodes),
                       LOCAL_RANK=str(r) if nodes == 1 else "0",
                       DSTACK_COORDINATOR_PORT=str(port))
            env.pop("DSTACK_GPUS_NUM", None)
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), flag,
                 str(tmp), str(spec_path)], env=env))
        deadline = time.time() + timeout_s
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
        codes = [p.returncode for p in procs]
        if any(codes):
            fail(f"{label}: ranks exited {codes}")
        return [json.loads((tmp / f"rank{r}.json").read_text())
                for r in range(ranks)]
    except subprocess.TimeoutExpired:
        fail(f"{label}: ranks still running after {timeout_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def cp_world(runs: list, device: str = "cuda", backend: str = "gloo",
             ranks: int = 2) -> list:
    """Phase 14's ranks in fresh processes (``chip_smoke.py --cp-rank``,
    see :func:`rank_world`); returns each rank's results."""
    return rank_world("--cp-rank", {"device": device, "backend": backend,
                                    "runs": runs},
                      "context and pipeline", CP_TIMEOUT_S, backend, ranks)


def cp_check(label: str, run: dict, ranks: list, ref: dict,
             cuda: bool = True) -> dict:
    """Hold a sharded run's ranks to the unsharded run: every rank's losses
    within CP_RTOL["loss"] and grad norms within CP_RTOL["grad_norm"],
    and (on the card) its flash launches exactly cp_want_launches."""
    got = [r[run["name"]] for r in ranks]
    out = {"unsharded": {k: ref[k] for k in (
        "losses", "grad_norms", "step_median_s", "tokens_per_s",
        "max_memory_gb")},
           "sharded": {k: got[0][k] for k in (
               "losses", "grad_norms", "step_median_s", "tokens_per_s",
               "collectives_share", "collectives_s", "traced_step_s")},
           "rank_max_memory_gb": [g["max_memory_gb"] for g in got],
           "rank_launches": [[g["fwd_launches"], g["bwd_launches"]]
                             for g in got]}
    for key, plural in (("loss", "losses"), ("grad_norm", "grad_norms")):
        out[f"{key}_rel_err"] = [
            check_rel(f"{label} rank {i} {key}", g[plural], ref[plural],
                      CP_RTOL[run["name"].split("-")[0]][key])
            for i, g in enumerate(got)]
    want = cp_want_launches(run)
    if cuda and any(tuple(l) != want for l in out["rank_launches"]):
        fail(f"{label}: flash launches (fwd, bwd) per rank "
             f"{out['rank_launches']}, expected {want} on each")
    return out


def context_pipeline_phase(torch, small: bool = False, device: str = "cuda",
                           backend: str = "gloo", ranks: int = 2) -> dict:
    """Phase 14: the unsharded runs in this process (Llama-3.2-1B and the
    8B geometry at b1 s8192, the 1B at b8 s1024; one run serves both
    schemes at s8192), then cp_runs on ``ranks`` ranks (the script's own
    run: two gloo ranks sharing the card; ``backend="nccl"`` a card a
    rank); every sharded run held to its unsharded one (cp_check).
    ``small`` and ``device="cpu"`` rehearse it at the tiny config."""
    runs = cp_runs(small, ranks)
    refs = {}
    for run in runs:
        key = json.dumps([run["model"], run["batch"], run["seq"],
                          run["steps"]])
        if key not in refs:
            refs[key] = cp_train(torch, run, device)
            log(f"context unsharded {run['name']}: "
                + json.dumps(refs[key]))
    results = cp_world(runs, device, backend, ranks)
    if any(r["backend"] != backend or r["world"] != ranks for r in results):
        fail(f"context and pipeline: backends "
             f"{[(r['backend'], r['world']) for r in results]}, want "
             f"{backend} x {ranks}")
    out = {}
    for run in runs:
        key = json.dumps([run["model"], run["batch"], run["seq"],
                          run["steps"]])
        label = f"context {run['name']} {run['mesh']}"
        out[run["name"]] = cp_check(label, run, results, refs[key],
                                    cuda=device == "cuda")
        log(f"{label}: " + json.dumps(out[run["name"]]))
    return out


# -- phase 15: replica cold start -------------------------------------------

#: phase 15: Llama-3.2-1B (full width and depth, bf16, paged) served by a
#: seeder A (weights from ELASTIC_SEED), a standby joiner B and a cold
#: replica C, each started as a user starts a replica; then two trainer
#: processes at ELASTIC_TRAIN_LAYERS layers (b1 s1024, no remat) through
#: one compile cache root
ELASTIC_SEED = 5
ELASTIC_DECODE_TOKENS = 32
ELASTIC_TRAIN_LAYERS = 2
ELASTIC_TRAIN_SEQ = 1024
#: a replica's start (weights pulled and read, nvcc or a fetch, one
#: warmup request) and a trainer's step, each at most
ELASTIC_TIMEOUT_S = 600
#: a trainer process's loss against the same step in this process
ELASTIC_LOSS_RTOL = 1e-3
#: the libraries a paged bf16 replica and a train step resolve through the
#: compile cache
SERVE_LIBRARIES = ("rownorm", "paged_decode")
TRAIN_LIBRARIES = ("flash_fwd", "flash_bwd", "rownorm", "adamw")


def port_copy(dest: Path) -> Path:
    """A copy of the checkout's package and this script (with the
    benchmark's package, whose frozen bounds it imports), without build/:
    a process started from it finds no kernel library and fills its own
    build/ (``_build.BUILD_DIR`` follows the package's files)."""
    import shutil

    for package in ("dstack_tpu_torch", "portbench"):
        shutil.copytree(ROOT / package, dest / package,
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", dest / "chip_smoke.py")
    return dest


class Replica:
    """A phase-15 server: ``python -m dstack_tpu_torch.serving.server``
    serving Llama-3.2-1B paged from ``root`` (a checkout or a
    :func:`port_copy`), its output in ``work/<name>.log``."""

    def __init__(self, root: Path, name: str, args: list, work: Path,
                 config: str = "llama3-1b", device: str = "cuda"):
        self.name, self.log_path = name, work / f"{name}.log"
        port = free_port()
        self.base = f"http://127.0.0.1:{port}"
        cmd = [sys.executable, "-m", "dstack_tpu_torch.serving.server",
               "--config", config, "--device", device, "--paged",
               "--batch-size", "8", "--max-len", "1024", "--port", str(port),
               *args]
        log(f"elastic: replica {name}: " + " ".join(cmd[1:]))
        env = dict(os.environ, PYTHONPATH=str(root))
        self.t0 = time.time()
        with open(self.log_path, "w") as out:
            self.proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=out,
                                         stderr=subprocess.STDOUT)

    def wait_ready(self) -> float:
        """Seconds from the process's start until it answers and is no
        longer warming (a standby is then ready to activate)."""
        while True:
            if self.proc.poll() is not None:
                fail(f"elastic: replica {self.name} exited with "
                     f"{self.proc.returncode}:\n{self.tail()}")
            try:
                status, body, _ = http(self.base + "/elastic/standby",
                                       timeout=5)
                if status == 200 and not json.loads(body)["warming"]:
                    return time.time() - self.t0
            except OSError:
                pass
            if time.time() - self.t0 > ELASTIC_TIMEOUT_S:
                fail(f"elastic: replica {self.name} not ready within "
                     f"{ELASTIC_TIMEOUT_S} s:\n{self.tail()}")
            time.sleep(0.05)

    def stats(self) -> dict:
        return json.loads(http(self.base + "/stats")[1])

    def tail(self) -> str:
        return self.log_path.read_text()[-4000:]

    def close(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)


def greedy_tokens(base: str, label: str) -> list:
    status, body, _ = http(base + "/v1/completions", {
        "prompt": PROMPT.format(i=0), "max_tokens": ELASTIC_DECODE_TOKENS,
        "return_token_ids": True})
    if status != 200:
        fail(f"elastic: {label} completion answered {status}: {body[:200]}")
    return json.loads(body)["choices"][0]["token_ids"]


def check_k5_launches(label: str, stats: dict) -> int:
    """The replica's paged-decode launches: exactly layers x decode
    steps, and some."""
    launches = stats["kernels"]["paged_decode_attention"]["launches"]
    want = stats["num_layers"] * stats["decode_steps"]
    if launches != want or launches <= 0:
        fail(f"elastic: {label} launched the paged-decode kernel {launches} "
             f"times, expected {stats['num_layers']} layers x "
             f"{stats['decode_steps']} decode steps")
    return launches


def check_counters(label: str, stats: dict, at_least=(), **want) -> dict:
    """The replica's compile-cache counters: each of ``want`` equal, each
    of ``at_least`` at least 1."""
    cache = stats["compile_cache"]
    for name, value in [*want.items(), *((n, None) for n in at_least)]:
        got = cache[f"compile_cache_{name}"]
        if got < 1 if value is None else got != value:
            fail(f"elastic: {label} compile_cache_{name} {got}, expected "
                 f"{'>= 1' if value is None else value}: {cache} "
                 f"{stats.get('compile_cache_resolved')}")
    return cache


def elastic_train_step(torch, compile_cache=None,
                       device: str = "cuda") -> dict:
    """One step of the 1B trainer at ELASTIC_TRAIN_LAYERS layers (b1 s1024,
    seed ELASTIC_SEED) through ``make_train_step(compile_cache=)``; on the
    CPU (a rehearsal) the tiny config at s64."""
    from dstack_tpu_torch.models import train
    from dstack_tpu_torch.models.llama import LlamaConfig
    from dstack_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(
        LlamaConfig.llama3_1b() if device == "cuda" else LlamaConfig.tiny(),
        num_layers=ELASTIC_TRAIN_LAYERS)
    seq = ELASTIC_TRAIN_SEQ if device == "cuda" else 64
    gen = torch.Generator(device=device).manual_seed(ELASTIC_SEED)
    opt = train.default_optimizer()
    state = train.create_state(gen, cfg, opt, device=device)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq + 1), generator=gen,
                           device=device, dtype=torch.int32)
    step_fn = train.make_train_step(cfg, opt, remat=False,
                                    compile_cache=compile_cache)
    fa.flash_attention.fwd_launches = fa.flash_attention.bwd_launches = 0
    t = time.time()
    _, metrics = step_fn(state, {"tokens": tokens})
    loss = metrics["loss"].item()
    if device == "cuda":
        torch.cuda.synchronize()
    return {"loss": loss, "first_step_s": time.time() - t,
            "fwd_launches": fa.flash_attention.fwd_launches,
            "bwd_launches": fa.flash_attention.bwd_launches,
            "source": getattr(step_fn, "source", None)}


def elastic_train_rank(torch, out_path: str, cache_root: str,
                       device: str = "cuda") -> None:
    """A phase-15 trainer process (``chip_smoke.py --elastic-train OUT
    ROOT [DEVICE]``): one step through a CompileCache over
    ``cache_root``; writes the step's numbers and the cache's counters to
    ``out_path``."""
    from dstack_tpu_torch.elastic import CompileCache
    from dstack_tpu_torch.ops import _build

    cache = CompileCache(cache_root)
    built = sorted(p.name for p in _build.BUILD_DIR.glob("*.so"))
    out = elastic_train_step(torch, cache, device)
    out.update(cache.snapshot(), resolved=cache.resolved,
               build_dir=str(_build.BUILD_DIR), built_before=built)
    Path(out_path).write_text(json.dumps(out))


def elastic_trainer(root: Path, out: Path, cache_root: Path,
                    device: str) -> dict:
    cmd = [sys.executable, str(root / "chip_smoke.py"), "--elastic-train",
           str(out), str(cache_root), device]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t = time.time()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=ELASTIC_TIMEOUT_S)
    if proc.returncode != 0:
        fail(f"elastic: trainer from {root} exited {proc.returncode}:\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return {**json.loads(out.read_text()), "process_s": time.time() - t}


def elastic_phase(torch, config: str = "llama3-1b",
                  device: str = "cuda") -> dict:
    """Phase 15: a replica's cold start through dstack_tpu_torch/elastic/,
    each replica a server process as a user starts one.

    (a) Seeder A serves Llama-3.2-1B from seed ELASTIC_SEED with that
    seed's weights published as a snapshot (--snapshot-dir) and a compile
    cache root: it warms, and its paged-decode library (in the checkout's
    build/) goes into the root.  The weight pull's GB/s is timed in this
    process.  (b) Joiner B runs from a copy of the package with an empty
    build/, another seed, --weight-peers A, --compile-cache-peers A and
    --standby: it must be warming on /load and refuse /v1 until
    activated, run no nvcc (misses 0, a peer hit), serve A's greedy
    tokens, and launch K5 layers x decode steps.  (c) Cold replica C: the
    same, but no compile-cache peer and an empty root: one nvcc run a
    library (``SERVE_LIBRARIES``).  (d) Two trainer processes through one
    cache root: T1 from the checkout (its build/ has the train step's
    libraries, ``TRAIN_LIBRARIES``: a hit and a put each), T2 from a copy
    with an empty build/ (misses 0, a hit each); each one step's
    loss within ELASTIC_LOSS_RTOL of the same step in this process.
    Every server is stopped before this returns.  ``config="tiny",
    device="cpu"`` rehearses the flow on the CPU (with ``fail`` patched:
    a CPU replica resolves no library, so the counters' checks fail
    there by design)."""
    import shutil
    import tempfile

    from dstack_tpu_torch.elastic import pull_weights
    from dstack_tpu_torch.models import checkpoint, llama
    from dstack_tpu_torch.models.llama import LlamaConfig

    cfg = {"llama3-1b": LlamaConfig.llama3_1b, "tiny": LlamaConfig.tiny}[
        config]()
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-elastic-"))
    replicas = []
    out = {}
    try:
        gen = torch.Generator(device=device).manual_seed(ELASTIC_SEED)
        params = llama.init_params(cfg, device, gen)
        t = time.time()
        snap = checkpoint.snapshot_train_state(params)
        del params
        checkpoint.write_snapshot(work / "sa", snap, 0)
        out["snapshot_bytes"] = checkpoint.snapshot_nbytes(snap)
        out["snapshot_write_s"] = time.time() - t
        del snap

        a = Replica(ROOT, "a", [
            "--seed", str(ELASTIC_SEED), "--snapshot-dir", str(work / "sa"),
            "--compile-cache", str(work / "ca")], work, config, device)
        replicas.append(a)
        out["a_ready_s"] = a.wait_ready()
        a_stats = a.stats()
        served = len(SERVE_LIBRARIES)
        check_counters("seeder A", a_stats, hits=served, puts=served,
                       misses=0)
        want = greedy_tokens(a.base, "seeder A")

        t = time.time()
        pulled = pull_weights([a.base], work / "pulled")
        pull_s = time.time() - t
        if pulled["source"] != "peer":
            fail(f"elastic: the timed pull did not come from A: {pulled}")
        pull_bytes = sum(p.stat().st_size for p in
                         (work / "pulled").glob("step_*/host_*.npz"))
        out.update(pull_bytes=pull_bytes, pull_s=pull_s,
                   pull_gb_per_s=pull_bytes / pull_s / 1e9)
        shutil.rmtree(work / "pulled")

        for name, extra in (
                ("b", ["--compile-cache-peers", a.base]), ("c", [])):
            seed = ELASTIC_SEED + (1 if name == "b" else 2)
            r = Replica(port_copy(work / f"{name}-root"), name, [
                "--seed", str(seed), "--snapshot-dir", str(work / f"s{name}"),
                "--weight-peers", a.base,
                "--compile-cache", str(work / f"c{name}"), "--standby",
                *extra], work, config, device)
            replicas.append(r)
            ready = r.wait_ready()
            status, body, _ = http(r.base + "/load")
            if status != 200 or json.loads(body)["warming"] != 1:
                fail(f"elastic: standby {name} /load: {status} {body[:200]}")
            status = http(r.base + "/v1/completions",
                          {"prompt": "x", "max_tokens": 1})[0]
            if status != 503:
                fail(f"elastic: standby {name} answered {status} to /v1 "
                     "before activation")
            status, body, _ = http(r.base + "/elastic/standby/activate", {})
            if status != 200 or not json.loads(body)["activated"]:
                fail(f"elastic: activating {name}: {status} {body[:200]}")
            t = time.time()
            status = http(r.base + "/v1/completions",
                          {"prompt": PROMPT.format(i=1), "max_tokens": 1})[0]
            ttft = time.time() - t
            if status != 200:
                fail(f"elastic: {name}'s first request answered {status}")
            got = greedy_tokens(r.base, name)
            if got != want:
                fail(f"elastic: {name}'s greedy tokens {got} are not A's "
                     f"{want}")
            stats = r.stats()
            pull = stats.get("weight_pull") or {}
            if pull.get("source") != "peer" or pull.get("peer") != a.base:
                fail(f"elastic: {name}'s weights did not come from A: {pull}")
            if name == "b":
                cache = check_counters("joiner B", stats, misses=0,
                                       at_least=("peer_hits",))
            else:
                cache = check_counters("cold C", stats, misses=served)
            out[name] = {"ready_s": ready, "ttft_s": ttft,
                         "compile_cache": cache,
                         "resolved": stats["compile_cache_resolved"],
                         "launches": check_k5_launches(name, stats),
                         "decode_steps": stats["decode_steps"]}
            r.close()
        out["a_launches"] = check_k5_launches("seeder A", a.stats())
        out["nvcc_leg_s"] = out["c"]["ready_s"] - out["b"]["ready_s"]
        out["launches"] = (out["a_launches"] + out["b"]["launches"]
                           + out["c"]["launches"])

        ref = elastic_train_step(torch, device=device)
        trainers = {
            "t1": elastic_trainer(ROOT, work / "t1.json", work / "ct",
                                  device),
            "t2": elastic_trainer(port_copy(work / "t2-root"),
                                  work / "t2.json", work / "ct", device)}
        trained = len(TRAIN_LIBRARIES)
        want_counts = {"t1": {"hits": trained, "puts": trained, "misses": 0},
                       "t2": {"hits": trained, "misses": 0}}
        for name, run in trainers.items():
            for key, value in want_counts[name].items():
                if run[f"compile_cache_{key}"] != value:
                    fail(f"elastic: trainer {name} compile_cache_{key} "
                         f"{run[f'compile_cache_{key}']}, expected {value}: "
                         f"{run}")
            layers = ELASTIC_TRAIN_LAYERS
            if (run["fwd_launches"], run["bwd_launches"]) != (layers, layers):
                fail(f"elastic: trainer {name} flash launches "
                     f"{run['fwd_launches']}/{run['bwd_launches']}, expected "
                     f"{layers} each")
            rel = abs(run["loss"] - ref["loss"]) / abs(ref["loss"])
            run["loss_rel_err"] = rel
            if not (math.isfinite(run["loss"]) and rel <= ELASTIC_LOSS_RTOL):
                fail(f"elastic: trainer {name} loss {run['loss']} vs "
                     f"{ref['loss']} in process (rel {rel:.2e})")
        if trainers["t2"]["built_before"]:
            fail(f"elastic: T2's build/ was not empty: {trainers['t2']}")
        out["train_ref"] = ref
        out["trainers"] = trainers
        out["fwd_launches"] = sum(r["fwd_launches"] for r in trainers.values())
        out["bwd_launches"] = sum(r["bwd_launches"] for r in trainers.values())
    except BaseException:
        for r in replicas:
            log(f"elastic: replica {r.name} log (tail):\n{r.tail()}")
        raise
    finally:
        for r in replicas:
            r.close()
        shutil.rmtree(work, ignore_errors=True)
    log("elastic: " + json.dumps(out))
    return out


# -- phase 17: MoE with the tokens over expert, and MoE under seq and stage --

#: phase 17: Mixtral width at MOE_TRAIN_LAYERS layers (b4 s2048, remat,
#: bf16), SHARDED_STEPS steps on two ranks sharing card 0 under gloo, each
#: run beside the same seed's unsharded steps in this process; the seconds
#: the ranks get in all
MOE_DISPATCH_TIMEOUT_S = 600


def moe_dispatch_runs(n: int = 2) -> list:
    """Phase 17's sharded runs on ``n`` ranks: (a) "expert-batch", the
    tokens striped over ``expert`` too (MeshSpec(expert=2); data=n/2 x
    expert=2 on more ranks), each rank its rows and its experts, the
    stripes' dispatch exchanged over ``expert``; (b) "seq", MeshSpec(seq=n)
    with seq_axis="seq", and (c) "stage", MeshSpec(stage=n) with
    stage_axis="stage": replicas, each rank the whole step."""
    expert = {"expert": 2} if n == 2 else {"data": n // 2, "expert": 2}
    return [
        {"name": "expert-batch", "mesh": expert,
         "policy": {"batch_axes": ["dcn", "data", "fsdp", "expert"]}},
        {"name": "seq", "mesh": {"seq": n}, "policy": {"seq_axis": "seq"}},
        {"name": "stage", "mesh": {"stage": n},
         "policy": {"stage_axis": "stage"}},
    ]


def moe_dispatch_model(torch, small: bool, device: str) -> tuple:
    """(config, batch, seq) of phase 17: Mixtral-8x7B's width at
    MOE_TRAIN_LAYERS layers, b4 s2048; ``small``: tiny_moe, b4 s128
    (f32 off the card)."""
    from dstack_tpu_torch.models import moe

    if small:
        cfg, batch, seq = moe.MoEConfig.tiny_moe(), 4, 128
    else:
        cfg = dataclasses.replace(moe.MoEConfig.mixtral_8x7b(),
                                  num_layers=MOE_TRAIN_LAYERS)
        batch, seq = MOE_TRAIN_BATCH, MOE_TRAIN_SEQ
    if device != "cuda":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    return cfg, batch, seq


def moe_start(torch, cfg, batch: int, seq: int, device: str, mesh=None,
              policy=None) -> tuple:
    """(state, tokens, step): seed 0's unstacked state (on ``mesh``, this
    rank's blocks of it) and the global batch drawn after it from the same
    generator, as every rank draws them; the step with remat."""
    from dstack_tpu_torch.models import moe, train

    opt = train.default_optimizer()
    gen = torch.Generator(device=device).manual_seed(0)
    state = moe.create_state(gen, cfg, opt, mesh=mesh, policy=policy,
                             unstacked=True, device=device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=gen, device=device, dtype=torch.int32)
    return state, tokens, moe.make_train_step(cfg, opt, mesh=mesh,
                                              policy=policy)


def moe_step(torch, step_fn, state, tokens, out: dict):
    """One step of ``step_fn``, its loss, aux loss and grad norm appended
    to ``out``'s lists; returns when the card has finished the step."""
    state, metrics = step_fn(state, {"tokens": tokens})
    for key, name in (("losses", "loss"), ("aux_losses", "aux_loss"),
                      ("grad_norms", "grad_norm")):
        out[key].append(metrics[name].item())
    if tokens.is_cuda:
        torch.cuda.synchronize()
    return state


def tree_paths(tree, path: str = "params") -> list:
    """The key paths of a tree's leaves, in :func:`llama.tree_leaves`
    order."""
    if isinstance(tree, dict):
        return [q for k in tree for q in tree_paths(tree[k], f"{path}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [q for i, t in enumerate(tree)
                for q in tree_paths(t, f"{path}[{i}]")]
    return [path]


def leaf_specs(params, cfg) -> list:
    """Each leaf's spec under moe.param_specs, in tree_leaves order."""
    from dstack_tpu_torch.models import llama, moe

    out = []
    llama.map_with_specs(lambda sp, _: out.append(sp), moe.specs_for(
        params, cfg, llama.ShardingPolicy(), "expert"), params)
    return out


def rank_block(spec, shape, mesh_sizes: dict, rank: int) -> tuple:
    """The slices of a ``shape`` leaf that rank ``rank`` of a row-major
    mesh of ``mesh_sizes`` holds under ``spec``."""
    from dstack_tpu_torch.parallel import mesh as mesh_lib

    sizes = mesh_lib.MeshSpec(**mesh_sizes).sizes
    coord, rest = {}, rank
    for axis in reversed(mesh_lib.AXIS_ORDER):
        rest, coord[axis] = divmod(rest, sizes[axis])
    return tuple(slice(a, b) for a, b in
                 mesh_lib.shard_index(spec, shape, sizes, coord))


def diff_norm(torch, a, b) -> float:
    """L2 norm of a - b in f32, in slices of the leading dim of at most
    2^27 elements (an expert stack's f32 copies whole would take GBs)."""
    if a.dim() == 0:
        a, b = a[None], b[None]
    rows = max(1, (1 << 27) // max(1, a[0].numel()))
    return math.sqrt(sum(
        float(torch.linalg.vector_norm(x.float() - y.float()).square())
        for x, y in zip(a.split(rows), b.split(rows))))


def moe_dispatch_reference(torch, small: bool, device: str, runs: list,
                           ranks: int, after_dir: Path) -> dict:
    """The unsharded run in this process: SHARDED_STEPS steps from seed 0.
    After step 1, writes each leaf's parameter and AdamW first moment to
    ``after_dir`` (one file a leaf, in tree_leaves order) and keeps, for
    every run and rank, the norm of that rank's block of each leaf's
    update (the parameter's change, the first moment), which the ranks'
    differences are held to."""
    from dstack_tpu_torch.models import llama

    cuda = device == "cuda"
    cfg, batch, seq = moe_dispatch_model(torch, small, device)
    state, tokens, step_fn = moe_start(torch, cfg, batch, seq, device)
    leaves = llama.tree_leaves(state.params)
    before = [p.detach().clone() for p in leaves]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = {"losses": [], "aux_losses": [], "grad_norms": []}
    state = moe_step(torch, step_fn, state, tokens, out)
    specs = leaf_specs(state.params, cfg)
    base = {run["name"]: [[] for _ in range(ranks)] for run in runs}
    with torch.no_grad():
        for i, (p, p0, spec) in enumerate(zip(leaves, before, specs)):
            m = state.opt_state.state[p]["exp_avg"]
            norms = {}  # by block: most ranks of most runs hold the whole
            for run in runs:
                for r in range(ranks):
                    sl = rank_block(spec, p.shape, run["mesh"], r)
                    key = tuple((x.start, x.stop) for x in sl)
                    if key not in norms:
                        norms[key] = (diff_norm(torch, p[sl], p0[sl]),
                                      diff_norm(torch, m[sl],
                                                torch.zeros_like(m[sl])))
                    base[run["name"]][r].append(norms[key])
            torch.save({"param": p.detach().cpu(), "exp_avg": m.cpu()},
                       after_dir / f"{i}.pt")
    del before
    stamps = [time.perf_counter()]
    for _ in range(SHARDED_STEPS - 1):
        state = moe_step(torch, step_fn, state, tokens, out)
        stamps.append(time.perf_counter())
    step_s = median_step(stamps)
    out.update(paths=tree_paths(state.params), base=base,
               step_median_s=step_s, tokens_per_s=batch * seq / step_s,
               max_memory_gb=(torch.cuda.max_memory_allocated() / 1e9
                              if cuda else None))
    del state, step_fn, leaves
    if cuda:
        torch.cuda.empty_cache()
    return out


def moe_dispatch_train(torch, run: dict, spec: dict, mesh) -> dict:
    """One rank's run of phase 17: SHARDED_STEPS steps of its part on
    ``mesh`` (its rows of the global batch, whole sequences, under
    moe.token_policy), step 1 from the seed's state held leaf by leaf
    against the unsharded state after it (``spec["after_dir"]``): each
    leaf's parameter and first moment minus this rank's block of the
    unsharded one.  Returns the losses, grad norms, median step, tokens/s
    of the global batch, the flash launches over the steps, peak memory,
    the experts a rank holds in each expert leaf, and the collectives'
    share of one more step traced by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from dstack_tpu_torch.models import llama, moe
    from dstack_tpu_torch.models.data import rank_tokens
    from dstack_tpu_torch.ops import flash_attention as fa
    from dstack_tpu_torch.parallel import mesh as mesh_lib

    device = spec["device"]
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg, batch, seq = moe_dispatch_model(torch, spec["small"], device)
    policy = llama.ShardingPolicy(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in run["policy"].items()})
    state, tokens, step_fn = moe_start(torch, cfg, batch, seq, device,
                                       mesh, policy)
    tokens = rank_tokens(tokens, mesh, moe.token_policy(policy)).contiguous()
    experts = {k: mesh_lib.local_tensor(state.params["layers"][0][k]).shape[0]
               for k in ("w_gate", "w_up", "w_down")}
    out = {"losses": [], "aux_losses": [], "grad_norms": [],
           "rows": tokens.shape[0], "experts": experts}
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.fwd_launches = fa.flash_attention.bwd_launches = 0
    state = moe_step(torch, step_fn, state, tokens, out)
    diffs = []
    after_dir = Path(spec["after_dir"])
    with torch.no_grad():
        leaves = llama.tree_leaves(state.params)
        for i, (p, sp) in enumerate(zip(leaves, leaf_specs(state.params,
                                                           cfg))):
            mine = mesh_lib.local_tensor(p)
            whole = torch.load(after_dir / f"{i}.pt", mmap=True,
                               weights_only=True)
            sl = tuple(slice(a, b) for a, b in mesh_lib.shard_index(
                sp, whole["param"].shape, mesh_lib.mesh_sizes(mesh),
                mesh_lib.mesh_coordinate(mesh)))
            diffs.append(tuple(
                diff_norm(torch, whole[key][sl].to(device), ours)
                for key, ours in (("param", mine), ("exp_avg",
                                  state.opt_state.state[mine]["exp_avg"]))))
    out["diffs"] = diffs
    stamps = [time.perf_counter()]
    for _ in range(SHARDED_STEPS - 1):
        state = moe_step(torch, step_fn, state, tokens, out)
        stamps.append(time.perf_counter())
    out["fwd_launches"] = fa.flash_attention.fwd_launches
    out["bwd_launches"] = fa.flash_attention.bwd_launches
    step_s = median_step(stamps)
    out.update(step_median_s=step_s, tokens_per_s=batch * seq / step_s,
               max_memory_gb=(torch.cuda.max_memory_allocated() / 1e9
                              if cuda else None))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, {"tokens": tokens})
        metrics["loss"].item()
        sync()
        wall = time.perf_counter() - t0
    spans = {e.key: e.cpu_time_total / 1e6 for e in prof.key_averages()
             if e.key.startswith("collective.")}
    out.update(traced_step_s=wall, collectives_s=spans,
               collectives_share=sum(spans.values()) / wall)
    del state, step_fn
    if cuda:
        torch.cuda.empty_cache()
    return out


def moe_dispatch_rank(torch, out_dir: str, spec_path: str) -> None:
    """One rank of phase 17 in its own process: the process group from the
    control plane's variables (the spec's backend), then every run of the
    spec on its mesh, one after the other.  Writes ``rank<r>.json``."""
    import torch.distributed as dist

    from dstack_tpu_torch.parallel import distributed
    from dstack_tpu_torch.parallel import mesh as mesh_lib

    spec = json.loads(Path(spec_path).read_text())
    device, backend = spec["device"], spec["backend"]
    distributed.initialize(force=True, device=device, backend=backend)
    try:
        out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
        for run in spec["runs"]:
            mesh = mesh_lib.build_mesh(
                mesh_lib.MeshSpec(**run["mesh"]), device,
                backend="gloo" if backend == "gloo" else None)
            out[run["name"]] = moe_dispatch_train(torch, run, spec, mesh)
        (Path(out_dir) / f"rank{dist.get_rank()}.json").write_text(
            json.dumps(out))
    finally:
        dist.destroy_process_group()


def exchange_bytes(cfg, batch: int, seq: int, n: int) -> dict:
    """The token exchange of run (a), by arithmetic: the [E, C, D]
    dispatch (C from the global batch's tokens) in the model dtype, what
    a rank sends of it in one exchange over ``n`` expert ranks (a
    reduce-scatter or an all-gather: (n - 1) / n of it), and in one layer
    of a step under remat (in and out, forward, recompute and backward:
    six exchanges)."""
    capacity = max(int(math.ceil(batch * seq * cfg.experts_per_token
                                 / cfg.num_experts * cfg.capacity_factor)),
                   1)
    size = cfg.num_experts * capacity * cfg.hidden_size * cfg.dtype.itemsize
    per = size * (n - 1) // n
    return {"capacity": capacity, "dispatch_bytes": size,
            "exchange_bytes_per_rank": per, "layer_step_bytes_per_rank":
            6 * per}


def moe_dispatch_phase(torch, small: bool = False, device: str = "cuda",
                       backend: str = "gloo", ranks: int = 2) -> dict:
    """Phase 17: the unsharded run in this process (its state after step
    1 written leaf by leaf to a temporary directory, its card memory freed
    before the ranks start), then moe_dispatch_runs on ``ranks`` ranks,
    one run after another (the script's own: two gloo ranks sharing the
    card; ``backend="nccl"`` a card a rank).  Fails unless every rank's
    step 1 loss is within TRAIN_PLAIN_RTOL["loss"] and grad norm within
    TRAIN_PLAIN_RTOL["grad_norm"] of the unsharded step's, each leaf's
    parameter and first moment after step 1 within MOE_UPDATE_RTOL_MESH
    of the norm of the rank's block of the unsharded update, run (a)'s
    expert leaves hold E / 2 experts on each rank, the backends are the
    one asked for, and (on the card) each rank's flash launches are
    exactly (2 L S, L S).  Steps 2 and on run free and are printed beside
    the unsharded run's.  ``small`` and ``device="cpu"`` rehearse it at
    tiny_moe."""
    import shutil
    import tempfile

    runs = moe_dispatch_runs(ranks)
    cuda = device == "cuda"
    after_dir = Path(tempfile.mkdtemp(prefix="chip-smoke-moe-"))
    try:
        t0 = time.time()
        ref = moe_dispatch_reference(torch, small, device, runs, ranks,
                                     after_dir)
        t1 = time.time()
        results = rank_world("--moe-dispatch-rank", {
            "device": device, "backend": backend, "small": small,
            "after_dir": str(after_dir), "runs": runs},
            "moe dispatch", MOE_DISPATCH_TIMEOUT_S, backend, ranks)
        t2 = time.time()
    finally:
        shutil.rmtree(after_dir, ignore_errors=True)
    if any(r["backend"] != backend or r["world"] != ranks for r in results):
        fail(f"moe dispatch: backends "
             f"{[(r['backend'], r['world']) for r in results]}, want "
             f"{backend} x {ranks}")
    cfg, batch, seq = moe_dispatch_model(torch, small, device)
    want = (2 * cfg.num_layers * SHARDED_STEPS,
            cfg.num_layers * SHARDED_STEPS)
    out = {"reference_s": t1 - t0, "ranks_s": t2 - t1,
           "unsharded": {k: ref[k] for k in (
               "losses", "aux_losses", "grad_norms", "step_median_s",
               "tokens_per_s", "max_memory_gb")}}
    for run in runs:
        name = run["name"]
        label = f"moe dispatch {name} {run['mesh']}"
        got = [r[name] for r in results]
        res = {"mesh": run["mesh"],
               "sharded": {k: got[0][k] for k in (
                   "losses", "aux_losses", "grad_norms", "step_median_s",
                   "tokens_per_s", "collectives_share", "collectives_s",
                   "traced_step_s", "rows", "experts")},
               "rank_max_memory_gb": [g["max_memory_gb"] for g in got],
               "rank_launches": [[g["fwd_launches"], g["bwd_launches"]]
                                 for g in got]}
        for key, plural in (("loss", "losses"), ("grad_norm", "grad_norms")):
            res[f"{key}_rel_err"] = [
                check_rel(f"{label} rank {i} step 1 {key}", g[plural][:1],
                          ref[plural][:1], TRAIN_PLAIN_RTOL[key])[0]
                for i, g in enumerate(got)]
        worst = {}
        for i, g in enumerate(got):
            for j, (diff, base) in enumerate(zip(g["diffs"],
                                                 ref["base"][name][i])):
                for k, key in enumerate(("param", "exp_avg")):
                    rel = diff[k] / base[k] if base[k] else (
                        0.0 if diff[k] == 0 else math.inf)
                    if rel > worst.get(key, (-1.0,))[0]:
                        worst[key] = (rel, i, ref["paths"][j])
                    if not rel <= MOE_UPDATE_RTOL_MESH[key]:
                        fail(f"{label}: rank {i} {ref['paths'][j]} {key} "
                             f"after step 1 {rel:.4g} of the unsharded "
                             f"update away (limit "
                             f"{MOE_UPDATE_RTOL_MESH[key]})")
        res["update_rel"] = worst
        if name == "expert-batch":
            per = cfg.num_experts // run["mesh"]["expert"]
            if any(set(g["experts"].values()) != {per} for g in got):
                fail(f"{label}: expert leaves hold "
                     f"{[g['experts'] for g in got]} experts, want {per}")
            res["exchange"] = exchange_bytes(cfg, batch, seq,
                                             run["mesh"]["expert"])
        if cuda and any(tuple(l) != want for l in res["rank_launches"]):
            fail(f"{label}: flash launches (fwd, bwd) per rank "
                 f"{res['rank_launches']}, expected {want} on each")
        out[name] = res
        log(f"{label}: " + json.dumps(res))
    return out


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--cp-rank"]:
        # a rank of phase 14: its spec names the device
        sys.path.insert(0, str(ROOT))
        cp_rank(torch, *sys.argv[2:4])
        return 0

    if sys.argv[1:2] == ["--moe-dispatch-rank"]:
        # a rank of phase 17: its spec names the device
        sys.path.insert(0, str(ROOT))
        moe_dispatch_rank(torch, *sys.argv[2:4])
        return 0

    if sys.argv[1:2] == ["--elastic-train"]:
        # a trainer of phase 15 (its device is its third argument)
        sys.path.insert(0, str(ROOT))
        elastic_train_rank(torch, *sys.argv[2:5])
        return 0

    if sys.argv[1:2] == ["--mesh-serve-rank"]:
        # a rank of phase 13 or 16: its spec names the device
        sys.path.insert(0, str(ROOT))
        mesh_serve_rank(torch, *sys.argv[2:4])
        return 0

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
    kernels.update(check_window_kernels(torch))
    kernels.update(check_mla_kernels(torch))
    kernels.update(check_rownorm_kernels(torch))
    kernels.update(check_adamw_kernels(torch))
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
    # the 8B trainer's layers and Mixtral's (b4 s2048 both) launch the row
    # kernel at the rows' shapes: the rotation on q and k, the norms on
    # [8192, 4096] rows
    fit = next(r for r in trained if r["config"] == "llama3-8b-fit")
    for way, suffix in (("fwd", ""), ("bwd", "_bwd")):
        for run in (fit, mixtral["train"]):
            counted = run["row_launches"]
            kernels[f"rownorm_{way}[8b/mixtral q/k rope]"]["launches"] += \
                counted["qk_prologue_rope" + suffix]
            kernels[f"rownorm_{way}[8b/mixtral rows]"]["launches"] += \
                counted["rms_norm" + suffix]
    trinity = afmoe_phase(torch)
    window = WINDOW_ROWS["trinity-mini"][-1]
    for way in ("fwd", "bwd"):
        kernels[f"flash_attention_{way}[trinity-mini,D=128,window={window}]"][
            "launches"] = trinity[f"window_{way}_launches"]
    # sliding layers norm and rotate q and k, full ones only norm them: the
    # prologue's launches less those that rotated
    for way, suffix in (("fwd", ""), ("bwd", "_bwd")):
        counted = trinity["row_launches"]
        rotated = counted["qk_prologue_rope" + suffix]
        kernels[f"rownorm_{way}[trinity-mini q/k norm+rope]"]["launches"] = \
            rotated
        kernels[f"rownorm_{way}[trinity-mini q/k norm]"]["launches"] = \
            counted["qk_prologue" + suffix] - rotated
        kernels[f"rownorm_{way}[trinity-mini rows]"]["launches"] = \
            counted["rms_norm" + suffix]
    kanana = kanana_phase(torch)
    for way in ("fwd", "bwd"):
        kernels[f"flash_attention_{way}[kanana2-30b-a3b,D=192/128]"][
            "launches"] = kanana[f"mla_{way}_launches"]
    meshed = mesh_serving_phase(torch)
    for run in meshed.values():
        # every rank's launches, each on its Hkv / tensor kv heads (its
        # row's shape); the server's count rank 0's
        if isinstance(run, dict) and "k5_row" in run:
            kernels[run["k5_row"]]["launches"] += sum(
                run.get("rank_launches", [run["launches"]]))
    rest = mesh_serving_rest_phase(torch)
    for row, launches in rest["k5_launches"].items():
        kernels[row]["launches"] += launches
    context = context_pipeline_phase(torch)
    # both ranks' launches: Ulysses runs the kernels on the whole sequence
    # of half the heads (the seq=2 rows' shapes), the pipeline on
    # microbatches of the 1B trainer's rows
    for name, row in (("ulysses-1b", "llama3-1b/seq=2,D=64"),
                      ("ulysses-8b", "llama3-8b-fit/seq=2,D=128"),
                      ("pipeline-1b", "llama3-1b,D=64")):
        for i, way in enumerate(("fwd", "bwd")):
            kernels[f"flash_attention_{way}[{row}]"]["launches"] += sum(
                r[i] for r in context[name]["rank_launches"])
    dispatch = moe_dispatch_phase(torch)
    # both ranks' launches: Mixtral's attention has the 8B geometry's
    # shapes (b2 s2048 a rank under the token exchange, b4 s2048 a replica)
    for name in ("expert-batch", "seq", "stage"):
        for i, way in enumerate(("fwd", "bwd")):
            kernels[f"flash_attention_{way}[llama3-8b-fit,D=128]"][
                "launches"] += sum(r[i] for r in dispatch[name][
                    "rank_launches"])
    elastic = elastic_phase(torch)
    kernels["paged_decode_attention[bf16,llama3-1b]"]["launches"] += \
        elastic["launches"]
    for way in ("fwd", "bwd"):
        kernels[f"flash_attention_{way}[llama3-1b,D=64]"]["launches"] += \
            elastic[f"{way}_launches"]
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
                                 "losses", "adamw_launches")}))
    log("train-plain summary: " + json.dumps(plain))
    log("trinity summary: " + json.dumps(
        {k: trinity[k] for k in ("tokens_per_s", "step_median_s", "losses",
                                 "dropped_tokens", "max_memory_allocated_gb",
                                 "window_fwd_launches",
                                 "window_bwd_launches", "row_launches",
                                 "adamw_launches")}))
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
             "losses", "aux_losses", "adamw_launches")},
         "train_plain": {n: mixtral["train"]["plain"][n] for n in (
             "loss_rel_err", "grad_norm_rel_err")}}))
    log("mesh-serving summary: " + json.dumps({
        "card": card, **{name: ({k: run[k] for k in (
            "ttft_s", "decode_step_s", "decode_tok_per_s", "launches",
            "decode_steps", "rank_launches", "followers_checked",
            "worst_gap_std", "flips", "rank_max_memory_gb") if k in run}
            if isinstance(run, dict) else run)
            for name, run in meshed.items()}}))
    log("mesh-serving-rest summary: " + json.dumps({
        "card": card, "world_s": rest["world_s"],
        "pd_pair": {k: rest["pd"]["pair"][k] for k in (
            "export_rel_err", "export_s", "install_and_decode_s",
            "wire_bytes", "rank_launches", "followers_checked",
            "worst_gap_std")},
        "pd_one_card": rest["pd"]["one_card"],
        **{name: {side: {k: run[k] for k in (
            "ttft_s", "decode_step_s", "launches", "decode_steps",
            "rank_launches", "followers_checked", "worst_gap_std",
            "rank_max_memory_gb", "rank_weight_gb", "weight_gb") if k in run}
            for side, run in rest[name].items()}
           for name in ("fsdp_bf16", "fsdp_int8")},
        "span": {name: ({k: v for k, v in run.items() if k != "tokens"}
                        if isinstance(run, dict) else run)
                 for name, run in rest["span"].items()},
        "decode_api": rest["decode_api"]}))
    log("context-pipeline summary: " + json.dumps({"card": card, **{
        name: {k: run[k] for k in (
            "unsharded", "sharded", "loss_rel_err", "grad_norm_rel_err",
            "rank_max_memory_gb", "rank_launches")}
        for name, run in context.items()}}))
    log("moe-dispatch summary: " + json.dumps({"card": card, **dispatch}))
    log("elastic summary: " + json.dumps({"card": card, **{
        k: elastic[k] for k in (
            "snapshot_bytes", "snapshot_write_s", "a_ready_s", "pull_bytes",
            "pull_s", "pull_gb_per_s", "nvcc_leg_s", "a_launches")},
        **{name: elastic[name] for name in ("b", "c")},
        "trainers": {name: {k: run[k] for k in (
            "loss", "loss_rel_err", "first_step_s", "process_s",
            "compile_cache_hits", "compile_cache_misses",
            "compile_cache_puts", "resolved")}
            for name, run in elastic["trainers"].items()}}))
    # again here, so that the end of a long log still says which card
    log(f"card: {card}")
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
