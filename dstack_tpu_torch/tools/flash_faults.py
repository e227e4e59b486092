"""Planted faults in the flash-attention kernels, against chip_smoke's limits.

    python -m dstack_tpu_torch.tools.flash_faults    # from the repo root

Builds copies of ``ops/csrc/flash_fwd.cu`` and ``ops/csrc/flash_bwd.cu``,
the sound ones and one with each fault below planted, into
``dstack_tpu_torch/build/faults/`` (all ``nvcc`` runs at once), and holds
each to the plain versions with chip_smoke.py's error measures, at its
small edge shapes and its two training shapes.  A fault in one source runs
beside the sound build of the other.  Prints, per fault and shape, each
output's largest absolute error and largest row error and whether
chip_smoke's limits (``FLASH_LIMITS``) catch it; the last line is the same
as JSON.  The limits should sit above every sound error and below every
fault's.  The sources in the checkout are read, never written.  Needs one
CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from dstack_tpu_torch.tools.paged_decode_faults import build_fault

#: a prefix that skips the dk/dv products under a condition
_DKDV_IF = "if ({}) WgmmaRS<D, 1>::run({}_acc,"
#: fault -> (source, what it breaks, [(text of the sound source, replacement)])
FAULTS = {
    "fwd_no_rescale": (
        "flash_fwd", "the output accumulator is not rescaled when a later "
        "key tile raises the running max",
        [("acc[i] *= alpha[(i >> 1) & 1];", "acc[i] *= 1.f;")]),
    "fwd_mask_off_by_one": (
        "flash_fwd", "the diagonal tile lets each query see the next key",
        [("if (key > qpos + 8 * ((i >> 1) & 1)) s[i] = kNegInf;",
          "if (key > qpos + 8 * ((i >> 1) & 1) + 1) s[i] = kNegInf;")]),
    "fwd_skip_diagonal": (
        "flash_fwd", "query tiles after the first drop their diagonal key "
        "tile's probabilities",
        [("const float p = ex2(",
          "const float p = (n == 0 && iq > 0) ? 0.f : ex2(")]),
    "fwd_wrong_gqa_head": (
        "flash_fwd", "query head h reads kv head h % Hkv, not h / group",
        [("const int hk = h / (hq / hkv);", "const int hk = h % hkv;")]),
    "dkdv_skip_last_qblock": (
        "flash_bwd", "dk/dv leave out the last query tile",
        [(f"WgmmaRS<D, 1>::run({acc}_acc,",
          _DKDV_IF.format("it < nq - 1", acc)) for acc in ("dv", "dk")]),
    "dkdv_skip_diagonal": (
        "flash_bwd", "dk/dv start at the query tile after the diagonal",
        [(f"WgmmaRS<D, 1>::run({acc}_acc,",
          _DKDV_IF.format("it > first", acc)) for acc in ("dv", "dk")]),
    "dkdv_drop_group_head": (
        "flash_bwd", "dk/dv sum all but the last query head of each group",
        [(f"WgmmaRS<D, 1>::run({acc}_acc,",
          _DKDV_IF.format("g < group - 1", acc)) for acc in ("dv", "dk")]),
    "bwd_mask_off_by_one": (
        "flash_bwd", "the backward's diagonal tiles let each query see the "
        "next key (dq, dk and dv)",
        [("kpos + 8 * ((i >> 1) & 1) > qpos);",
          "kpos + 8 * ((i >> 1) & 1) > qpos + 1);")]),
    "bwd_no_delta": (
        "flash_bwd", "ds leaves out delta (ds = p * dp; dq and dk)",
        [("sp[i] * (dp[i] - delta_st[qcol(i)])", "sp[i] * dp[i]")]),
    "dq_skip_diagonal": (
        "flash_bwd", "dq of query tiles after the first leaves out the "
        "diagonal key tile",
        [("reduce_dq(dq,", "if (!(diag && it > 0)) reduce_dq(dq,")]),
    "dq_wrong_gqa_head": (
        "flash_bwd", "dq of query head h reads kv head h % Hkv",
        [("row, c0, dcol0, h,", "row, c0, dcol0, hk + g * hkv,")]),
    "dq_skip_reduce_tile": (
        "flash_bwd", "the reduce-add of dq is skipped for one (query tile, "
        "key tile) pair: the last query tile against key tile 0",
        [("reduce_dq(dq,", "if (!(it == nq - 1 && jk == 0)) reduce_dq(dq,")]),
}
SOURCES = ("flash_fwd", "flash_bwd")


def bind(name: str, lib: Path):
    from dstack_tpu_torch.ops import _build

    symbol, argtypes = _build.SIGNATURES[name]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_faults: CUDA is not available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import chip_smoke
    from dstack_tpu_torch.ops import _build
    from dstack_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    jobs = {f"sound_{src}": (src, []) for src in SOURCES}
    jobs.update({name: (src, edits) for name, (src, _, edits)
                 in FAULTS.items()})
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(
            lambda kv: build_fault(kv[0], kv[1][1], kv[1][0]),
            jobs.items())))
    sound = {src: bind(src, libs[f"sound_{src}"]) for src in SOURCES}
    shapes = list(chip_smoke.FLASH_EDGE_SHAPES)
    for cfg_name in chip_smoke.TRAIN_STEPS:
        cfg, batch, seq, _ = chip_smoke.trainer(cfg_name)
        shapes.append((batch, seq, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim))
    cases = {"sound": (None, "the kernels as they are")}
    cases.update({n: (src, what) for n, (src, what, _) in FAULTS.items()})
    rows = []
    try:
        for name, (src, what) in cases.items():
            _build._bound.update(sound)
            if src is not None:
                _build._bound[src] = bind(src, libs[name])
            for shape in shapes:
                errs = chip_smoke.flash_errors(torch, fa, shape,
                                               shape[4] ** -0.5)[2]
                bad = sorted(chip_smoke.flash_violations(errs))
                rows.append({"fault": name, "source": src, "shape": shape,
                             "errors": errs, "caught_by": bad})
                verdict = "caught by " + ",".join(bad) if bad else "passes"
                print(f"{name:22s} {str(shape):24s} " + " ".join(
                    f"{n} {e:.2e}" for n, e in errs.items())
                    + f"  {verdict}  ({what})", flush=True)
                torch.cuda.empty_cache()
    finally:
        for src in SOURCES:
            _build._bound.pop(src, None)
    print(json.dumps({"limits": chip_smoke.FLASH_LIMITS, "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
