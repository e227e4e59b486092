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

_DIAG_ONLY_IN_BLOCK_0 = "j < iq + (iq == 0); ++j) {"
#: fault -> (source, what it breaks, [(text of the sound source, replacement)])
FAULTS = {
    "fwd_no_rescale": (
        "flash_fwd", "the output accumulator is not rescaled when a later "
        "key block raises the running max",
        [("orow[c] *= alpha;", "orow[c] *= 1.f;")]),
    "fwd_mask_off_by_one": (
        "flash_fwd", "the diagonal block lets each query see the next key",
        [("j * kBlock + c0 + c > qpos) s = kNegInf;",
          "j * kBlock + c0 + c > qpos + 1) s = kNegInf;")]),
    "fwd_skip_diagonal": (
        "flash_fwd", "query blocks after the first skip their diagonal key "
        "block",
        [("for (int j = 0; j <= iq; ++j) {",
          "for (int j = 0; " + _DIAG_ONLY_IN_BLOCK_0)]),
    "fwd_wrong_gqa_head": (
        "flash_fwd", "query head h reads kv head h % Hkv, not h / group",
        [("const int hk = h / (hq / hkv);", "const int hk = h % hkv;")]),
    "dkdv_skip_last_qblock": (
        "flash_bwd", "dk/dv stop one query block short (i < nblk - 1)",
        [("for (int i = jk; i < nblk; ++i) {",
          "for (int i = jk; i < nblk - 1; ++i) {")]),
    "dkdv_skip_diagonal": (
        "flash_bwd", "dk/dv start at the query block after the diagonal",
        [("for (int i = jk; i < nblk; ++i) {",
          "for (int i = jk + 1; i < nblk; ++i) {")]),
    "dkdv_mask_off_by_one": (
        "flash_bwd", "dk/dv's diagonal block lets each query see the next "
        "key",
        [("return i == jk && kpos > qbase + c;",
          "return i == jk && kpos > qbase + c + 1;")]),
    "dkdv_drop_group_head": (
        "flash_bwd", "dk/dv sum all but the last query head of each group",
        [("for (int g = 0; g < group; ++g) {",
          "for (int g = 0; g < group - 1; ++g) {")]),
    "dkdv_no_delta": (
        "flash_bwd", "dk's ds leaves out delta (ds = p * dp)",
        [("pv[c] * (dp_row[c] - delta_s[c0 + c])", "pv[c] * dp_row[c]")]),
    "dq_skip_diagonal": (
        "flash_bwd", "dq of query blocks after the first skips the diagonal "
        "key block",
        [("for (int j = 0; j <= iq; ++j) {",
          "for (int j = 0; " + _DIAG_ONLY_IN_BLOCK_0)]),
    "dq_mask_off_by_one": (
        "flash_bwd", "dq's diagonal block lets each query see the next key",
        [("return j == iq && kbase + c > qpos;",
          "return j == iq && kbase + c > qpos + 1;")]),
    "dq_wrong_gqa_head": (
        "flash_bwd", "dq of query head h reads kv head h % Hkv",
        [("const int hk = h / (hq / hkv);", "const int hk = h % hkv;")]),
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
