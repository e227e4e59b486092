"""Planted faults in the paged-decode kernel, against chip_smoke's limits.

    python -m dstack_tpu_torch.tools.paged_decode_faults    # from the repo root

Builds copies of ``ops/csrc/paged_decode.cu``, the sound one and one with
each fault below planted, into ``dstack_tpu_torch/build/faults/``, and
holds each to the plain version at chip_smoke.py's shapes and with its
error measure.  Prints, per fault and case, the largest |o| and |lse|
errors and whether chip_smoke's limits (``O_ATOL``, ``LSE_ATOL``, the
empty-slot sentinel) catch it; the last line is the same as JSON.  The
limits should sit above every sound error and below every fault's.  The
sources in the checkout are read, never written.  Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

#: fault -> (what it breaks, [(text of the sound source, replacement)])
FAULTS = {
    "sound": ("the kernel as it is", []),
    "no_rescale": (
        "acc is not rescaled when a later page raises the running max",
        [("acc[j] = acc[j] * a_s[g] + s;", "acc[j] = acc[j] + s;")]),
    "stale_v_late": (
        "the last page of a slot longer than 8 pages reads its V rows "
        "(and int8 V scales) from the page before it",
        [("const long long row = (page * BS + t) * hkv + h;",
          "const long long row = (page * BS + t) * hkv + h;\n"
          "      const long long vrow = (i >= 8 && (i + 1) * BS >= length)\n"
          "          ? ((long long)trow[i - 1] * BS + t) * hkv + h : row;"),
         ("static_cast<const int8_t*>(v_pages) + row * D)[d2];",
          "static_cast<const int8_t*>(v_pages) + vrow * D)[d2];"),
         ("vs = v_scales[row];", "vs = v_scales[vrow];"),
         ("static_cast<const __nv_bfloat162*>(v_pages)[row * D2 + d2];",
          "static_cast<const __nv_bfloat162*>(v_pages)[vrow * D2 + d2];")]),
    "drop_last_row_pv": (
        "the PV product skips each page's last row (scores and l keep it)",
        [("for (int t = 0; t < BS; ++t) {\n"
          "          const float p = __bfloat162float",
          "for (int t = 0; t < BS - 1; ++t) {\n"
          "          const float p = __bfloat162float")]),
}


def planted_source(edits, source: str = "paged_decode") -> str:
    """The text of ``csrc/<source>.cu`` with each (old, new) edit made;
    each old text must occur exactly once."""
    from dstack_tpu_torch.ops import _build

    src = (_build.CSRC / f"{source}.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{old!r} is not in {source}.cu exactly once; "
                             "update the fault's edits")
        src = src.replace(old, new)
    return src


def build_fault(name: str, edits, source: str = "paged_decode") -> Path:
    """Compile the planted copy into ``build/faults/<name>.so``, with
    ``csrc/`` on the include path for the shared headers."""
    from dstack_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "faults"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / f"{name}.cu", out_dir / f"{name}.so"
    src.write_text(planted_source(edits, source))
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS,
                           f"-I{_build.CSRC}", "-o", str(lib), str(src)],
                          stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for fault {name}:\n{proc.stdout}")
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("paged_decode_faults: CUDA is not available", file=sys.stderr)
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
    symbol, argtypes = _build.SIGNATURES["paged_decode"]
    rows = []
    try:
        for name, (what, edits) in FAULTS.items():
            fn = getattr(ctypes.CDLL(str(build_fault(name, edits))), symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _build._bound["paged_decode"] = fn
            for shape, d in chip_smoke.SHAPES.items():
                for quant in (False, True):
                    args = chip_smoke.make_case(torch, d, quant,
                                                seed=d + quant)
                    err_o, err_lse, empty_ok = chip_smoke.errors(torch, fa,
                                                                 args)
                    caught = not (err_o <= chip_smoke.O_ATOL
                                  and err_lse <= chip_smoke.LSE_ATOL
                                  and empty_ok)
                    row = {"fault": name, "shape": shape,
                           "variant": "int8" if quant else "bf16",
                           "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
                           "empty_slot_ok": empty_ok, "caught": caught}
                    rows.append(row)
                    print(f"{name:18s} {shape:10s} {row['variant']:5s} "
                          f"o {err_o:.3e}  lse {err_lse:.3e}  "
                          f"empty {'ok' if empty_ok else 'BAD'}  "
                          f"{'caught' if caught else 'passes'}  ({what})",
                          flush=True)
    finally:
        _build._bound.pop("paged_decode", None)
    print(json.dumps({"o_atol": chip_smoke.O_ATOL,
                      "lse_atol": chip_smoke.LSE_ATOL, "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
