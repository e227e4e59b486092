"""Planted faults in the paged-decode kernel, against chip_smoke's limits.

    python -m dstack_tpu_torch.tools.paged_decode_faults    # from the repo root

Builds copies of ``ops/csrc/paged_decode.cu``, the sound one and one with
each fault below planted, into ``dstack_tpu_torch/build/faults/`` (one
``nvcc`` per copy, all started together), and holds each to the plain
version at chip_smoke.py's shapes and cases (ragged, one split,
mid-split, full) and with its error measure.  Prints, per fault and case,
the largest |o| and |lse| errors and whether chip_smoke's limits
(``O_ATOL``, ``LSE_ATOL``, the empty-slot sentinel) catch it, and per
fault the number of cases that catch it; the last line is the same as
JSON.  Exits 1 if the sound kernel fails a case or a fault passes every
case.  The sources in the checkout are read, never written.  Needs one
CUDA card.
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
        "acc is not rescaled when a later tile raises the running max",
        [("const float alpha0 = __shfl_sync(0xffffffffu, alpha, 8 * tig);",
          "const float alpha0 = 1.f;"),
         ("const float alpha1 = __shfl_sync(0xffffffffu, alpha, 8 * tig + 4);",
          "const float alpha1 = 1.f;")]),
    "stale_v_late": (
        "past the slot's 8th page, the last page of a split's run reads "
        "its V rows (and int8 V scales) from the page before it",
        [("const long long row = (page * bs + within) * hkv + h;",
          "const long long row = (page * bs + within) * hkv + h;\n"
          "    const long long vrow = (valid && col >= 8 && (col + 1) * bs "
          ">= end)\n"
          "        ? ((long long)trow[col - 1] * bs + within) * hkv + h : "
          "row;"),
         ("vp + row * L::kRowBytes", "vp + vrow * L::kRowBytes"),
         ("vs + row", "vs + vrow")]),
    "drop_last_row_pv": (
        "the PV product skips each page's last row (scores and l keep it)",
        [("const uint32_t pb = pack_bf16(p0, p1);",
          "const uint32_t pb = pack_bf16(p0, (pos + 1) % bs == bs - 1 ? 0.f "
          ": p1);")]),
    "merge_drops_last_split": (
        "the merge gives the last split's partial no weight",
        [("const float wt = expf(lp[s * group] - mx);",
          "const float wt = s == splits - 1 ? 0.f : expf(lp[s * group] - "
          "mx);")]),
    "split_boundary_off_by_one": (
        "every split after the first starts one page late: the page at "
        "each boundary is walked by no split",
        [("const int c0 = split * cols;",
          "const int c0 = split * cols + (split > 0);")]),
    "empty_split_weight": (
        "a split that starts at or past the length writes lse 0 instead "
        "of -1e30, so the merge gives its zero partial weight",
        [("if (tid < rows) lse_out[part + tid] = kNegInf;",
          "if (tid < rows) lse_out[part + tid] = 0.f;")]),
    "ring_read_before_wait": (
        "a warp computes a ring stage without waiting for its copies",
        [("cp_async_wait<kStages - 1>();", "cp_async_wait<kStages>();")]),
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


def start_fault_build(name: str, edits, source: str = "paged_decode"):
    """Start compiling the planted copy into ``build/faults/<name>.so``,
    with ``csrc/`` on the include path for the shared headers; returns
    (the nvcc process, the library's path)."""
    from dstack_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "faults"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / f"{name}.cu", out_dir / f"{name}.so"
    src.write_text(planted_source(edits, source))
    proc = subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS,
                             f"-I{_build.CSRC}", "-o", str(lib), str(src)],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, lib


def finish_fault_build(name: str, build) -> Path:
    proc, lib = build
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for fault {name}:\n{log}")
    return lib


def build_fault(name: str, edits, source: str = "paged_decode") -> Path:
    """Compile the planted copy and wait for it (see start_fault_build)."""
    return finish_fault_build(name, start_fault_build(name, edits, source))


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
    builds = {name: start_fault_build(name, edits)
              for name, (_, edits) in FAULTS.items()}
    libs = {name: finish_fault_build(name, b) for name, b in builds.items()}
    cases = chip_smoke.paged_cases(
        torch.cuda.get_device_properties(0).multi_processor_count)
    rows, caught_at = [], {}
    try:
        for name, (what, _) in FAULTS.items():
            fn = getattr(ctypes.CDLL(str(libs[name])), symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _build._bound["paged_decode"] = fn
            for shape, d in chip_smoke.SHAPES.items():
                for quant in (False, True):
                    for case, (lengths, nbk) in cases.items():
                        args = chip_smoke.make_case(
                            torch, d, quant, seed=d + quant, lengths=lengths,
                            nbk=nbk)
                        err_o, err_lse, empty_ok = chip_smoke.errors(
                            torch, fa, args)
                        caught = not (err_o <= chip_smoke.O_ATOL
                                      and err_lse <= chip_smoke.LSE_ATOL
                                      and empty_ok)
                        caught_at[name] = caught_at.get(name, 0) + caught
                        row = {"fault": name, "shape": shape,
                               "variant": "int8" if quant else "bf16",
                               "case": case, "max_abs_err_o": err_o,
                               "max_abs_err_lse": err_lse,
                               "empty_slot_ok": empty_ok, "caught": caught}
                        rows.append(row)
                        print(f"{name:26s} {shape:10s} {row['variant']:5s} "
                              f"{case:10s} o {err_o:.3e}  lse {err_lse:.3e}"
                              f"  empty {'ok' if empty_ok else 'BAD'}  "
                              f"{'caught' if caught else 'passes'}",
                              flush=True)
            print(f"{name}: caught at {caught_at.get(name, 0)} of "
                  f"{4 * len(cases)} cases ({what})", flush=True)
    finally:
        _build._bound.pop("paged_decode", None)
    print(json.dumps({"o_atol": chip_smoke.O_ATOL,
                      "lse_atol": chip_smoke.LSE_ATOL,
                      "caught_at": caught_at, "cases": rows}))
    missed = [n for n in FAULTS if n != "sound" and not caught_at.get(n)]
    return 1 if caught_at.get("sound") or missed else 0


if __name__ == "__main__":
    sys.exit(main())
