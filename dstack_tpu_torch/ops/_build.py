"""Build and load the port's CUDA kernels (plain C ABI, loaded with ctypes).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``dstack_tpu_torch/build/<name>-<hash>.so`` at first use, from the sources
in the checkout only.  The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one loads the library already built.  :func:`build` starts one
``nvcc`` per source, all at once.  A build writes to a temporary name and
renames it into place, so two processes building at once never load a
half-written library.

Nothing here runs at import: the CPU test suite imports every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: argument types of each library's entry point (pointers and the stream
#: as c_void_p: ctypes would pass a bare int as 32 bits and cut a pointer)
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "paged_decode": ("dstack_paged_decode",
                     [_P] * 6 + [_LL] + [_P] * 5 + [_I] * 7
                     + [_F, _I, _P]),
    "flash_fwd": ("dstack_flash_fwd", [_P] * 5 + [_I] * 7 + [_F, _P]),
    "flash_bwd": ("dstack_flash_bwd", [_P] * 11 + [_I] * 7 + [_F, _P]),
    "rownorm": ("dstack_rownorm", [_P] * 14 + [_LL] * 2 + [_I] * 9
                + [_F, _P]),
    "adamw": ("dstack_adamw", [_P] * 5 + [_I] * 6 + [_F] * 6 + [_P]),
}

_bound: Dict[str, Callable[..., int]] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build on a machine with the CUDA toolkit")
    return found


def source_digest(name: str) -> str:
    """sha256 of what the library of ``csrc/<name>.cu`` is built from: the
    source, the shared headers and the flags (the compile cache's content
    address, elastic/compile_cache.py)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    return hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_digest(name)[:16]}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile each named source that has no up-to-date library, one
    ``nvcc`` per source started together; returns each compiler's output
    (register and shared-memory use, from ``-Xptxas -v``).  Raises with
    the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs: Dict[str, str] = {}
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{n}.cu:\n{logs[n]}" for n in failed))
    return logs


def load(name: str):
    """The entry point of ``csrc/<name>.cu``, built first if needed, bound
    once (argument types set) and cached."""
    fn = _bound.get(name)
    if fn is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn
