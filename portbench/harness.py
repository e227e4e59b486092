"""One run of one cell: set up, measure, check, print the result line.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs on the machine it is started on and needs its cards:
without CUDA, or with fewer cards than the cell asks for, it exits
non-zero and prints no result.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and ``checks`` last:
each number compared, with its limit); the numbers compared are also the
last lines of standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from portbench import spec

ROOT = Path(__file__).resolve().parents[1]
#: every cache the port or torch writes, at fixed paths inside the checkout
CACHE = ROOT / ".portbench-cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "dstack_tpu")


def set_cache_env() -> None:
    """Point the build and kernel caches into the checkout (before torch
    is imported), and keep libraries from loading JAX."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "2")


def compile_cache():
    """The port's compile cache of nvcc libraries, rooted in the
    checkout."""
    from dstack_tpu_torch.elastic.compile_cache import CompileCache

    return CompileCache(root=CACHE / "compile")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``dstack_tpu_torch`` is not ``dstack_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Check:
    """One number compared with its limit (lower is better)."""

    name: str
    value: Optional[float]
    limit: Optional[float]

    @property
    def ok(self) -> bool:
        return (self.value is not None and self.limit is not None
                and math.isfinite(self.value) and self.value <= self.limit)


def checks(numbers: Dict[str, Any], limits: Dict[str, float],
           notes: List[str]) -> List[Check]:
    """The numbers the cell has a limit for, as checks; the others (read
    for the record: a widest gap, a number whose readings set no limit,
    see PERF.md) go to the notes."""
    rest = {k: v for k, v in numbers.items() if k not in limits}
    if rest:
        notes.append("read, not compared: " + ", ".join(
            f"{k} {v}" for k, v in rest.items()))
    return [Check(k, numbers.get(k), v) for k, v in limits.items()]


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the stamps the readers reduce, the
    checks, and the device's readings."""

    run: Any
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Any = None
    notes: List[str] = dataclasses.field(default_factory=list)
    #: what the check compared, for a control read on the same inputs
    #: (``calibrate.py``): a serving cell's sample, a training cell's
    #: batches and the program's readings
    compared: Any = None
    #: every number the check read, compared or not
    readings: Dict[str, Any] = dataclasses.field(default_factory=dict)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def device_of(device: Optional[str]):
    import torch

    if device is None:
        return torch.device("cuda", 0)
    return torch.device(device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device=None, clock0: Optional[float] = None) -> Outcome:
    """Drive one cell on ``device`` (the first card when None)."""
    clock0 = time.time() if clock0 is None else clock0
    if cell.generator.DRIVER == "serve":
        from portbench import serve as driver
    else:
        from portbench import train as driver
    return driver.run(cell, seed, seconds, trace, device_of(device), clock0)


def read_metrics(cell: spec.Cell, outcome: Outcome, trace: bool
                 ) -> Dict[str, Dict[str, Any]]:
    """The cell's end-to-end metrics (``trace`` False) or its per-layer
    metrics; a reader that finds nothing is left out."""
    names = cell.cell["per_layer" if trace else "end_to_end"]
    out = {}
    for name in names:
        reader = cell.metric_reader(name)
        value = reader.read(outcome.run)
        if value is None:
            print(f"portbench: metric {name}: nothing to read",
                  file=sys.stderr)
            continue
        out[name] = {"value": float(value), "unit": reader.UNIT}
    return out


def result_line(cell: spec.Cell, outcome: Outcome, trace: bool,
                device) -> Dict[str, Any]:
    import torch

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell.cell.get("chips", 1)),
           "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line: Dict[str, Any] = {
        "correct": all(c.ok for c in outcome.checks) and bool(outcome.checks),
        "attempted": outcome.attempted, "failed": outcome.failed,
        "metrics": read_metrics(cell, outcome, trace), "device": dev}
    if trace and outcome.trace is not None:
        dev["busy_s"] = outcome.trace.busy_s
        dev["window_s"] = outcome.trace.window_s
        line["breakdown"] = outcome.trace.breakdown()
    # a number that could not be read (a fault the check cannot follow)
    # is printed as null
    line["checks"] = {c.name: {"value": c.value if c.value is not None
                               and math.isfinite(c.value) else None,
                               "limit": c.limit} for c in outcome.checks}
    return line


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None,
         clock0: Optional[float] = None) -> int:
    clock0 = time.time() if clock0 is None else clock0
    args = parse(argv)
    cell = spec.find(args.workload)
    import torch

    chips = int(cell.cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"portbench: card {card_line()}", file=sys.stderr)
    outcome = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       clock0=clock0)
    line = result_line(cell, outcome, bool(args.trace), device_of(None))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}: nothing of JAX or the JAX "
              f"package may run here", file=sys.stderr)
        return 3
    outcome.notes.append(f"the run took {time.time() - clock0:.1f} s")
    for note in outcome.notes:
        print(f"portbench: {note}", file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name} {c.value} limit {c.limit} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
