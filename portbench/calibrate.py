"""How the cells' rates and limits were found; not part of a run.

``python -m portbench.calibrate sweep --workload <serving cell> --rates
1.5,2,2.5 --seed <n> --seconds <s>``: the open-loop cell at each offered
rate in turn, one line each: requests due and finished in the window,
the backlog (submitted, not yet admitted) at the window's quarters, and
the latency tails.  The knee is the highest rate whose backlog does not
grow over the window.

``python -m portbench.calibrate bounds --sets 'A/*.out' 'B/*.out'``: the
result lines of two sets of runs of one cell (the last line of each
file): each metric's median and spread (interquartile range over the
median) in each set, and five times the wider spread, the bound the
benchmark's rule gives (never under 1%).

``python -m portbench.calibrate limits --workload <cell> --seeds a,b,..
--seconds <s> [--control K] [--faults K] [--precision P]``: the numbers a
run compares, for each seed, printed one line a seed: the program's (the
lower readings), then on the first K seeds the control's on the same
inputs (serving: the int8 reference's picks; training: the reference as
the program at ``P``, ``fp8`` by default or ``fp8_experts``) and, for a
training cell, the step's faults (half of the batch left out).  A state left unchanged reads 1 on ``update_gap`` by
construction and needs no run.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import sys
import time

from portbench import harness, spec


def _backlog(run, t: float) -> int:
    return sum(1 for s in run.served if s.due <= t and (
        s.request.admitted_at is None or s.request.admitted_at > t))


def sweep(args) -> None:
    from portbench import readers

    base = spec.find(args.workload)
    for rate in [float(r) for r in args.rates.split(",")]:
        cell = copy.deepcopy(base)
        cell.cell["rate_per_s"] = rate
        out = harness.run_cell(cell, args.seed, args.seconds, False)
        run = out.run
        t0, t1 = run.window
        quarters = [_backlog(run, t0 + q * (t1 - t0) / 4) for q in range(5)]
        window = run.in_window()
        print(json.dumps({
            "rate_per_s": rate, "due": len(window),
            "finished": sum(s.finished for s in window),
            "backlog_quarters": quarters,
            "ttft_ms": {q: readers.ttft_ms(run, q) for q in (50, 90)},
            "tpot_ms": {q: readers.tpot_ms(run, q) for q in (50, 90)},
            "queue_wait_p90_ms": readers.queue_wait_p90_ms(run),
            "checks": out.readings}), flush=True)
        del out, run
        gc.collect()


def bounds(args) -> None:
    import glob
    import statistics

    from portbench import stats

    sets = []
    for pattern in args.sets:
        runs = []
        for path in sorted(glob.glob(pattern)):
            with open(path) as f:
                lines = f.read().strip().splitlines()
            if lines:
                runs.append(json.loads(lines[-1])["metrics"])
        sets.append(runs)
    for name in sorted({m for runs in sets for r in runs for m in r}):
        values = [[r[name]["value"] for r in runs if name in r]
                  for runs in sets]
        spreads = [stats.spread(v) for v in values if len(v) >= 2]
        print(json.dumps({
            "metric": name, "runs": [len(v) for v in values],
            "medians": [statistics.median(v) for v in values if v],
            "spreads": spreads,
            "bound": max(0.01, 5 * max(spreads)) if spreads else None}))


def _half_batch(family):
    """The family's train step fed half of each batch (the mean over the
    rest); returns what puts it back."""
    make = family.train_program

    def halved(*a, **k):
        state, step = make(*a, **k)
        return state, lambda state, batch: step(
            state, {"tokens": batch["tokens"][:batch["tokens"].shape[0]
                                              // 2]})
    family.train_program = halved
    return lambda: setattr(family, "train_program", make)


def training_control(family, cfg, seed: int, compared, device,
                     precision: str = "fp8"):
    """The reference at ``precision`` in the program's place on the same
    batches: its numbers against the float32 reference following its
    routing."""
    from portbench.reference import judge
    from portbench.reference.training import Reference

    low = Reference(family, cfg, seed, device, precision=precision)
    ctrl = low.steps(compared["batches"], compared["optimizer"])
    follow = [[None if logits is None else (logits, None) for logits in step]
              for step in low.routes]
    del low
    ref = Reference(family, cfg, seed, device).steps(
        compared["batches"], compared["optimizer"], follow=follow)
    return judge.training(ctrl, ref), ctrl["loss"]


def limits(args) -> None:
    import torch

    from portbench.reference import judge

    cell = spec.find(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    device = harness.device_of(None)
    for i, seed in enumerate(seeds):
        t = time.time()
        out = harness.run_cell(cell, seed, args.seconds, False)
        line = {"seed": seed, "program": out.readings,
                "run_s": time.time() - t}
        if "batches" in (out.compared or {}):
            line["losses"] = {"program": out.compared["program"]["loss"],
                              "reference": out.compared["reference"]["loss"]}
        if i < args.control:
            if "batches" in (out.compared or {}):
                line["control"], line["losses"]["control"] = training_control(
                    cell.family, cell.model_config(), seed, out.compared,
                    device, args.precision)
            else:
                line["control"] = judge.served_control(
                    cell.family, cell.model_config(), seed, out.compared,
                    device)
        del out
        gc.collect()
        torch.cuda.empty_cache()
        if i < args.faults:
            undo = _half_batch(cell.family)
            try:
                bad = harness.run_cell(cell, seed, 0.0, False)
            finally:
                undo()
            line["half_batch"] = bad.readings
            line["losses"]["half_batch"] = bad.compared["program"]["loss"]
            del bad
            gc.collect()
            torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    harness.set_cache_env()
    p = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    sub = p.add_subparsers(dest="what", required=True)
    s = sub.add_parser("sweep")
    s.add_argument("--workload", required=True)
    s.add_argument("--rates", required=True)
    s.add_argument("--seed", type=int, required=True)
    s.add_argument("--seconds", type=float, required=True)
    s = sub.add_parser("bounds")
    s.add_argument("--sets", nargs="+", required=True)
    s = sub.add_parser("limits")
    s.add_argument("--workload", required=True)
    s.add_argument("--seeds", required=True)
    s.add_argument("--seconds", type=float, required=True)
    s.add_argument("--control", type=int, default=0)
    s.add_argument("--faults", type=int, default=0)
    s.add_argument("--precision", default="fp8",
                   choices=("fp8", "fp8_experts"))
    args = p.parse_args(argv)
    {"sweep": sweep, "bounds": bounds, "limits": limits}[args.what](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
