"""Training cells: the port's train step as the cell's model family
builds it (``families/``; remat and AdamW at their defaults), fed by the
port's ``DataLoader`` over a corpus drawn from the seed.

Set-up builds the one state the window trains, and drives it through its
first three steps with the window's own call and feed; those steps are
what the reference follows: each step's loss, the first gradient as the
optimizer got it (its first moment after one step over ``1 - b1``) a
parameter slice, and each slice's change after the three, read before
the fourth step moves it.  The window then steps on for ``--seconds``;
with ``--trace 1`` two more steps are traced after it.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Dict, List, Optional

import numpy as np

from portbench import harness, taps, tracing, weights
from portbench.reference.judge import leaf_key

CHECK_STEPS = 3
TRACE_STEPS = 2


@dataclasses.dataclass
class TrainRun:
    """What the readers reduce (see ``metrics/``)."""

    cfg: Any
    cell: Any
    setup_s: float
    batch: int
    seq: int
    steps: int
    seconds: float
    trace: Optional[tracing.Trace] = None


def _slices(family, cfg, params) -> Dict[str, Any]:
    """Each (leaf, layer) slice of the program's tree, by check key: its
    leaf, layer, the tensor that holds it and its index there."""
    out = {}
    for name, l in weights.leaf_slices(family, cfg):
        whole, i = family.program_slice(params, name, l)
        out[leaf_key(name, l)] = (name, l, whole, i)
    return out


def _first_grad(state, params, family, cfg, b1: float) -> Dict[str, float]:
    """The first gradient as the optimizer got it, a slice: AdamW's first
    moment after one step is (1 - b1) times it."""
    opt = state.opt_state
    out = {}
    for key, (_name, _l, whole, i) in _slices(family, cfg, params).items():
        m = opt.state[whole].get("exp_avg")
        if m is None:  # the optimizer was never given a gradient
            out[key] = 0.0
            continue
        out[key] = float((m if i is None else m[i]).float().norm()) / (1 - b1)
    return out


def _update(params, family, cfg, seed: int, device) -> Dict[str, float]:
    """Each slice's change from its drawn start."""
    out = {}
    for key, (name, l, whole, i) in _slices(family, cfg, params).items():
        t = whole if i is None else whole[i]
        start = weights.initial(family, cfg, seed, name, l, device)
        out[key] = float((t.detach().float() - start.float()).norm())
    return out


def run(cell, seed: int, seconds: float, trace: bool, device,
        clock0: float) -> harness.Outcome:
    import torch
    from torch.profiler import record_function

    from dstack_tpu_torch.models import data, train
    from portbench.reference import judge
    from portbench.reference.training import Reference

    family = cell.family
    cfg = cell.model_config()
    mix = cell.traffic
    b, s = int(mix["batch"]), int(mix["seq_len"])
    params = family.program_params(cfg, seed, device)
    opt = train.default_optimizer()
    state, step = family.train_program(
        cfg, params, opt,
        harness.compile_cache() if device.type == "cuda" else None)
    gen = cell.generator
    corpus = gen.corpus(mix, seed, cfg.vocab_size)
    loader = data.DataLoader(
        data.TokenDataset.from_files([corpus], s, dtype=np.uint32), b,
        seed=weights.leaf_seed(seed, "data", 0), device=device)
    feed = loader.batches()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    fed: List[torch.Tensor] = []
    prog: Dict[str, Any] = {"loss": []}
    check_s = 0.0
    # the first steps' router logits (the forward's, not remat's second
    # pass), which the reference follows
    route_tap, patches = family.route_tap(cfg), taps.Patches()
    routes = None
    if route_tap is not None:
        route_tap.install(patches)
        routes = []
    for i in range(CHECK_STEPS):
        batch = next(feed)
        fed.append(batch["tokens"].cpu())
        if route_tap is not None:
            route_tap.enabled, first = True, len(route_tap.calls)
        state, metrics = step(state, batch)
        if route_tap is not None:
            route_tap.enabled = False
            routes.append(route_tap.by_layer(route_tap.calls[first:]))
        prog["loss"].append(float(metrics["loss"]))
        t = time.time()
        if i == 0:
            prog["grad"] = _first_grad(state, params, family, cfg, opt.b1)
        if i == CHECK_STEPS - 1:
            prog["update"] = _update(params, family, cfg, seed, device)
        check_s += time.time() - t
    patches.close()
    sync()
    setup_s = time.time() - clock0 - check_s
    t0 = time.time()
    n = 0
    while True:
        state, metrics = step(state, next(feed))
        float(metrics["loss"])
        n += 1
        t1 = time.time()
        if t1 - t0 >= seconds:
            break
    tr = None
    if trace and device.type == "cuda":
        prof = tracing.Profiler()
        prof.start()
        for _ in range(TRACE_STEPS):
            with record_function("portbench.train_step"):
                state, metrics = step(state, next(feed))
        prof.stop()
        tr = prof.trace()
    sync()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    result = TrainRun(cfg=cfg, cell=cell, setup_s=setup_s, batch=b, seq=s,
                      steps=n, seconds=t1 - t0, trace=tr)
    del state, step, feed, loader, params, metrics
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = Reference(family, cfg, seed, device).steps(fed, opt, follow=routes)
    numbers = judge.training(prog, ref)
    limits = cell.cell.get("limits", {})
    notes = [f"losses {prog['loss']} against {ref['loss']}"]
    checks = harness.checks(numbers, limits, notes)
    return harness.Outcome(run=result, checks=checks, attempted=n, failed=0,
                           memory_peak_bytes=peak, trace=tr, notes=notes,
                           compared={"batches": fed, "program": prog,
                                     "reference": ref, "optimizer": opt},
                           readings=numbers)
