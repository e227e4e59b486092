"""Serving cells: the port's ``InferenceEngine`` on its own thread
(``run_forever``, the loop the server runs), fed by the traffic mix's
generator through ``submit``; HTTP is left out.

A run: the weights drawn from the seed, the engine built and warmed on
the prompt buckets and decode windows the plan will use (set-up), the
traffic started ``lead_in_s`` before the window, the window measured, and
with ``--trace 1`` a traced stretch after it.  How requests are sent,
what the window owes once it closes, and which requests count are the
traffic kind's (``traffic/__init__.py``); this driver names no kind.
Then the engine stops, and a sample of finished requests is held to the
plain reference (``reference/judge.py``) once the program's state is
freed.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time
from typing import Any, List, Optional

from portbench import harness, taps, tracing
from portbench.traffic import lengths

#: ranges the traced stretch opens around the program's functions, by the
#: names under which the engine calls them (module attributes; the
#: family's own in its ``SERVE_RANGES``), and its scheduler's methods (the
#: engine's own attributes)
MODULE_RANGES = (
    ("dstack_tpu_torch.serving.engine", "_masked_attention",
     "portbench.prefill_attention"),
)
ENGINE_RANGES = (("_prefill", "portbench.prefill"),
                 ("_dispatch_window", "portbench.window_dispatch"),
                 ("_drain_window", "portbench.window_drain"))


@dataclasses.dataclass
class Served:
    """One request as the benchmark saw it."""

    due: float
    prompt: List[int]
    max_new: int
    request: Any = None
    times: List[float] = dataclasses.field(default_factory=list)

    def on_token(self, _token: int) -> None:
        self.times.append(time.time())

    @property
    def finished(self) -> bool:
        r = self.request
        return (r is not None and r.done.is_set()
                and r.finish_reason == "length"
                and len(r.output) == self.max_new)


@dataclasses.dataclass
class ServeRun:
    """What the readers reduce (see ``metrics/``)."""

    cfg: Any
    cell: Any
    setup_s: float
    window: tuple
    end: float
    served: List[Served]
    trace: Optional[tracing.Trace] = None

    def in_window(self) -> List[Served]:
        t0, t1 = self.window
        return [s for s in self.served if t0 <= s.due < t1]


class _Control:
    """What the engine thread does at each step boundary: gate the route
    tap, start and stop the profiler, attach and detach the traced
    stretch's ranges."""

    def __init__(self, engine, route_tap, module_ranges):
        self.engine, self.route_tap = engine, route_tap
        self.module_ranges = module_ranges
        self.record_routes = False
        self.want = None            # "start" or "stop"
        self.changed = threading.Event()
        self.profiler = tracing.Profiler()
        self._patches: Optional[taps.Patches] = None
        #: the traced stretch is on: each step runs inside a range
        self.ranging = False

    def boundary(self) -> None:
        if self.route_tap is not None:
            self.route_tap.enabled = self.record_routes
        if self.want == "start":
            self.want = None
            self._attach()
            self.profiler.start()
            self.ranging = True
            self.changed.set()
        elif self.want == "stop":
            self.want = None
            self.profiler.stop()
            self.ranging = False
            self._patches.close()
            self.changed.set()

    def _attach(self) -> None:
        import importlib

        p = self._patches = taps.Patches()
        for module, name, label in self.module_ranges:
            p.wrap(importlib.import_module(module), name, taps.ranged(label))
        for name, label in ENGINE_RANGES:
            p.wrap(self.engine, name, taps.ranged(label))

    def ask(self, what: str, timeout: float) -> bool:
        self.changed.clear()
        self.want = what
        return self.changed.wait(timeout)


def _warm(engine, plan, cfg, seed: int) -> None:
    """Every prompt bucket the plan can reach (powers of two from its
    shortest prompt to its longest, and the longest itself) and full-batch
    decode windows of 64, 32 and 8 steps, driven through ``step`` on this
    thread."""
    from dstack_tpu_torch.serving.engine import Request

    lo = min(len(item["prompt"]) for item in plan)
    hi = max(len(item["prompt"]) for item in plan)
    sizes, n = [], lo
    while n < hi:
        sizes.append(n)
        n *= 2
    sizes.append(hi)
    sizes += [lo] * max(engine.batch_size - len(sizes), 0)
    gen = lengths.rng(seed, "warm")
    reqs = [Request(tokens=gen.integers(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=104) for n in sizes]
    for r in reqs:
        engine.submit(r)
    while not all(r.done.is_set() for r in reqs):
        engine.step()


def run(cell, seed: int, seconds: float, trace: bool, device,
        clock0: float) -> harness.Outcome:
    import torch

    from dstack_tpu_torch.serving.engine import Request
    from portbench import readers
    from portbench.reference import judge

    family = cell.family
    cfg = cell.model_config()
    mix, conf, kind = cell.traffic, cell.cell, cell.generator
    plan = kind.schedule(mix, conf, seed, seconds, cfg.vocab_size)
    params = family.program_params(cfg, seed, device)
    engine = family.engine(
        cfg, params, conf["engine"], device,
        harness.compile_cache() if device.type == "cuda" else None)
    _warm(engine, plan, cfg, seed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    route_tap = family.route_tap(cfg)
    patches = taps.Patches()
    if route_tap is not None:
        route_tap.install(patches)
    ctl = _Control(engine, route_tap, family.SERVE_RANGES + MODULE_RANGES)

    def make_step(step):
        from torch.profiler import record_function

        def wrapped():
            ctl.boundary()
            if ctl.ranging:
                with record_function("portbench.engine_step"):
                    step()
            else:
                step()
        return wrapped

    patches.wrap(engine, "step", make_step)
    setup_end = time.time()
    served: List[Served] = []
    lateness: List[float] = []
    stop = threading.Event()

    def submit(item, due: float) -> Served:
        s = Served(due=due, prompt=item["prompt"], max_new=item["max_new"])
        s.request = Request(tokens=s.prompt, max_new_tokens=s.max_new,
                            on_token=s.on_token)
        lateness.append(time.time() - due)
        served.append(s)
        engine.submit(s.request)
        return s

    ctl.record_routes = True
    loop = threading.Thread(target=engine.run_forever, name="engine",
                            daemon=True)
    loop.start()
    t0 = time.time() + float(mix["lead_in_s"])
    feeders = kind.feed(plan, mix, t0, stop, submit)
    for f in feeders:
        f.start()
    t1 = t0 + seconds
    while time.time() < t1:
        time.sleep(min(0.2, max(t1 - time.time(), 0)))
    notes = []
    kind.settle(mix, list(served), t0, t1)
    if trace and device.type == "cuda":
        if not ctl.ask("start", 60):
            notes.append("the traced stretch did not start")
        else:
            time.sleep(float(conf["trace_seconds"]))
            if not ctl.ask("stop", 300):
                notes.append("the traced stretch did not stop")
    stop.set()
    engine.stop()
    for f in feeders:
        f.join(30)
    loop.join(300)
    end = time.time()
    if device.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    patches.close()
    if lateness:
        notes.append(f"arrivals late by up to {max(lateness):.4f} s")
    tr = None
    if ctl.profiler.prof is not None and ctl.want is None:
        tr = ctl.profiler.trace()
    result = ServeRun(cfg=cfg, cell=cell,
                      setup_s=setup_end - clock0, window=(t0, t1), end=end,
                      served=list(served), trace=tr)
    notes.append("tails (not end-to-end metrics): ttft_p90_ms "
                 f"{readers.ttft_ms(result, 90)}, tpot_p90_ms "
                 f"{readers.tpot_ms(result, 90)}")
    window_reqs, failed = kind.account(result)
    sample = judge.pick(served, seed, conf["check"])
    calls = route_tap.calls if route_tap is not None else []
    del engine, params, ctl, loop, feeders
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = judge.served(family, cfg, seed, sample, calls, device)
    limits = conf.get("limits", {})
    checks = harness.checks(numbers, limits, notes)
    notes.append(f"checked {len(sample)} requests, "
                 f"{sum(len(s.request.output) for s in sample)} served tokens")
    return harness.Outcome(run=result, checks=checks,
                           attempted=len(window_reqs), failed=failed,
                           memory_peak_bytes=peak, trace=tr, notes=notes,
                           compared=sample, readings=numbers)
