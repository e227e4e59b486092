"""Device time under the program's spans on a hand-made trace: the forward's
spans on the main thread, the backward's and remat's recompute on
autograd's device thread, where the recompute's spans open inside the
backward's (a name inside itself too); a kernel belongs to the innermost
program span open where it was launched."""

import types

import pytest

from portbench import program_spans, tracing

MAIN, AUTOGRAD = 1, 2
#: program spans: (thread, name, start, end)
SPANS = [
    (MAIN, "model.attention", 10, 20),
    (MAIN, "model.moe.route", 20, 30),
    (MAIN, "model.moe.experts", 30, 40),
    (MAIN, "model.moe.combine", 40, 50),
    (AUTOGRAD, "model.moe.combine", 100, 200),
    (AUTOGRAD, "model.moe.route", 110, 120),
    (AUTOGRAD, "model.moe.experts", 120, 140),
    (AUTOGRAD, "model.moe.combine", 140, 150),
    (AUTOGRAD, "model.views", 300, 400),
    (MAIN, "train.optimizer", 900, 950),
]
#: kernels: (launching thread, launch time, device microseconds)
KERNELS = [
    (MAIN, 15, 10),        # attention
    (MAIN, 25, 5),         # route
    (MAIN, 35, 20),        # experts
    (MAIN, 45, 5),         # combine
    (AUTOGRAD, 105, 10),   # combine's backward
    (AUTOGRAD, 115, 3),    # the recompute's route
    (AUTOGRAD, 125, 30),   # the recompute's experts
    (AUTOGRAD, 145, 2),    # the recompute's combine
    (AUTOGRAD, 160, 10),   # combine's backward, after the recompute
    (AUTOGRAD, 350, 15),   # the views' backward
    (MAIN, 920, 5),        # the optimizer
    (AUTOGRAD, 500, 5),    # under no span
    (MAIN, 150, 5),        # under no span (the main thread waits)
]
BUSY = sum(dur for _, _, dur in KERNELS)


def _events(spans, kernels=KERNELS):
    events = [{"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW,
               "ts": 0, "dur": 1000, "tid": MAIN}]
    events += [{"ph": "X", "cat": "user_annotation", "name": name, "ts": a,
                "dur": b - a, "tid": tid} for tid, name, a, b in spans]
    t = 0
    for corr, (tid, at, dur) in enumerate(kernels):
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": at, "dur": 1,
                       "tid": tid, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": f"k{corr}",
                       "ts": t, "dur": dur, "args": {"correlation": corr}})
        t += dur
    return events


#: the spans of the layers whose shares a reader would take
VIEWS = ("model.views",)
MOE = ("model.moe.route", "model.moe.dispatch", "model.moe.experts",
       "model.moe.combine")
ROUTING = ("model.moe.route", "model.moe.dispatch", "model.moe.combine")
OPTIMIZER = ("train.optimizer",)


def _share(names, trace):
    return program_spans.share(types.SimpleNamespace(trace=trace), names)


def test_layer_shares_of_spans_on_two_threads():
    trace = tracing.Trace(_events(SPANS))
    assert trace.busy_s == pytest.approx(BUSY / 1e6)
    assert _share(VIEWS, trace) == pytest.approx(
        100 * 15 / BUSY)
    assert _share(MOE, trace) == pytest.approx(
        100 * (8 + 50 + 27) / BUSY)
    assert _share(ROUTING, trace) == pytest.approx(
        100 * (8 + 27) / BUSY)
    assert _share(OPTIMIZER, trace) == pytest.approx(
        100 * 5 / BUSY)
    by = program_spans.device_s_by_span(trace)
    assert by[None] == pytest.approx(10 / 1e6)
    assert by["model.attention"] == pytest.approx(10 / 1e6)
    # the recompute's combine nests in the backward's: the kernel after
    # it, which Trace.device_s misses, is the backward's
    assert trace.device_s("model.moe.combine") == pytest.approx(
        (5 + 10 + 3 + 30 + 2) / 1e6)
    assert by["model.moe.combine"] == pytest.approx((5 + 10 + 2 + 10) / 1e6)


def test_a_program_without_the_spans_gives_nothing_to_read():
    parent = [s for s in SPANS if not s[1].startswith("model.")]
    trace = tracing.Trace(_events(parent))
    for names in (VIEWS, MOE, ROUTING):
        assert _share(names, trace) is None
    assert _share(OPTIMIZER, trace) == pytest.approx(
        100 * 5 / BUSY)
    for names in (VIEWS, OPTIMIZER):
        assert _share(names, None) is None
