"""The port's spans (``dstack_tpu_torch/telemetry/spans.py``) on tiny train
steps on the CPU: under ``torch.profiler`` every model layer's span shows,
each backward node runs inside the span its forward op ran in (remat's
recompute included), and the views' backward, one ``stack`` a stacked
leaf, runs inside ``model.views``; with the profiler off the graph holds
no marker and the step is bit for bit the profiled one.

On the CPU autograd runs the backward on the calling thread; on a card
it runs on a device thread of its own, which the markers name the same
way (the benchmark's traced runs read it there)."""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dstack_tpu_torch.models import llama, moe, train
from dstack_tpu_torch.telemetry import spans

DENSE = {"model.embed", "model.views", "model.attention", "model.mlp",
         "model.head_loss", "train.forward", "train.backward",
         "train.optimizer"}
MOE = DENSE | {"model.moe.route", "model.moe.dispatch", "model.moe.experts",
               "model.moe.combine"}
MARKERS = {"_OpenBackward", "_CloseBackward"}
EVALUATE = "autograd::engine::evaluate_function: "
CASES = [("dense", False), ("dense", True), ("dense", "full"),
         ("moe", False), ("moe", True)]


def _trainer(kind, remat):
    opt = train.default_optimizer()
    if kind == "dense":
        cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
        state = train.create_state(0, cfg, opt, device="cpu")
        step = train.make_train_step(cfg, opt, remat=remat)
    else:
        cfg = moe.MoEConfig.tiny_moe(dtype=torch.float32)
        state = moe.create_state(0, cfg, opt, device="cpu")
        step = moe.make_train_step(cfg, opt, remat=remat)
    tokens = torch.randint(0, cfg.vocab_size, (2, 33),
                           generator=torch.Generator().manual_seed(1))
    return cfg, state, step, {"tokens": tokens}


def _program_spans(events):
    return [e for e in events
            if e.name.startswith("model.") or e.name == "train.optimizer"]


def _innermost(spans_, e):
    """The name of the innermost program span holding event ``e`` whole,
    on its thread."""
    best = None
    for s in spans_:
        if (s.thread == e.thread and s.time_range.start <= e.time_range.start
                and e.time_range.end <= s.time_range.end
                and (best is None
                     or s.time_range.start > best.time_range.start)):
            best = s
    return best.name if best is not None else None


@pytest.mark.parametrize("kind,remat", CASES)
def test_backward_runs_inside_its_regions_span(kind, remat):
    cfg, state, step, batch = _trainer(kind, remat)
    step(state, batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    events = list(prof.events())
    names = {e.name for e in events}
    assert (MOE if kind == "moe" else DENSE) <= names
    spans_ = _program_spans(events)

    # each node's backward runs in the span its forward op ran in
    made = {e.sequence_nr: e for e in events if e.sequence_nr >= 0
            and not e.name.startswith("autograd::")}
    checked = collections.Counter()
    for e in events:
        if not e.name.startswith(EVALUATE):
            continue
        node = e.name[len(EVALUATE):]
        fwd = made.get(e.sequence_nr)
        if node in MARKERS or fwd is None:
            continue
        want = _innermost(spans_, fwd)
        if want is None:
            continue
        assert _innermost(spans_, e) == want, (node, want)
        checked[want] += 1
    regions = {"model.embed", "model.views", "model.attention", "model.mlp",
               "model.head_loss"}
    if kind == "moe":
        regions |= {"model.moe.route", "model.moe.dispatch",
                    "model.moe.experts", "model.moe.combine"}
    assert set(checked) == regions, checked

    # the views' backward: one stack a stacked leaf, and no select's
    # backward or add of whole stacks
    in_views = collections.Counter(
        e.name for e in events if _innermost(spans_, e) == "model.views")
    assert in_views["aten::stack"] == len(state.params["layers"])
    assert not (in_views["aten::select_backward"] + in_views["aten::add"]
                + in_views["aten::add_"]), in_views


def _graph_nodes(root):
    seen, todo, out = set(), [root], collections.Counter()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        out[type(fn).__name__] += 1
        todo.extend(f for f, _ in fn.next_functions)
    return out


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_without_the_profiler_no_marker_and_the_same_step(kind,
                                                          monkeypatch):
    grad = torch.autograd.grad
    seen = []

    def spy(outputs, inputs, *args, **kwargs):
        out = grad(outputs, inputs, *args, **kwargs)
        seen.append((outputs.detach().clone(), _graph_nodes(outputs.grad_fn),
                     [g.clone() for g in out]))
        return out

    monkeypatch.setattr(torch.autograd, "grad", spy)
    results = []
    for profiled in (False, True):
        _cfg, state, step, batch = _trainer(kind, True)
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                step(state, batch)
        else:
            step(state, batch)
        results.append([p.detach().clone()
                        for p in llama.tree_leaves(state.params)])
    (loss_off, nodes_off, grads_off), (loss_on, nodes_on, grads_on) = seen
    assert not MARKERS & set(nodes_off)
    assert MARKERS <= set(nodes_on)
    assert sum(nodes_on.values()) > sum(nodes_off.values())
    assert torch.equal(loss_off, loss_on)
    assert all(torch.equal(a, b) for a, b in zip(grads_off, grads_on))
    assert all(torch.equal(a, b) for a, b in zip(*results))


def test_off_the_helpers_pass_everything_through():
    x = torch.ones(3, requires_grad=True)
    tree = {"x": x, "n": 1}
    with spans.region("model.anything") as r:
        assert r.inputs(tree) is tree
        assert r.outputs(x) is x
    with spans.span("train.anything"):
        y = x * 2
    assert type(y.grad_fn).__name__ == "MulBackward0"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("train.anything"):
            pass
        with spans.region("model.anything") as r:
            marked = r.inputs(tree)
            out = r.outputs(marked["x"] * 2)
        out.sum().backward()
    assert marked["n"] == 1 and marked["x"] is not x
    assert torch.equal(x.grad, torch.full((3,), 2.0))
    got = collections.Counter(e.name for e in prof.events())
    # the forward's range and the backward's
    assert got["model.anything"] == 2 and got["train.anything"] == 1
