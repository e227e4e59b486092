"""The stacked layer weights' views (``llama.layer_views``) on tiny dense
and MoE models on the CPU: the gradients of the stacked leaves are
bitwise those of per-layer ``w[l]`` selects, and the views' backward
writes each leaf's stacked gradient with one ``stack``, at every depth:
no stack-wide fill, select backward or add per layer."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dstack_tpu_torch.models import llama, moe
from dstack_tpu_torch.ops.loss import chunked_cross_entropy

# the ops of a ``w[l]`` select's backward and of the adds that sum them,
# found by a whole [L, ...] stack among their inputs
STACK_WIDE = {"aten::add", "aten::add_", "aten::fill_", "aten::zero_",
              "aten::copy_"}


def _model(kind, num_layers):
    if kind == "dense":
        cfg = dataclasses.replace(llama.LlamaConfig.tiny(
            dtype=torch.float32), num_layers=num_layers)
        params = llama.init_params(cfg, "cpu",
                                   torch.Generator().manual_seed(0))
    else:
        cfg = dataclasses.replace(moe.MoEConfig.tiny_moe(
            dtype=torch.float32), num_layers=num_layers)
        params = moe.init_params(cfg, "cpu",
                                 torch.Generator().manual_seed(0))
    for p in llama.tree_leaves(params):
        p.requires_grad_(True)
    return cfg, params


def _loss(kind, cfg, params, tokens):
    if kind == "dense":
        x, aux = llama.backbone(params, tokens[:, :-1], cfg, remat=True), 0
    else:
        x, aux = moe.backbone(params, tokens[:, :-1], cfg, remat=True)
        aux = cfg.router_aux_weight * aux
    return chunked_cross_entropy(x, llama.output_head(params, cfg),
                                 tokens[:, 1:]) + aux


def _selects(layers, num_layers):
    """The views as ``w[l]`` selects, each backward a whole-stack fill."""
    return [llama.tree_map(lambda w: w[l], layers) for l in range(num_layers)]


@pytest.mark.parametrize("num_layers", [2, 4])
@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_views_give_the_selects_gradients_with_one_stack_a_leaf(
        kind, num_layers, monkeypatch):
    cfg, params = _model(kind, num_layers)
    stacks = llama.tree_leaves(params["layers"])
    tokens = torch.randint(0, cfg.vocab_size, (2, 33),
                           generator=torch.Generator().manual_seed(1))

    value = _loss(kind, cfg, params, tokens)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        grads = torch.autograd.grad(value, stacks)
    with monkeypatch.context() as m:
        m.setattr(llama, "layer_views", _selects)
        want = torch.autograd.grad(_loss(kind, cfg, params, tokens), stacks)

    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    stacked = [list(w.shape) for w in stacks]
    per_layer = [list(w.shape[1:]) for w in stacks]
    events = list(prof.events())
    assert sum(e.name == "aten::stack" for e in events) == len(stacks)
    wide = [e.name for e in events
            if e.name in STACK_WIDE
            and any(s in stacked for s in e.input_shapes)
            or e.name == "aten::select_backward"
            and e.input_shapes[0] in per_layer]
    assert not wide, wide
