"""Kanana-2 (``deepseek_v3``) trained through the port against the float32
plain reference (``tests/deepseek_reference.py``), on the CPU at a tiny
size (QK width 24, V width 16, one dense layer and three routed ones).

The port runs in float32 here (``dtype=torch.float32``), so the two sides
differ by the order of their sums alone: the port's flash plain versions
mask with -1e30 and take one softmax pass, its RoPE turns interleaved
pairs where the reference permutes them to split halves (the same
scores), its combine adds the experts' rows in float32 by index.  Seeds
whose routing would tip on that rounding are refused by the test itself
(``MARGIN`` 1e-5, as Trinity's tests refuse them: ten times the widest
difference of a score the two sides' float32 rounding gives at this
size): each token's k-th and (k+1)-th score plus bias must differ by
more than it.

Tolerances (all relative to the largest magnitude of what is compared):
- ``FWD_RTOL`` 1e-5 on logits and the loss: three routed layers of f32
  products summed in another order;
- ``GRAD_RTOL`` 1e-4 on every gradient leaf: the backward sums the
  forward's differences again, through the attention's recomputed
  probabilities, the latent's norm and the router's sigmoid;
- ``PARAM_ATOL`` 2 * lr after one AdamW step, with all but a few elements
  within 1e-6 (Adam's first step moves each element by lr times the sign
  of its gradient, so an element whose gradient is rounding noise may go
  either way); the expert bias exactly (a sign of counts that both sides
  count alike).
"""

import dataclasses

import numpy as np
import pytest
import torch

from dstack_tpu_torch.models import deepseek, llama, train
from tests import afmoe_reference
from tests import deepseek_reference as ref

torch.set_num_threads(2)

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
MARGIN = 1e-5
LR = 3e-4
PARAM_ATOL = 2 * LR
CLOSE_ATOL, CLOSE_SHARE = 1e-6, 0.999


def _cfg(**kw):
    return deepseek.DeepseekV3Config.tiny(dtype=torch.float32, **kw)


def _state(cfg, seed=0):
    st = deepseek.create_state(seed, cfg, train.default_optimizer(lr=LR),
                               device="cpu")
    # a bias already moved, so the routing reads it
    gen = torch.Generator().manual_seed(seed + 1)
    st.buffers["expert_bias"].copy_(0.01 * torch.randn(
        st.buffers["expert_bias"].shape, generator=gen))
    # norm weights away from one, so a dropped norm shows
    for stack in deepseek.STACKS:
        for name in ("attn_norm", "kv_norm", "mlp_norm"):
            w = st.params[stack][name]
            w.data.add_(0.1 * torch.randn(w.shape, generator=gen))
    return st


def _tokens(cfg, batch, seq, seed=0):
    gen = torch.Generator().manual_seed(100 + seed)
    return torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen)


def _ref_tree(params, cfg):
    """The port's stacked tree as the reference's: global leaves and a
    list of per-layer dicts, detached copies."""
    out = {k: v.detach().clone() for k, v in params.items()
           if k not in deepseek.STACKS}
    layers = []
    for stack, n in (("dense_layers", cfg.num_dense_layers),
                     ("moe_layers", cfg.num_moe_layers)):
        for i in range(n):
            layers.append({k: v[i].detach().clone()
                           for k, v in params[stack].items()})
    out["layers"] = layers
    return out


def _biases(st):
    return list(st.buffers["expert_bias"].clone().unbind(0))


def _check_margin(tree, tokens, cfg, biases):
    """Every routed choice is decided by more than ``MARGIN``."""
    seen = []
    real = afmoe_reference.route

    def spy(h, router, bias, k, scale):
        out = real(h, router, bias, k, scale)
        ranked = torch.sort(out[2] + bias, -1, descending=True).values
        seen.append(float((ranked[:, k - 1] - ranked[:, k]).min()))
        return out

    afmoe_reference.route = spy
    try:
        with torch.no_grad():
            ref.forward(tree, tokens[:, :-1], cfg, biases)
    finally:
        afmoe_reference.route = real
    assert seen and min(seen) > MARGIN, seen


def _close(got, want, rtol, what):
    scale = max(float(want.abs().max()), 1e-12)
    err = float((got - want).abs().max())
    assert err <= rtol * scale, (what, err, scale)


def _grads(st, cfg, tokens, remat, stats=None):
    leaves = llama.tree_leaves(st.params)
    x = deepseek.backbone(st.params, tokens[:, :-1], cfg, buffers=st.buffers,
                          remat=remat, stats=stats)
    loss = torch.nn.functional.cross_entropy(
        (x @ llama.output_head(st.params, cfg)).reshape(-1, cfg.vocab_size),
        tokens[:, 1:].reshape(-1))
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


@pytest.mark.parametrize("seq", [128, 48], ids=["flash-route", "plain"])
def test_forward_loss_and_gradients_match_reference(seq):
    """Logits, the loss and every gradient at seq 128 (the flash plain
    versions at QK width 24, V width 16) and 48 (``causal_attention``),
    with a capacity that drops choices."""
    cfg = _cfg(capacity_factor=0.75)
    st = _state(cfg)
    tokens = _tokens(cfg, 2, seq)
    tree, biases = _ref_tree(st.params, cfg), _biases(st)
    _check_margin(tree, tokens, cfg, biases)

    with torch.no_grad():
        got = deepseek.forward(st.params, tokens[:, :-1], cfg,
                               buffers=st.buffers)
        want, _ = ref.forward(tree, tokens[:, :-1], cfg, biases)
    _close(got, want, FWD_RTOL, "logits")

    want_loss, want_grads, want_counts = ref.loss_and_grads(
        tree, tokens, cfg, biases)
    stats = []
    loss, grads = _grads(st, cfg, tokens, True, stats)
    _close(loss, want_loss, FWD_RTOL, "loss")
    by_id = {id(p): g for p, g in zip(llama.tree_leaves(st.params), grads)}
    got_tree = _ref_tree(llama.tree_map(lambda p: by_id[id(p)], st.params),
                         cfg)
    for l, (gl, wl) in enumerate(zip(got_tree["layers"],
                                     want_grads["layers"])):
        assert set(gl) == set(wl)
        for name in wl:
            _close(gl[name], wl[name], GRAD_RTOL, f"{name}.{l}")
    for key in ("embed", "final_norm", "lm_head"):
        _close(got_tree[key], want_grads[key], GRAD_RTOL, key)
    assert torch.equal(torch.stack([c for c, _ in stats]), want_counts)
    assert float(sum(d for _, d in stats)) > 0  # the capacity drops


def test_one_step_and_the_expert_bias_match_reference():
    """One train step of ``make_train_step``: the parameters after AdamW
    within ``PARAM_ATOL`` (all but a few within ``CLOSE_ATOL``), the
    step's loss, the expert bias moved exactly as the rule moves it, and
    the expert counts it returns."""
    cfg = _cfg()
    st = _state(cfg, seed=3)
    tokens = _tokens(cfg, 2, 128, seed=3)
    tree, biases = _ref_tree(st.params, cfg), _biases(st)
    _check_margin(tree, tokens, cfg, biases)
    loss, grads, counts = ref.loss_and_grads(tree, tokens, cfg, biases)
    zeros = llama.tree_map(torch.zeros_like, tree)
    opt = train.default_optimizer(lr=LR)
    want, _, _ = ref.adamw(tree, grads, zeros, zeros, 1, opt.lr,
                           opt.weight_decay, opt.grad_clip, opt.b1, opt.b2,
                           opt.eps)
    want_bias = torch.stack([ref.bias_update(b, c, cfg.bias_update_rate)
                             for b, c in zip(biases, counts)])

    st, metrics = deepseek.make_train_step(cfg, opt)(st, {"tokens": tokens})
    assert metrics["step"] == 1
    _close(metrics["loss"], loss, FWD_RTOL, "loss")
    assert torch.equal(metrics["expert_tokens"], counts)
    assert torch.equal(st.buffers["expert_bias"], want_bias)
    got = _ref_tree(st.params, cfg)
    diff = np.concatenate([(g - w).abs().reshape(-1).numpy() for g, w in
                           zip(ref._leaves(got), ref._leaves(want))])
    assert diff.max() <= PARAM_ATOL, diff.max()
    assert np.mean(diff <= CLOSE_ATOL) >= CLOSE_SHARE


def test_held_experts_match_the_reference_share():
    """A layer that holds experts [2, 6) of 8 (one card's share): routing
    over all 8, the held experts' part added, against the reference's
    share."""
    full = _cfg()
    cfg = dataclasses.replace(full, held_experts=(2, 6))
    st_full = _state(full, seed=4)
    params = dict(st_full.params)
    params["moe_layers"] = {
        k: (v[:, 2:6].clone() if k in ("w_gate", "w_up", "w_down") else v)
        for k, v in st_full.params["moe_layers"].items()}
    tokens = _tokens(cfg, 2, 128, seed=4)
    tree, biases = _ref_tree(params, cfg), _biases(st_full)
    _check_margin(tree, tokens, cfg, biases)
    with torch.no_grad():
        got = deepseek.forward(params, tokens[:, :-1], cfg,
                               buffers=st_full.buffers)
        want, _ = ref.forward(tree, tokens[:, :-1], cfg, biases)
    _close(got, want, FWD_RTOL, "logits")


@pytest.mark.parametrize("remat", ["none", "full", "wide"])
def test_remat_modes_give_the_default_gradients(remat):
    """Every remat mode recomputes what the default (selective) keeps:
    the same loss and gradients within float32 round-off."""
    cfg = _cfg()
    tokens = _tokens(cfg, 2, 128, seed=7)
    want_loss, want = _grads(_state(cfg, seed=7), cfg, tokens, True)
    got_loss, got = _grads(_state(cfg, seed=7), cfg, tokens, remat)
    _close(got_loss, want_loss, FWD_RTOL, "loss")
    for g, w in zip(got, want):
        _close(g, w, GRAD_RTOL, remat)


def test_bf16_step_stays_near_the_reference():
    """The configuration's own dtype, bf16, against the float32
    reference: the first loss within 2e-2 relative (bf16 keeps 8 bits
    of mantissa through three routed layers and a 512-way softmax)."""
    cfg = deepseek.DeepseekV3Config.tiny()
    st = deepseek.create_state(11, cfg, train.default_optimizer(),
                               device="cpu")
    tokens = _tokens(cfg, 2, 128, seed=11)
    tree = llama.tree_map(lambda t: t.float(), _ref_tree(st.params, cfg))
    with torch.no_grad():
        want, _ = ref.forward(tree, tokens[:, :-1], cfg, _biases(st))
    want_loss = torch.nn.functional.cross_entropy(
        want.reshape(-1, cfg.vocab_size), tokens[:, 1:].reshape(-1))
    _, metrics = deepseek.make_train_step(cfg, train.default_optimizer())(
        st, {"tokens": tokens})
    assert abs(float(metrics["loss"]) - float(want_loss)) \
        <= 2e-2 * float(want_loss)
