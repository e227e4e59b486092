"""The cheap cases of Trinity's (``afmoe``) slice, no JAX: the windowed
attention's plain versions against an explicit mask, the index dispatch
and combine against the one-hot ``[T, E, C]`` products they replace, the
share test of the held experts, the sigmoid routing and the expert bias's
rule.

Tolerances (stated where used):
- windowed plain attention in float32 against autograd through an
  explicit mask: 2e-6 of the largest output and gradient (one softmax
  pass against two, -1e30 against -inf);
- the index dispatch EQUAL to the one-hot product in bf16 (a one-hot
  product copies each row exactly); its backward and the combine within
  ``BF16_RTOL`` = 2^-8 of the largest value (float32 sums in another
  order, each rounded once to bf16: at most one bf16 ulp apart);
- the share test 1e-5 of the largest output (float32 sums of the
  experts' parts in another order).
"""

import dataclasses
import math

import pytest
import torch

from dstack_tpu_torch.models import afmoe, moe
from dstack_tpu_torch.ops import flash_attention as fa
from dstack_tpu_torch.ops.attention import causal_attention
from tests import afmoe_reference as ref

BF16_RTOL = 2.0 ** -8


def _qkv(seed, b=2, s=128, hq=4, hkv=2, d=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, s, h, d, generator=g).to(dtype)
            for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("window", [1, 37, 64, 127])
def test_windowed_plain_attention_matches_an_explicit_mask(window):
    """The plain versions the kernels are held to, forward and backward,
    against autograd through the reference's masked softmax."""
    q, k, v = _qkv(window)
    do = torch.randn_like(q)
    o, lse = fa.flash_attention_fwd_plain(q, k, v, window=window)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                              window=window)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = ref.attention(*leaves, window)
    wq, wk, wv = torch.autograd.grad(want, leaves, do)
    assert (o - want).abs().max() <= 2e-6 * want.abs().max()
    # at window 1 dq and dk are 0 (p = 1): gradients against the largest
    grad_scale = max(float(g.abs().max()) for g in (wq, wk, wv))
    for got, exp in ((dq, wq), (dk, wk), (dv, wv)):
        assert (got - exp).abs().max() <= 2e-6 * grad_scale


@pytest.mark.parametrize("window", [128, 129, 4096])
def test_a_window_that_covers_the_sequence_is_causal(window):
    q, k, v = _qkv(7)
    do = torch.randn_like(q)
    o, lse = fa.flash_attention_fwd_plain(q, k, v, window=window)
    want_o, want_lse = fa.flash_attention_fwd_plain(q, k, v)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    got = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, window=window)
    for g, w in zip(got, fa.flash_attention_bwd_plain(q, k, v, o, lse, do)):
        assert torch.equal(g, w)
    assert fa._window(window, 128) is None


def test_causal_attention_takes_the_window_as_the_fused_route_does():
    q, k, v = _qkv(9, s=64)
    got = causal_attention(q, k, v, window=20)
    want = fa.flash_attention(q, k, v, window=20)
    assert (got - want).abs().max() <= 2e-6 * want.abs().max()


def _one_hot(route, e, cap):
    """The reference's (dispatch, combine) [T, E, C] of a routing."""
    t = route.expert.shape[0]
    dispatch, combine = torch.zeros(t, e, cap), torch.zeros(t, e, cap)
    rows, j = route.kept.nonzero(as_tuple=True)
    at = (rows, route.expert[rows, j], route.slot[rows, j])
    dispatch[at] = 1.0
    combine = combine.index_put(at, route.gate[rows, j])
    return dispatch, combine


@pytest.mark.parametrize("capacity_factor", [0.75, 1.25])
def test_index_dispatch_and_combine_match_the_one_hot_products(
        capacity_factor):
    """At the tiny Mixtral config in bf16: the experts' input equal to the
    one-hot dispatch product, the combined output and both backwards (the
    tokens' and the gates') within ``BF16_RTOL``."""
    cfg = dataclasses.replace(moe.MoEConfig.tiny_moe(),
                              capacity_factor=capacity_factor)
    g = torch.Generator().manual_seed(4)
    t, d, e, k = 96, cfg.hidden_size, cfg.num_experts, cfg.experts_per_token
    x = torch.randn(t, d, generator=g).to(torch.bfloat16)
    cap = max(int(math.ceil(t * k / e * capacity_factor)), 1)
    logits = torch.randn(t, e, generator=g, requires_grad=True)
    route = moe._route(logits, k, cap)
    assert not bool(route.kept.all()) or capacity_factor > 1
    token, valid, gate = moe._slots(route, 0, e, cap)
    dispatch, combine = _one_hot(route, e, cap)

    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    got_in = moe._GatherRows.apply(xs[0], token, valid).view(e, cap, d)
    want_in = torch.einsum("tec,td->ecd", dispatch.to(cfg.dtype), xs[1])
    assert torch.equal(got_in, want_in)

    y = torch.randn(e, cap, d, generator=g).to(cfg.dtype)
    ys = [y.clone().requires_grad_(True) for _ in range(2)]
    got = moe._Combine.apply(ys[0].reshape(-1, d), gate.to(cfg.dtype),
                             token, valid, t)
    want = torch.einsum("tec,ecd->td", combine.to(cfg.dtype), ys[1])
    assert (got.float() - want.float()).abs().max() \
        <= BF16_RTOL * want.float().abs().max()

    dout = torch.randn(t, d, generator=g).to(cfg.dtype)
    gx_got, = torch.autograd.grad(got_in, xs[0], torch.ones_like(got_in))
    gx_want, = torch.autograd.grad(want_in, xs[1], torch.ones_like(want_in))
    # both combines read the one routing's gates
    gy_got, gl_got = torch.autograd.grad(got, (ys[0], logits), dout,
                                         retain_graph=True)
    assert (gx_got.float() - gx_want.float()).abs().max() \
        <= BF16_RTOL * gx_want.float().abs().max()
    gy_want, gl_want = torch.autograd.grad(want, (ys[1], logits), dout)
    for a, b in ((gy_got, gy_want), (gl_got, gl_want)):
        assert (a.float() - b.float()).abs().max() \
            <= BF16_RTOL * b.float().abs().max()


def test_the_held_experts_shares_add_up_to_the_whole_layer():
    """Eight cards of two experts each (of 16, top 4, a shared expert):
    each routes over all 16 and adds its experts' part; the parts summed,
    with the shared expert (which every card computes alike) counted
    once, give the uncut reference layer, and each card's port layer
    gives the reference's part."""
    cfg = afmoe.AfmoeConfig.tiny(num_experts=16, experts_per_token=4,
                                 dtype=torch.float32)
    g = torch.Generator().manual_seed(2)
    shapes = afmoe.leaf_shapes(cfg, dense=False)
    w = {name: torch.randn(shape, generator=g) * (fan ** -0.5 if fan else
                                                  0.1)
         for name, (shape, fan, _) in shapes.items()}
    h = torch.randn(2 * 64, cfg.hidden_size, generator=g)
    bias = 0.01 * torch.randn(cfg.num_experts, generator=g)
    whole, _ = ref.moe(h, w, cfg, bias)
    shared = ref.swiglu(h, w["shared_gate"], w["shared_up"],
                        w["shared_down"])
    parts = torch.zeros_like(h)
    for i in range(8):
        held = (2 * i, 2 * i + 2)
        cut = dict(w, **{n: w[n][held[0]:held[1]]
                         for n in ("w_gate", "w_up", "w_down")})
        want, _ = ref.moe(h, cut, cfg, bias, held=held, shared=False)
        parts = parts + want
        got, _ = moe._moe_mlp(
            h[None], dict(cut, expert_bias=bias),
            dataclasses.replace(cfg, held_experts=held))
        assert (got[0] - shared - want).abs().max() \
            <= 1e-5 * want.abs().max()
    assert (parts + shared - whole).abs().max() <= 1e-5 * whole.abs().max()


def test_sigmoid_routing_chooses_by_score_plus_bias():
    """Scores are sigmoids; the bias decides the choice but not the gate;
    the gates are the chosen scores over their sum, times the scale; the
    counts are before the capacity."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0], [0.0, 0.0, 3.0, 0.5]])
    bias = torch.tensor([0.0, 0.0, 0.0, 0.6])
    r = moe._route(logits, 2, 1, score="sigmoid", bias=bias, scale=2.5)
    s = torch.sigmoid(logits)
    # the bias lifts expert 3 over expert 1 for token 0
    assert r.expert.tolist() == [[0, 3], [3, 2]]
    want = torch.stack([s[0, [0, 3]], s[1, [3, 2]]])
    want = want / (want.sum(-1, keepdim=True) + 1e-20) * 2.5
    assert torch.allclose(r.gate, want, rtol=1e-6)
    assert r.counts.tolist() == [1.0, 0.0, 1.0, 2.0]
    assert float(r.aux) == 0.0
    # one slot an expert, taken choice-major: token 1's first choice of
    # expert 3 comes before token 0's second
    assert r.kept.tolist() == [[True, False], [True, True]]


def test_expert_bias_rule():
    """Raised where an expert was chosen less than the mean, lowered where
    more, the move's mean taken off (torchtitan's rule)."""
    bias = torch.zeros(2, 4)
    counts = torch.tensor([[4.0, 0.0, 2.0, 2.0], [1.0, 1.0, 1.0, 5.0]])
    afmoe.update_expert_bias(bias, counts, 0.001)
    delta = 0.001 * torch.tensor([[-1.0, 1.0, 0.0, 0.0],
                                  [1.0, 1.0, 1.0, -1.0]])
    assert torch.allclose(bias, delta - delta.mean(-1, keepdim=True))
    assert torch.allclose(bias.sum(-1), torch.zeros(2), atol=1e-9)


def test_config_checks_its_layer_kinds():
    with pytest.raises(ValueError, match="layer_types"):
        afmoe.AfmoeConfig.tiny(layer_types=("sliding_attention",) * 3)
    with pytest.raises(ValueError, match="layer_types"):
        afmoe.AfmoeConfig.tiny(layer_types=("sliding_attention",) * 3
                               + ("linear_attention",))


def test_the_train_step_names_the_shared_expert_span(monkeypatch):
    """``model.moe.shared`` wraps the shared expert, beside the routed
    MLP's four spans."""
    from dstack_tpu_torch.telemetry import spans

    seen = []
    real = spans.region

    def spy(name):
        seen.append(name)
        return real(name)

    monkeypatch.setattr(spans, "region", spy)
    cfg = afmoe.AfmoeConfig.tiny(dtype=torch.float32)
    st = afmoe.create_state(0, cfg, afmoe.train.default_optimizer(),
                            device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 49))
    afmoe.make_train_step(cfg, afmoe.train.default_optimizer())(
        st, {"tokens": tokens})
    assert {"model.moe.route", "model.moe.dispatch", "model.moe.experts",
            "model.moe.combine", "model.moe.shared", "model.attention",
            "model.mlp", "model.views", "model.embed",
            "model.head_loss"} <= set(seen)


def test_a_snapshot_keeps_the_expert_bias(tmp_path):
    """The expert bias is saved and restored with the params and AdamW's
    moments, bitwise, and the restored state's next step is the
    original's; a template without the bias refuses the snapshot."""
    from dstack_tpu_torch.models import checkpoint as ckpt
    from dstack_tpu_torch.models import train

    cfg = afmoe.AfmoeConfig.tiny(dtype=torch.float32)
    opt = train.default_optimizer(lr=1e-3)
    st = afmoe.create_state(0, cfg, opt, device="cpu")
    step = afmoe.make_train_step(cfg, opt, remat=False)
    gen = torch.Generator().manual_seed(3)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (2, 33),
                                        generator=gen)} for _ in range(3)]
    for batch in batches[:2]:
        st, _ = step(st, batch)
    assert st.buffers["expert_bias"].abs().sum() > 0
    ckpt.save_train_state(tmp_path / "c", st)
    restored = ckpt.restore_train_state(
        tmp_path / "c", afmoe.state_template(cfg, opt), device="cpu")
    leaves = [(ckpt.state_leaves(s)) for s in (restored, st)]
    assert [p for p, _ in leaves[0]] == [p for p, _ in leaves[1]]
    assert leaves[0][-1][0] == ".buffers['expert_bias']"
    for (path, a), (_, b) in zip(*leaves):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    _, want = step(st, batches[2])
    _, got = step(restored, batches[2])
    assert got["loss"].item() == want["loss"].item()
    assert torch.equal(restored.buffers["expert_bias"],
                       st.buffers["expert_bias"])
    bare = dataclasses.replace(afmoe.state_template(cfg, opt), buffers=None)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_train_state(tmp_path / "c", bare, device="cpu")


def test_the_smokes_trinity_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.afmoe_phase`` at the tiny config: the loss falls and
    the bias moves with a zero mean, so no check fails (the launch counts
    are the card's alone); its config at the cut is the benchmark cell's
    shape."""
    import chip_smoke

    failed = []
    monkeypatch.setattr(chip_smoke, "fail", failed.append)
    out = chip_smoke.afmoe_phase(
        torch, cfg=afmoe.AfmoeConfig.tiny(dtype=torch.float32),
        device="cpu", batch=2, seq=64, steps=3)
    assert not failed and out["losses"][-1] < out["losses"][0]
    cut = afmoe.AfmoeConfig.trinity_mini(**chip_smoke.AFMOE_CUT)
    assert cut.layer_types == ("sliding_attention",) * 3 + (
        "full_attention",) + ("sliding_attention",) * 3 + ("full_attention",)
    assert (cut.num_experts, cut.held_experts, cut.num_moe_layers) == (
        128, (0, 16), 6)
