"""The cheap cases of Kanana-2's (``deepseek_v3``) slice, no JAX: the flash
plain versions and ``causal_attention`` with v narrower than q and k
against an explicit softmax, the wrapper's refusals at those widths, the
walk's choice of the fused route (``flash.kernel_takes`` beside the JAX
package's ``supports``), DeepSeek's interleaved RoPE against the modelling
code's permuted split halves, the ``model.mla.*`` spans, the share test of
the held experts, the configuration's checks and the smoke's phase.

Tolerances (stated where used):
- the plain versions in float32 against autograd through an explicit
  softmax: 2e-6 of the largest output and gradient (one softmax pass
  against two, -1e30 against -inf), as Trinity's windowed ones;
- rotated scores 1e-5 of the largest score (float32 rotations of the
  same pairs, summed in another order);
- the share test 1e-5 of the largest output (float32 sums of the
  experts' parts in another order).
"""

import dataclasses

import pytest
import torch

from dstack_tpu_torch.models import deepseek, llama, moe, train
from dstack_tpu_torch.ops import flash_attention as fa
from dstack_tpu_torch.ops import rotary
from dstack_tpu_torch.ops.attention import causal_attention
from tests import afmoe_reference
from tests import deepseek_reference as ref


def _qkv(seed, b=2, s=128, h=4, dq=24, dv=16):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, s, h, d, generator=g) for d in (dq, dq, dv)]


@pytest.mark.parametrize("dq,dv", [(24, 16), (192, 128), (16, 32)])
def test_plain_versions_take_v_narrower_than_q(dq, dv):
    """The plain versions the kernels are held to, forward and backward,
    against autograd through the reference's explicit softmax at scale
    dq^-0.5; ``causal_attention`` alike."""
    q, k, v = _qkv(dq + dv, s=64 if dq > 100 else 128, dq=dq, dv=dv)
    do = torch.randn(*q.shape[:3], dv)
    o, lse = fa.flash_attention_fwd_plain(q, k, v)
    dq_, dk, dv_ = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = ref.attention(*leaves)
    wq, wk, wv = torch.autograd.grad(want, leaves, do)
    assert o.shape == want.shape and dv_.shape == v.shape
    assert (o - want).abs().max() <= 2e-6 * want.abs().max()
    grad_scale = max(float(g.abs().max()) for g in (wq, wk, wv))
    for got, exp in ((dq_, wq), (dk, wk), (dv_, wv)):
        assert (got - exp).abs().max() <= 2e-6 * grad_scale
    got = causal_attention(q, k, v)
    assert (got - want).abs().max() <= 2e-6 * want.abs().max()
    # through autograd as the model calls it
    got = fa.flash_attention(*leaves)
    assert (got - want).abs().max() <= 2e-6 * want.abs().max()


def test_the_wrapper_refuses_what_the_latent_kernels_do_not_take():
    """Checked before any build or launch (meta tensors: no data)."""
    def t(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    q, k = t(1, 128, 4, 192), t(1, 128, 4, 192)
    fa._check_flash(q, k, t(1, 128, 4, 128))            # the built pair
    with pytest.raises(ValueError, match="head_dim"):
        fa._check_flash(q, k, t(1, 128, 4, 64))
    with pytest.raises(ValueError, match="head_dim"):
        fa._check_flash(t(1, 128, 4, 128), t(1, 128, 4, 128),
                        t(1, 128, 4, 64))
    with pytest.raises(ValueError, match="shapes"):
        fa._check_flash(q, k, t(1, 64, 4, 128))
    with pytest.raises(ValueError, match="windowed"):
        fa._latent_window(64, 192, 128)
    assert fa._latent_window(64, 128, 128) == 64
    with pytest.raises(NotImplementedError, match="latent"):
        fa.flash_attention_sharded(None, q, k, t(1, 128, 4, 128))
    for name in ("mla_fwd_launches", "mla_bwd_launches"):
        assert isinstance(getattr(fa.flash_attention, name), int)


def test_kernel_takes_the_built_widths_at_any_multiple_of_128():
    assert fa.kernel_takes(16384, 128) and fa.kernel_takes(16384, 64, 64)
    assert fa.kernel_takes(16384, 192, 128) and fa.kernel_takes(128, 192, 128)
    assert fa.kernel_takes(1 << 20, 128, 128)
    assert not fa.kernel_takes(16384, 192)           # (192, 192) not built
    assert not fa.kernel_takes(16384, 16)
    assert not fa.kernel_takes(16320, 128) and not fa.kernel_takes(0, 128)
    assert not fa.kernel_takes(64, 128)


def _walk_choice(monkeypatch, cfg, seq) -> bool:
    """Whether ``llama._walk`` fuses attention at ``seq`` (its layers
    replaced by the identity, so no attention is computed)."""
    seen = []

    def layer_fn(cfg, positions, rope, fused, *rest):
        seen.append(fused)
        return lambda x, lp: x

    monkeypatch.setattr(llama, "_layer_fn", layer_fn)
    params = {"embed": torch.zeros(8, cfg.hidden_size),
              "layers": [{}], "final_norm": torch.ones(cfg.hidden_size)}
    layout = llama.Layout(None, llama.ShardingPolicy(), cfg)
    llama._walk(params, torch.zeros(1, seq, dtype=torch.long), cfg, layout,
                None, llama.LayerKind(), None)
    return seen[0]


def test_the_walk_fuses_what_it_fused_and_what_the_kernels_take(monkeypatch):
    """Every shape the JAX package's rule fuses stays fused; past its
    budget, the widths the card's kernels are built for are fused too
    (s16384 at D=128, s16384 at latent attention's 192 / 128), others
    still take ``causal_attention``."""
    for d in (16, 64, 128, 192):
        cfg = dataclasses.replace(llama.LlamaConfig.tiny(), head_dim=d,
                                  hidden_size=32, num_heads=2,
                                  num_kv_heads=1)
        for seq in (48, 128, 1024, 4096, 8192, 16384):
            want = (fa.supports(seq, d, cfg.dtype, group=2)
                    or fa.kernel_takes(seq, d))
            assert _walk_choice(monkeypatch, cfg, seq) == want, (d, seq)
            if fa.supports(seq, d, cfg.dtype, group=2):
                assert want
    big = dataclasses.replace(llama.LlamaConfig.tiny(), head_dim=128,
                              hidden_size=32, num_heads=2, num_kv_heads=1)
    assert not fa.supports(16384, 128, big.dtype)
    assert _walk_choice(monkeypatch, big, 16384)
    assert not _walk_choice(monkeypatch, dataclasses.replace(
        big, head_dim=16), 16384)
    mla = deepseek.DeepseekV3Config.tiny(qk_nope_head_dim=128,
                                         qk_rope_head_dim=64, head_dim=64,
                                         v_head_dim=128)
    assert mla.attn_widths == (192, 128)
    assert not fa.supports(16384, 192, mla.dtype)
    assert _walk_choice(monkeypatch, mla, 16384)
    assert not _walk_choice(monkeypatch, mla, 16384 - 64)


def test_interleaved_rope_gives_the_modelling_codes_scores():
    """The port turns pairs (2i, 2i + 1) in place; DeepSeek's modelling
    code permutes them to split halves and turns those.  The two differ
    as vectors but not in q . k, since both sides move alike; split halves
    on the published layout give other scores."""
    g = torch.Generator().manual_seed(3)
    q, k = torch.randn(2, 64, 4, 8, generator=g), \
        torch.randn(2, 64, 1, 8, generator=g)
    inv = torch.from_numpy(rotary.rope_frequencies(8, 10_000.0))
    table = rotary.rope_table(torch.arange(64)[None], inv)
    got = torch.einsum("bqhd,bkhd->bhqk", rotary.rotate_pairs(q, table),
                       rotary.rotate_pairs(k, table))
    want = torch.einsum("bqhd,bkhd->bhqk", ref.rope_interleave(q, 1e4),
                        ref.rope_interleave(k, 1e4))
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    cos, sin = rotary.rownorm.table_cos_sin(table)
    halves = torch.einsum("bqhd,bkhd->bhqk",
                          rotary.rownorm.rotate_half(q, cos, sin),
                          rotary.rownorm.rotate_half(k, cos, sin))
    assert (halves - want).abs().max() > 1e-2 * want.abs().max()


def test_the_train_step_names_the_latent_spans(monkeypatch):
    """``model.mla.latent`` and ``model.mla.rope`` open inside the
    attention's steps, beside the routed MLP's spans."""
    from dstack_tpu_torch.telemetry import spans

    seen = []
    real = spans.region

    def spy(name):
        seen.append(name)
        return real(name)

    monkeypatch.setattr(spans, "region", spy)
    cfg = deepseek.DeepseekV3Config.tiny(dtype=torch.float32)
    st = deepseek.create_state(0, cfg, train.default_optimizer(),
                               device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 49))
    deepseek.make_train_step(cfg, train.default_optimizer())(
        st, {"tokens": tokens})
    assert {"model.mla.latent", "model.mla.rope", "model.attention",
            "model.moe.route", "model.moe.shared", "model.mlp",
            "model.head_loss"} <= set(seen)
    # once each a layer forward, again under remat's recompute
    assert seen.count("model.mla.latent") == 2 * cfg.num_layers
    assert seen.count("model.mla.rope") == 2 * cfg.num_layers


def test_the_latent_spans_mark_their_backward():
    """Under the profiler the spans' markers keep the gradients: a step
    traced gives the untraced step's loss and gradients."""
    from torch.profiler import ProfilerActivity, profile

    cfg = deepseek.DeepseekV3Config.tiny(dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (1, 49),
                           generator=torch.Generator().manual_seed(1))

    def grads():
        st = deepseek.create_state(0, cfg, train.default_optimizer(),
                                   device="cpu")
        leaves = llama.tree_leaves(st.params)
        x = deepseek.backbone(st.params, tokens[:, :-1], cfg,
                              buffers=st.buffers, remat=True)
        loss = torch.nn.functional.cross_entropy(
            (x @ llama.output_head(st.params, cfg)).reshape(
                -1, cfg.vocab_size), tokens[:, 1:].reshape(-1))
        return torch.autograd.grad(loss, leaves)

    plain = grads()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = grads()
    names = {e.name for e in prof.events()}
    assert {"model.mla.latent", "model.mla.rope"} <= names
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_the_held_experts_shares_add_up_to_the_whole_layer():
    """Kanana's routed layer on eight cards of two experts each (of 16,
    top 4, the shared expert): each routes over all 16 and adds its
    experts' part; the parts summed, with the shared expert (which every
    card computes alike) counted once, give the uncut reference layer,
    and each card's port layer gives the reference's part."""
    cfg = deepseek.DeepseekV3Config.tiny(num_experts=16, experts_per_token=4,
                                         dtype=torch.float32)
    g = torch.Generator().manual_seed(2)
    shapes = deepseek.leaf_shapes(cfg, dense=False)
    w = {name: torch.randn(shape, generator=g) * (fan ** -0.5 if fan else
                                                  0.1)
         for name, (shape, fan, _) in shapes.items()}
    h = torch.randn(2 * 64, cfg.hidden_size, generator=g)
    bias = 0.01 * torch.randn(cfg.num_experts, generator=g)
    whole, _ = afmoe_reference.moe(h, w, cfg, bias)
    shared = afmoe_reference.swiglu(h, w["shared_gate"], w["shared_up"],
                                    w["shared_down"])
    parts = torch.zeros_like(h)
    for i in range(8):
        held = (2 * i, 2 * i + 2)
        cut = dict(w, **{n: w[n][held[0]:held[1]]
                         for n in ("w_gate", "w_up", "w_down")})
        want, _ = afmoe_reference.moe(h, cut, cfg, bias, held=held,
                                      shared=False)
        parts = parts + want
        got, _ = moe._moe_mlp(h[None], dict(cut, expert_bias=bias),
                              dataclasses.replace(cfg, held_experts=held))
        assert (got[0] - shared - want).abs().max() \
            <= 1e-5 * want.abs().max()
    assert (parts + shared - whole).abs().max() <= 1e-5 * whole.abs().max()


def test_config_checks_its_widths():
    with pytest.raises(ValueError, match="rotary"):
        deepseek.DeepseekV3Config.tiny(head_dim=16)
    with pytest.raises(ValueError, match="num_kv_heads"):
        deepseek.DeepseekV3Config.tiny(num_kv_heads=2)
    cfg = deepseek.DeepseekV3Config.kanana2_30b_a3b()
    assert cfg.attn_widths == (192, 128) and cfg.num_moe_layers == 47
    assert cfg.latent.qk_head_dim == 192
    shapes = deepseek.leaf_shapes(cfg, dense=False)
    assert shapes["wq"][0] == (2048, 32 * 192)
    assert shapes["w_kv_a"][0] == (2048, 512 + 64)
    assert shapes["w_kv_b"][0] == (512, 32 * 256)
    assert shapes["wo"][0] == (32 * 128, 2048)
    assert shapes["shared_gate"][0] == (2048, 1536)


def test_the_state_template_matches_a_fresh_state():
    cfg = deepseek.DeepseekV3Config.tiny()
    opt = train.default_optimizer()
    st = deepseek.create_state(0, cfg, opt, device="cpu")
    tmpl = deepseek.state_template(cfg, opt)
    assert llama.tree_map(lambda t: (tuple(t.shape), t.dtype), st.params) \
        == llama.tree_map(lambda t: (tuple(t.shape), t.dtype), tmpl.params)
    assert tmpl.buffers["expert_bias"].shape == (cfg.num_moe_layers,
                                                 cfg.num_experts)


def test_the_smokes_kanana_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.kanana_phase`` at the tiny config: the loss falls and
    the bias moves with a zero mean, so no check fails (the launch counts
    are the card's alone); its config at the cut is the benchmark cell's
    shape."""
    import chip_smoke

    failed = []
    monkeypatch.setattr(chip_smoke, "fail", failed.append)
    out = chip_smoke.kanana_phase(
        torch, cfg=deepseek.DeepseekV3Config.tiny(dtype=torch.float32),
        device="cpu", batch=2, seq=128, steps=3)
    assert not failed and out["losses"][-1] < out["losses"][0]
    cut = deepseek.DeepseekV3Config.kanana2_30b_a3b(**chip_smoke.KANANA_CUT)
    assert (cut.num_experts, cut.held_experts, cut.num_moe_layers,
            cut.vocab_size) == (128, (0, 16), 11, 16_032)
