"""The MoE slice's parts on the CPU that need no JAX model program: sizes
and trees against the JAX package's, the int8 expert stacks, the
refusals, the engine's routing on each of its paths, remat, AdamW over a
tree of mixed dtypes against optax, and the token check the card runs
(``chip_smoke.moe_check_tokens``).  Whole-model parity with JAX is in
``test_torch_moe.py``.

Tolerances are stated at each test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import chip_smoke
from dstack_tpu.models import moe as j_moe
from dstack_tpu.models import train as j_train
from dstack_tpu_torch.models import llama, moe, train
from dstack_tpu_torch.ops import flash_attention as fa
from dstack_tpu_torch.ops import rotary
from dstack_tpu_torch.ops.attention import causal_attention
from dstack_tpu_torch.ops.loss import chunked_cross_entropy
from dstack_tpu_torch.ops.rmsnorm import rms_norm
from dstack_tpu_torch.parallel import mesh as mesh_lib
from dstack_tpu_torch.serving import engine as t_engine
from dstack_tpu_torch.serving.quant import quantize_params, quantize_weight

torch.set_num_threads(1)

TINY = moe.MoEConfig.tiny_moe(dtype=torch.float32)
#: tiny_moe served: dropless (capacity factor E / k = 2 would do; 4.0 is
#: what the serving tests and the card use), long prompts allowed
SERVED = dataclasses.replace(moe.MoEConfig.tiny_moe(), capacity_factor=4.0,
                             max_seq_len=2048)


def _tiny_params():
    return moe.init_params(TINY, "cpu", torch.Generator().manual_seed(0))


@pytest.mark.parametrize("name", ["tiny_moe", "mixtral_8x7b"])
def test_num_params_and_init_shapes_match_jax(name):
    """The parameter count is JAX's; the tree holds that many values, in
    JAX's layout (meta tensors: Mixtral-8x7B's 46.7 B take no memory), the
    router in f32 and the rest in the model dtype."""
    cfg = getattr(moe.MoEConfig, name)()
    jcfg = getattr(j_moe.MoEConfig, name)()
    assert cfg.num_params() == jcfg.num_params()
    params = moe.init_params(cfg, "meta", None)
    leaves = llama.tree_leaves(params)
    assert sum(t.numel() for t in leaves) == cfg.num_params()
    lp = params["layers"]
    n, d, f, e = (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
                  cfg.num_experts)
    assert lp["router"].shape == (n, d, e)
    assert lp["router"].dtype == torch.float32
    assert lp["w_gate"].shape == lp["w_up"].shape == (n, e, d, f)
    assert lp["w_down"].shape == (n, e, f, d)
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    assert {t.dtype for name_, t in lp.items() if name_ != "router"} == {
        cfg.dtype}
    if name == "mixtral_8x7b":
        assert round(cfg.num_params() / 1e9, 1) == 46.7


@pytest.mark.parametrize("unstacked", [False, True],
                         ids=["stacked", "unstacked"])
def test_params_from_jax_keeps_the_router_f32(unstacked):
    """``params_from_jax`` casts every floating leaf to the dtype asked
    for, except an MoE tree's router, which stays f32 (bitwise)."""
    rng = np.random.default_rng(0)
    layers = {"wq": rng.standard_normal((2, 8, 8)).astype(np.float32),
              "router": rng.standard_normal((2, 8, 4)).astype(np.float32),
              "w_gate": rng.standard_normal((2, 4, 8, 6)).astype(np.float32)}
    tree = {"embed": rng.standard_normal((16, 8)).astype(np.float32),
            "layers": layers}
    if unstacked:
        tree["layers"] = [{k: v[i] for k, v in layers.items()}
                          for i in range(2)]
    got = llama.params_from_jax(tree, "cpu", torch.bfloat16)
    got_layers = (got["layers"] if not unstacked else
                  {k: torch.stack([lp[k] for lp in got["layers"]])
                   for k in layers})
    assert got["embed"].dtype == torch.bfloat16
    assert got_layers["wq"].dtype == got_layers["w_gate"].dtype == \
        torch.bfloat16
    assert got_layers["router"].dtype == torch.float32
    np.testing.assert_array_equal(got_layers["router"].numpy(),
                                  layers["router"])


def test_quantize_params_covers_the_expert_stacks():
    """int8 serving quantizes the [L, E, in, out] expert stacks per output
    channel of each expert (scales [L, E, out]: each (layer, expert) slice
    as ``quantize_weight`` gives it alone, bitwise), keeps the router f32
    and gives a tied model an int8 head copy."""
    params = _tiny_params()
    q = quantize_params(params, tied_head_copy=True)
    lp, qp = params["layers"], q["layers"]
    for name in ("w_gate", "w_up", "w_down"):
        w = lp[name]
        assert qp[name]["q"].dtype == torch.int8
        assert qp[name]["q"].shape == w.shape
        assert qp[name]["s"].shape == w.shape[:2] + w.shape[-1:]
        for l in range(w.shape[0]):
            for e in range(w.shape[1]):
                one = quantize_weight(w[l, e])
                assert torch.equal(qp[name]["q"][l, e], one["q"])
                assert torch.equal(qp[name]["s"][l, e], one["s"])
    assert qp["router"] is lp["router"]
    assert q["lm_head"]["q"].shape == (TINY.hidden_size, TINY.vocab_size)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_int8_moe_params_equal_the_quantized_init(tied):
    """The card's Mixtral tree, drawn and quantized a matrix at a time
    (``chip_smoke.int8_moe_params``), equals ``quantize_params`` of
    ``init_params`` from the same seed, bitwise."""
    cfg = dataclasses.replace(moe.MoEConfig.tiny_moe(), tie_embeddings=tied)
    want = quantize_params(moe.init_params(
        cfg, "cpu", torch.Generator().manual_seed(2)), tied_head_copy=tied)
    got = chip_smoke.int8_moe_params(torch, cfg, "cpu", seed=2)
    assert list(got) == list(want) and list(got["layers"]) == list(
        want["layers"])
    for a, b in zip(llama.tree_leaves(got), llama.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


class _Mesh:
    """A DeviceMesh's names and sizes, and rank 0's coordinate."""

    mesh_dim_names = mesh_lib.AXIS_ORDER

    def __init__(self, spec: mesh_lib.MeshSpec):
        self.shape = tuple(spec.sizes[a] for a in mesh_lib.AXIS_ORDER)

    def get_coordinate(self):
        return [0] * len(self.shape)

    def get_local_rank(self, axis):
        return 0


class _Accepted(Exception):
    """Raised by a spy on ``moe._layout`` once the layout is made."""


def test_sharded_arguments_are_refused(monkeypatch):
    """Under a mesh every entry point refuses an expert degree that does
    not divide the experts (a ValueError), and takes what the reference
    runs: an expert axis among the batch axes (the layout then moves the
    tokens and keeps the expert stacks sharded over ``expert``), and
    ``seq`` or ``stage`` in the mesh and the policy (replicas: the layout
    has neither, and sums the gradients over the batch axes alone)."""
    opt = train.default_optimizer()
    tokens = torch.zeros((1, 8), dtype=torch.long)
    three = dict(mesh=_Mesh(mesh_lib.MeshSpec(expert=3)))

    def calls(kw):
        return (lambda: moe.backbone({"layers": {}}, tokens, TINY, **kw),
                lambda: moe.make_train_step(TINY, opt, **kw),
                lambda: moe.create_state(0, TINY, opt, device="cpu", **kw))

    for call in calls(three):
        with pytest.raises(ValueError, match="expert mesh degree"):
            call()
    with pytest.raises(ValueError, match="remat"):
        moe.make_train_step(TINY, opt, remat="sometimes")

    made, real = [], moe._layout

    def spy(*args):
        made.append(real(*args))
        raise _Accepted

    monkeypatch.setattr(moe, "_layout", spy)
    accepted = {
        "batch_expert": (mesh_lib.MeshSpec(expert=2),
                         dict(batch_axes=("data", "expert"))),
        "seq": (mesh_lib.MeshSpec(seq=2, expert=2), dict(seq_axis="seq")),
        "stage": (mesh_lib.MeshSpec(stage=2, data=2),
                  dict(stage_axis="stage")),
    }
    for name, (spec, policy) in accepted.items():
        made.clear()
        for call in calls(dict(mesh=_Mesh(spec),
                               policy=llama.ShardingPolicy(**policy))):
            with pytest.raises(_Accepted):
                call()
        assert len(made) == 3
        for layout in made:
            assert layout.seq is None and layout.stage is None, name
            assert layout.token_axes == layout.batch, name
            if name == "batch_expert":
                assert layout.batch == ["expert"] and layout.exchange
                assert "expert" in layout.kept
            else:
                assert not layout.exchange, name


def test_entry_points_need_cuda_unless_the_cpu_is_named(monkeypatch):
    """State and engine go on the card by default: without one they raise;
    the CPU runs when named, and an int seed draws what a generator with
    that seed draws."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = train.default_optimizer()
    for gen in (0, torch.Generator().manual_seed(0)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            moe.create_state(gen, TINY, opt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_engine.InferenceEngine(moe.MoEConfig.tiny_moe())
    seeded = moe.create_state(5, TINY, opt, device="cpu")
    drawn = moe.create_state(torch.Generator().manual_seed(5), TINY, opt,
                             unstacked=True, device="cpu")
    assert isinstance(drawn.params["layers"], list)
    for a, b in zip(llama.tree_leaves(seeded.params),
                    llama.tree_leaves(llama.stack_params(drawn.params))):
        assert a.device.type == "cpu" and torch.equal(a, b)


def test_engine_tells_moe_from_its_params():
    """``_is_moe``: an MoEConfig (the engine then draws MoE weights), or a
    layer tree with a router whatever the config says; a router under a
    config that cannot route (no expert counts) is refused up front."""
    engine = t_engine.InferenceEngine(moe.MoEConfig.tiny_moe(), device="cpu",
                                      batch_size=1, max_len=64)
    assert engine._is_moe
    assert engine.params["layers"]["router"].dtype == torch.float32
    assert engine.params["layers"]["w_gate"].dim() == 4
    dense = t_engine.InferenceEngine(llama.LlamaConfig.tiny(), device="cpu",
                                     batch_size=1, max_len=64)
    assert not dense._is_moe
    with pytest.raises(ValueError, match="router"):
        t_engine.InferenceEngine(llama.LlamaConfig.tiny(),
                                 params=engine.params, device="cpu")
    unstacked = llama.unstack_params(engine.params)
    with pytest.raises(ValueError, match="router"):
        t_engine.InferenceEngine(llama.LlamaConfig.tiny(), params=unstacked,
                                 device="cpu")


@pytest.mark.parametrize("kw,want", [
    ({}, {(32, None, 19)}),
    ({"prefill_chunk": 8}, {(32, None, 8), (32, None, 3)}),
    ({"prefill_chunk": 8, "paged": True, "kv_block_size": 8},
     {(32, None, 8), (32, None, 3)}),
    ({"speculation": "ngram"}, {(32, None, 19), (3, None, None)}),
], ids=["whole", "chunked", "chunked_paged", "speculation"])
def test_engine_routes_each_path_with_its_capacity_and_mask(kw, want,
                                                            monkeypatch):
    """What each path hands ``_moe_mlp``, as (tokens a row, capacity,
    real tokens under the mask): a prefill or chunk its bucket with the
    config's capacity and padding masked out; decode one token a slot at
    the dropless capacity B and no mask; the speculative verify k + 1
    tokens a slot at the config's capacity and no mask."""
    seen = set()
    real = moe._moe_mlp

    def spy(h, lp, cfg, capacity=None, token_mask=None, layout=None):
        seen.add((h.shape[1], capacity,
                  None if token_mask is None else int(token_mask.sum())))
        return real(h, lp, cfg, capacity=capacity, token_mask=token_mask,
                    layout=layout)

    monkeypatch.setattr(moe, "_moe_mlp", spy)
    engine = t_engine.InferenceEngine(SERVED, device="cpu", batch_size=2,
                                      max_len=64, **kw)
    engine.generate(list(range(3, 22)), max_new_tokens=6)
    assert seen == want | {(1, 2, None)} if not kw.get("speculation") \
        else seen == want


def _loss_and_grads(remat):
    params = llama.unstack_params(_tiny_params())
    leaves = llama.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, TINY.vocab_size, (2, 129)))
    x, aux = moe.backbone(params, tokens[:, :-1], TINY, remat=remat)
    value = (chunked_cross_entropy(x, llama.output_head(params, TINY),
                                   tokens[:, 1:])
             + TINY.router_aux_weight * aux)
    return value, torch.autograd.grad(value, leaves)


@pytest.mark.parametrize("remat", [True, "selective", "wide", "full"])
def test_remat_recomputes_the_whole_layer(remat, monkeypatch):
    """Every remat mode keeps only the layer's input: the loss and the
    gradients are those without remat (1e-6 on O(1e-2) gradients: sums in
    another order), and the backward runs the attention forward again in
    every layer (flash launches on the card: 2 forward, 1 backward a
    layer)."""
    want_loss, want = _loss_and_grads(False)
    calls = {"fwd": 0, "bwd": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fa, "flash_attention_fwd_plain",
                        counting("fwd", fa.flash_attention_fwd_plain))
    monkeypatch.setattr(fa, "flash_attention_bwd_plain",
                        counting("bwd", fa.flash_attention_bwd_plain))
    got_loss, got = _loss_and_grads(remat)
    assert calls == {"fwd": 2 * TINY.num_layers, "bwd": TINY.num_layers}
    assert got_loss.item() == pytest.approx(want_loss.item(), rel=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, rtol=0)


def _hand_layer_backbone(params, tokens, cfg, *, remat):
    """Mixtral's backbone as it stood with a layer of its own, before its
    layers became ``llama._layer_fn`` ones, off a mesh: there its layout's
    ``weight``, ``enter`` and ``leave`` are the identity and its
    ``attention`` is ``flash_attention``, and no profiler runs, so no span
    is opened.  Every mode but "none" recomputes the whole layer."""
    keep = llama.remat_names(remat)
    b, s = tokens.shape
    inv_freqs = torch.from_numpy(rotary.rope_frequencies(
        cfg.head_dim, cfg.rope_theta, cfg.rope_scaling))
    positions = torch.arange(s)[None, :]
    rope = rotary.rope_table(positions, inv_freqs)
    use_flash = fa.supports(s, cfg.head_dim, cfg.dtype,
                            group=cfg.num_heads // cfg.num_kv_heads)
    layers = params["layers"]

    def layer(x, lp):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = ((h @ lp[name]).reshape(b, s, -1, cfg.head_dim)
                   for name in ("wq", "wk", "wv"))
        q, k = rotary.qk_prologue(q, k, rope=rope, eps=cfg.rms_eps)
        if use_flash:
            attn = fa.flash_attention(q, k, v)
        else:
            attn = causal_attention(q, k, v, q_positions=positions,
                                    kv_positions=positions)
        x = x + attn.reshape(b, s, -1) @ lp["wo"]
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        experts = {name: lp[name]
                   for name in ("router", "w_gate", "w_up", "w_down")}
        moe_out, layer_aux = moe._moe_mlp(h, experts, cfg)
        return x + moe_out, layer_aux

    layer_fn = layer if keep is None else (
        lambda x, lp: checkpoint(layer, x, lp, use_reentrant=False,
                                 preserve_rng_state=False))
    x = llama._embed_lookup(params["embed"].to(cfg.dtype), tokens,
                            llama.Layout(None, llama.ShardingPolicy(), cfg),
                            None)
    aux = torch.zeros((), dtype=torch.float32)
    if not isinstance(layers, (list, tuple)):
        layers = llama.layer_views(layers, cfg.num_layers)
    for lp in layers:
        x, layer_aux = layer_fn(x, lp)
        aux = aux + layer_aux
    return rms_norm(x, params["final_norm"], cfg.rms_eps), aux / cfg.num_layers


@pytest.mark.parametrize("stacked", [True, False],
                         ids=["stacked", "unstacked"])
@pytest.mark.parametrize("remat", [False, True])
def test_backbone_is_the_hand_layer_bit_for_bit(remat, stacked):
    """Mixtral's backbone through ``llama._layer_fn`` with the routed MLP
    is the hand-written layer it replaced, bit for bit in float32: the
    hidden states, the aux loss and every parameter's gradient of a loss
    that reads both."""
    params = _tiny_params()
    if not stacked:
        params = llama.unstack_params(params)
    leaves = llama.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    rng = np.random.default_rng(11)
    tokens = torch.from_numpy(rng.integers(0, TINY.vocab_size, (2, 128)))
    dy = torch.from_numpy(rng.standard_normal(
        (2, 128, TINY.hidden_size)).astype(np.float32))
    runs = []
    for backbone in (moe.backbone, _hand_layer_backbone):
        x, aux = backbone(params, tokens, TINY, remat=remat)
        value = (x * dy).sum() + TINY.router_aux_weight * aux
        runs.append((x, aux, torch.autograd.grad(value, leaves)))
    (x, aux, grads), (want_x, want_aux, want_grads) = runs
    assert aux.item() > 0
    assert torch.equal(x, want_x) and torch.equal(aux, want_aux)
    assert len(grads) == len(want_grads) == len(leaves)
    for g, w in zip(grads, want_grads):
        assert torch.equal(g, w)


@pytest.mark.parametrize("clip", [1e-3, 1e3], ids=["clipped", "unclipped"])
def test_adamw_over_mixed_dtypes_matches_optax(clip):
    """A bf16 leaf beside an f32 one (the router among bf16 weights), three
    updates.  The norm is the f32 global norm of both (1e-6 relative);
    optax sums the bf16 leaf's squares in bf16, so its clip norm is within
    2^-8 of it.  That rounding moves each step's clip factor, so clipped,
    the f32 leaf may differ by 2^-8 of lr a step (1e-6 unclipped, as in
    the all-f32 case).  The bf16 leaf: the fused step rounds once from
    f32, optax rounds each bf16 operation of an update of about lr, so
    they differ by up to ~4 roundings (2^-6) of lr a step, doubled for
    the two sides, plus a rounding of the value (2^-8)."""
    rng = np.random.default_rng(12)
    tree = {"w": rng.standard_normal((4, 5)).astype(np.float32),
            "router": rng.standard_normal((5, 3)).astype(np.float32)}
    dtypes = {"w": (jnp.bfloat16, torch.bfloat16),
              "router": (jnp.float32, torch.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in tree.items()} for _ in range(3)]
    lr, steps = 1e-2, len(grads)
    jopt = j_train.default_optimizer(lr=lr, grad_clip=clip)
    jparams = {k: jnp.asarray(v).astype(dtypes[k][0]) for k, v in tree.items()}
    jstate = jopt.init(jparams)
    topt = train.default_optimizer(lr=lr, grad_clip=clip)
    tparams = {k: torch.tensor(v).to(dtypes[k][1]) for k, v in tree.items()}
    tstate = topt.init(tparams)
    for g in grads:
        jg = {k: jnp.asarray(v).astype(dtypes[k][0]) for k, v in g.items()}
        tg = [torch.tensor(g[k]).to(dtypes[k][1]) for k in tparams]
        updates, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        norm = topt.update(list(tparams.values()), tg, tstate)
        f32_norm = float(optax.global_norm(
            {k: v.astype(jnp.float32) for k, v in jg.items()}))
        assert norm.item() == pytest.approx(f32_norm, rel=1e-6)
        assert norm.item() == pytest.approx(float(optax.global_norm(jg)),
                                            rel=2.0 ** -8)
    assert tparams["router"].dtype == torch.float32
    np.testing.assert_allclose(
        tparams["router"].numpy(), np.asarray(jparams["router"]), rtol=0,
        atol=steps * lr * 2.0 ** -8 if clip < 1 else 1e-6)
    assert tparams["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(tparams["w"].float().numpy(),
                               np.asarray(jparams["w"].astype(jnp.float32)),
                               rtol=2.0 ** -8, atol=steps * lr * 2.0 ** -5)


@pytest.fixture(scope="module")
def served_int8():
    return chip_smoke.int8_moe_params(torch, SERVED, "cpu", seed=2)


def test_token_check_replays_routing_flips_and_catches_a_fault(
        served_int8, monkeypatch):
    """The card's greedy check on a paged int8 engine in bf16: the engine's
    routing, recorded call by call, maps onto every position it fed; the
    tokens pass against the forward routed as the engine routed.  The same
    engine with a paged-decode attention that drops each slot's newest
    cached row must fail it."""
    params = served_int8
    reference = chip_smoke.dequantized_dense(torch, params, SERVED.dtype)
    out, runs = chip_smoke.moe_serve(torch, SERVED, params, "moe", "cpu",
                                     paged=True, long_prompt=True)
    for reqs, routes in runs:
        for r, eng in zip(reqs, routes):
            assert eng.shape == (SERVED.num_layers,
                                 len(r.tokens) + len(r.output) - 1,
                                 SERVED.num_experts)
    stats = chip_smoke.moe_check_tokens(torch, reference, SERVED, runs, "moe")
    assert stats["tokens_checked"] == 16 + 8 * 64 + 16
    assert stats["router_max_abs_diff"] <= chip_smoke.MOE_TIE_EPS

    paged = t_engine.paged_decode_attention

    def drops_newest(q, k, v, tables, lengths, scale=None):
        return paged(q, k, v, tables, torch.clamp(lengths - 1, min=0),
                     scale=scale)

    monkeypatch.setattr(t_engine, "paged_decode_attention", drops_newest)
    _, runs = chip_smoke.moe_serve(torch, SERVED, params, "faulty", "cpu",
                                   paged=True, long_prompt=False)
    with pytest.raises(SystemExit, match="FAILED: faulty"):
        chip_smoke.moe_check_tokens(torch, reference, SERVED, runs, "faulty")
