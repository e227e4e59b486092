"""The port's Mixtral-style MoE against the JAX package's, on the CPU.

Same numpy inputs on both sides, in float32 unless a test says otherwise,
with the JAX package's init carried over through ``params_from_jax`` (the
router stays f32).  The model tests run at seq 128, where both sides take
their fused attention route (the JAX side runs its Pallas kernels in
interpret mode).

This file compiles JAX programs, so it holds few tests (xdist starts the
files with the most tests first, beside the load-sensitive dtlint scan
guard), and each JAX result is computed once per module.  The engine's
greedy reference is one jitted ``moe.forward`` at one padded shape.  The
cheap cases of the slice are in ``test_torch_moe_parts.py``.

Tolerances (all stated where used):
- routing: dispatch equal exactly (0/1 values placed by the same integer
  cumsum); combine 1e-6 (gates from softmaxes that may differ in the last
  f32 bit); the aux loss 1e-6 relative;
- ``HIDDEN_ATOL`` 2e-5 on hidden states and logits of O(1): two layers of
  f32 matmuls summed in another order;
- ``BF16_RTOL``: ``_moe_mlp`` in bf16 rounds at five points (dispatch
  product, gate, up, the down product, combine), each to half an ulp
  (2^-9) on either side, so outputs may differ by a few bf16 ulps of the
  largest output: 2^-6 of it;
- train steps: ``LOSS_RTOL`` 2e-6 on the cross entropy and grad norms,
  ``AUX_RTOL`` 1e-5 on the aux loss (means of f32 probabilities), and
  ``PARAM_ATOL`` 2 * lr * steps on parameters after three AdamW steps
  (Adam divides each gradient by its own running RMS, so an element
  whose gradient is within rounding noise of zero may move by lr a step
  either way), with all but a few elements within 1e-6;
- the engine's greedy tokens must EQUAL the reference's: the same function
  in f32, dropless routing at ``capacity_factor=4.0`` (capacity 2t >= t
  for 4 experts and top-2, at any length), so padding, per-token decode
  and the full forward route alike.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dstack_tpu.models import moe as j_moe
from dstack_tpu.models import train as j_train
from dstack_tpu.ops.loss import chunked_cross_entropy as j_chunked_ce
from dstack_tpu.serving import engine as j_engine
from dstack_tpu.serving.quant import quantize_params as j_quantize_params
from dstack_tpu_torch.models import llama, moe, train
from dstack_tpu_torch.serving import engine as t_engine

torch.set_num_threads(1)

SEQ, BATCH, STEPS = 128, 2, 3
LR = 3e-4
HIDDEN_ATOL = 2e-5
BF16_RTOL = 2.0 ** -6
LOSS_RTOL = 2e-6
AUX_RTOL = 1e-5
PARAM_ATOL = 2 * LR * STEPS
CLOSE_ATOL, CLOSE_SHARE = 1e-6, 0.999
#: the engine tests: prompts in one prefill bucket, a shared 16-token
#: prefix (two blocks of 8) for the prefix-cache hit
PREFIX = [(i * 7 + 3) % 512 for i in range(16)]
PROMPTS = [[1, 5, 9, 42, 7], list(range(3, 30)), PREFIX + [11, 12, 13],
           PREFIX + [400, 1, 2, 3, 4]]
NEW_TOKENS = 8
REF_LEN = 64  # the reference's padded length: not a multiple of 128


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree["layers"])


@pytest.fixture(scope="module")
def ref():
    """One JAX init (f32 tiny_moe) and what the JAX package computes from
    it: the backbone's hidden states and aux loss and the forward's logits
    on the first batch, three train steps (cross entropy, aux loss, grad
    norm before each step, final params), and the engine's prompt forward
    at the default capacity factor over a padded prompt."""
    jcfg = j_moe.MoEConfig.tiny_moe(dtype=jnp.float32)
    params = j_moe.init_params(jax.random.PRNGKey(0), jcfg)
    init = _np_tree(params)
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, jcfg.vocab_size, (BATCH, SEQ + 1)).astype(
        np.int32) for _ in range(STEPS)]
    tokens = jnp.asarray(batches[0][:, :-1])
    hidden, aux = j_moe.backbone(params, tokens, jcfg)
    logits = j_moe.forward(params, tokens, jcfg)

    def loss(p, batch):
        x, a = j_moe.backbone(p, batch[:, :-1], jcfg, remat=True)
        return (j_chunked_ce(x, j_moe.llama.output_head(p, jcfg),
                             batch[:, 1:]) + jcfg.router_aux_weight * a)

    grad_norm = jax.jit(lambda p, b: optax.global_norm(jax.grad(loss)(p, b)))
    opt = j_train.default_optimizer(lr=LR)
    state = j_moe.create_state(jax.random.PRNGKey(0), jcfg, opt)
    step_fn = j_moe.make_train_step(jcfg, opt)
    ces, auxes, norms = [], [], []
    for b in batches:
        norms.append(float(grad_norm(state.params, jnp.asarray(b))))
        state, metrics = step_fn(state, {"tokens": jnp.asarray(b)})
        ces.append(float(metrics["loss"]))
        auxes.append(float(metrics["aux_loss"]))
    padded = np.zeros(32, np.int32)
    padded[:19] = PROMPTS[2]
    prompt_logits, ks, vs = j_engine._prompt_forward(
        params, jcfg, jnp.asarray(padded), 19, 32)
    return {"jcfg": jcfg, "cfg": moe.MoEConfig.tiny_moe(dtype=torch.float32),
            "init": init, "batches": batches, "hidden": np.asarray(hidden),
            "aux": float(aux), "logits": np.asarray(logits), "ces": ces,
            "auxes": auxes, "norms": norms, "final": _np_tree(state.params),
            "prompt": (padded, np.asarray(prompt_logits), np.asarray(ks),
                       np.asarray(vs))}


def _port_params(ref, unstacked=False):
    tree = ref["init"]
    if unstacked:
        tree = _np_tree(j_moe.llama.unstack_params(tree))
    return llama.params_from_jax(tree, "cpu", torch.float32)


def _dense(route, e, cap):
    """The JAX package's (dispatch [T, E, C], combine [T, E, C], aux) from
    the port's routing by index: a 1 and the gate at each kept choice's
    (expert, slot)."""
    t = route.expert.shape[0]
    dispatch, combine = torch.zeros(t, e, cap), torch.zeros(t, e, cap)
    rows, j = route.kept.nonzero(as_tuple=True)
    at = (rows, route.expert[rows, j], route.slot[rows, j])
    dispatch[at] = 1.0
    combine[at] = route.gate[rows, j]
    return dispatch, combine, route.aux


def test_route_matches_jax_with_drops_masks_and_ties():
    """Capacities that drop (1, 3) and one that cannot (32), with and
    without a token mask, on logits with planted ties: a tie for first,
    a tie across the k-th place, a row all equal."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((16, 4)).astype(np.float32)
    logits[2] = [1.0, 2.0, 2.0, 0.5]
    logits[5] = [3.0, 1.0, 1.0, 1.0]
    logits[9] = 0.0
    mask = (rng.random(16) < 0.7).astype(np.int32)
    jroute = jax.jit(j_moe._route, static_argnums=(1, 2))
    for cap in (1, 3, 32):
        for m in (None, mask):
            want = jroute(jnp.asarray(logits), 2, cap,
                          None if m is None else jnp.asarray(m))
            got = _dense(moe._route(torch.from_numpy(logits), 2, cap,
                                    None if m is None
                                    else torch.from_numpy(m)), 4, cap)
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                       atol=1e-6, rtol=0)
            assert got[2].item() == pytest.approx(float(want[2]), rel=1e-6)
    # the ties went to the lower experts first, as lax.top_k orders them
    dispatch = _dense(moe._route(torch.from_numpy(logits), 2, 32), 4,
                      32)[0].sum(-1)
    assert dispatch[2].tolist() == [0, 1, 1, 0]
    assert dispatch[5].tolist() == [1, 1, 0, 0]
    assert dispatch[9].tolist() == [1, 1, 0, 0]


def test_moe_mlp_matches_jax_in_bf16():
    """One layer's routed MLP in bf16, with bf16 experts and with the JAX
    package's int8 ``quantize_params`` tree carried over; at a capacity
    factor that drops tokens, with a token mask, and dropless at a given
    capacity (the engine's decode).  Outputs within ``BF16_RTOL`` of the
    largest, aux losses 1e-6 relative (f32 routing on equal inputs)."""
    jcfg = j_moe.MoEConfig.tiny_moe()
    cfg = moe.MoEConfig.tiny_moe()
    jtree = j_moe.init_params(jax.random.PRNGKey(1), jcfg)
    assert jtree["layers"]["router"].dtype == jnp.float32
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 24, jcfg.hidden_size)).astype(np.float32)
    mask = np.arange(24)[None, :] < np.array([[19], [24]])
    cases = [(quant, kw) for quant in (False, True)
             for kw in ({}, {"token_mask": mask}, {"capacity": 48})]
    for quant, kw in cases:
        tree = j_quantize_params(jtree) if quant else jtree
        jlp = _layer0(tree)
        lp = {k: v[0] if not isinstance(v, dict) else
              {n: t[0] for n, t in v.items()}
              for k, v in llama.params_from_jax(
                  _np_tree(tree), "cpu", torch.bfloat16)["layers"].items()}
        assert lp["router"].dtype == torch.float32
        jkw = {k: jnp.asarray(v) if k == "token_mask" else v
               for k, v in kw.items()}
        tkw = {k: torch.from_numpy(v) if k == "token_mask" else v
               for k, v in kw.items()}
        want, want_aux = j_moe._moe_mlp(
            jnp.asarray(h).astype(jnp.bfloat16), jlp, jcfg, None, None,
            **jkw)
        got, got_aux = moe._moe_mlp(torch.from_numpy(h).to(torch.bfloat16),
                                    lp, cfg, **tkw)
        want = np.asarray(want.astype(jnp.float32))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=BF16_RTOL * np.abs(want).max())
        assert got_aux.item() == pytest.approx(float(want_aux), rel=1e-6)


def test_backbone_forward_and_prompt_forward_match_jax(ref):
    """The backbone's hidden states and aux loss and the forward's logits,
    from stacked and unstacked layers; the engine's prompt forward of a
    padded prompt at the default capacity factor (1.25, so padding that
    claimed capacity would drop real tokens): logits and every layer's K/V
    within ``HIDDEN_ATOL``."""
    cfg = ref["cfg"]
    tokens = torch.from_numpy(ref["batches"][0][:, :-1]).long()
    for unstacked in (False, True):
        params = _port_params(ref, unstacked)
        hidden, aux = moe.backbone(params, tokens, cfg)
        np.testing.assert_allclose(hidden.numpy(), ref["hidden"],
                                   atol=HIDDEN_ATOL, rtol=0)
        assert aux.item() == pytest.approx(ref["aux"], rel=1e-6)
        np.testing.assert_allclose(moe.forward(params, tokens, cfg).numpy(),
                                   ref["logits"], atol=HIDDEN_ATOL, rtol=0)
    params = _port_params(ref)  # the engine keeps stacked layers
    padded, want_logits, want_ks, want_vs = ref["prompt"]
    logits, ks, vs = t_engine._prompt_forward(
        params, cfg, torch.from_numpy(padded).long(), 19, 32)
    np.testing.assert_allclose(logits.numpy(), want_logits,
                               atol=HIDDEN_ATOL, rtol=0)
    for got, want in ((ks, want_ks), (vs, want_vs)):
        np.testing.assert_allclose(got[:, :, :19].numpy(),
                                   want[:, :, :19], atol=HIDDEN_ATOL, rtol=0)


def test_train_steps_match_jax(ref):
    """Three steps of ``make_train_step`` (remat=True: each layer
    recomputed whole in the backward, as the JAX package's policy does on
    this layer) on an unstacked state against JAX's step with optax:
    cross entropy and grad norm to ``LOSS_RTOL``, aux loss to
    ``AUX_RTOL``, parameters to ``PARAM_ATOL``."""
    cfg = ref["cfg"]
    params = _port_params(ref, unstacked=True)
    opt = train.default_optimizer(lr=LR)
    state = train._fresh_state(params, opt, unstacked=True)
    assert {p.dtype for p in llama.tree_leaves(state.params)} == {
        torch.float32}
    step_fn = moe.make_train_step(cfg, opt)
    for i, b in enumerate(ref["batches"]):
        state, metrics = step_fn(state, {"tokens": torch.from_numpy(b)})
        assert metrics["step"] == i + 1
        assert metrics["loss"].item() == pytest.approx(ref["ces"][i],
                                                       rel=LOSS_RTOL)
        assert metrics["aux_loss"].item() == pytest.approx(ref["auxes"][i],
                                                           rel=AUX_RTOL)
        assert metrics["grad_norm"].item() == pytest.approx(ref["norms"][i],
                                                            rel=LOSS_RTOL)
    got = [t.detach().numpy() for t in
           llama.tree_leaves(llama.stack_params(state.params))]
    want = llama.tree_leaves(ref["final"])
    assert [g.shape for g in got] == [w.shape for w in want]
    diff = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    assert diff.max() <= PARAM_ATOL, diff.max()
    assert np.mean(diff <= CLOSE_ATOL) >= CLOSE_SHARE, np.mean(
        diff <= CLOSE_ATOL)


@pytest.fixture(scope="module")
def served(ref):
    """(config, port params, greedy reference): JAX's ``moe.forward`` at
    capacity_factor 4.0, one jitted program at [len(PROMPTS), REF_LEN]
    (no fused attention there), greedy from each prompt; the same for
    the weights of an int8 engine, dequantized to f32."""
    jcfg = dataclasses.replace(ref["jcfg"], capacity_factor=4.0)
    fwd = jax.jit(lambda p, t: j_moe.forward(p, t, jcfg))

    def greedy(np_tree):
        jparams = jax.tree.map(jnp.asarray, np_tree)
        seqs = [list(p) for p in PROMPTS]
        for _ in range(NEW_TOKENS):
            padded = np.zeros((len(seqs), REF_LEN), np.int32)
            for i, s in enumerate(seqs):
                padded[i, :len(s)] = s
            logits = np.asarray(fwd(jparams, jnp.asarray(padded)))
            for i, s in enumerate(seqs):
                s.append(int(np.argmax(logits[i, len(s) - 1])))
        return [s[len(p):] for s, p in zip(seqs, PROMPTS)]

    cfg = dataclasses.replace(ref["cfg"], capacity_factor=4.0)
    params = _port_params(ref)
    int8 = t_engine.InferenceEngine(cfg, params=params, quantize="int8",
                                    device="cpu", batch_size=2, max_len=64)

    def dequant(node):
        if isinstance(node, dict) and "q" in node:
            return (node["q"].float() * node["s"][..., None, :]).numpy()
        if isinstance(node, dict):
            return {k: dequant(v) for k, v in node.items()}
        return node.numpy()

    deq = dequant(int8.params)
    return cfg, params, {"f32": greedy(ref["init"]), "int8": greedy(deq)}


def _run(engine, prompts, waves=None):
    """Greedy tokens of ``prompts`` on ``engine``: all at once, or one wave
    (a list of prompt indices) after another."""
    reqs = [t_engine.Request(tokens=list(p), max_new_tokens=NEW_TOKENS)
            for p in prompts]
    for wave in waves or [range(len(prompts))]:
        for i in wave:
            engine.submit(reqs[i])
        for _ in range(400):
            if all(reqs[i].done.is_set() for i in wave):
                break
            engine.step()
    assert all(r.done.is_set() for r in reqs)
    return [r.output for r in reqs]


def _engine_tokens(served, waves=None, **kw):
    cfg, params, _ = served
    engine = t_engine.InferenceEngine(cfg, params=params, device="cpu",
                                      batch_size=2, max_len=64, **kw)
    assert engine._is_moe
    return engine, _run(engine, PROMPTS, waves)


PAGED = {"paged": True, "kv_block_size": 8}


def test_engine_dense_paged_and_int8_greedy_match_jax_forward(served):
    """The engine's greedy tokens equal JAX's ``moe.forward`` greedy
    reference on a dense cache, on paged KV (the paged-decode kernel's
    plain version here) and with int8 weights (the reference on the same
    weights, dequantized)."""
    want = served[2]
    for kw in ({}, PAGED):
        assert _engine_tokens(served, **kw)[1] == want["f32"], kw
    engine, got = _engine_tokens(served, quantize="int8")
    assert got == want["int8"]
    assert engine.params["layers"]["w_gate"]["q"].dtype == torch.int8


def test_engine_chunked_prefix_hit_and_speculative_greedy_match_jax_forward(
        served):
    """The same reference through chunked prefill (chunks of 8: the last
    chunk of a prompt is padded to its bucket), dense and paged; a
    prefix-cache hit (the prompts that share two blocks admitted one
    after the other: the second prefills its suffix only); n-gram
    speculation, whose (k+1)-wide verify routes at the config's capacity."""
    want = served[2]["f32"]
    for kw in ({"prefill_chunk": 8}, {"prefill_chunk": 8, **PAGED}):
        assert _engine_tokens(served, **kw)[1] == want, kw
    engine, got = _engine_tokens(served, waves=[[0, 1], [2], [3]],
                                 prefix_cache=True, **PAGED)
    assert got == want
    assert engine._alloc.stats["hit_blocks"] == len(PREFIX) // 8
    engine, got = _engine_tokens(served, speculation="ngram")
    assert got == want
    assert engine.spec_stats["steps"] > 0
