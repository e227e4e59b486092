"""The port's training slice against the JAX package's, on the CPU.

Same numpy inputs on both sides, float32, at seq 128 so that both take
their fused attention route (the JAX side runs its Pallas kernels in
interpret mode: K1/K2 at head_dim 16 for ``tiny``, K3/K4 at head_dim 64
for the ``d64`` variant).  Parameters start from one JAX init, handed to
the port through ``params_from_jax``.  Each JAX result is computed once
per module, and the file holds few tests: pytest-xdist starts the files
with the most tests first, beside the load-sensitive dtlint scan guard, so
the JAX work here runs later (the lighter checks of the slice's parts are
in ``test_torch_train_parts.py``).

Tolerances (f32; all stated where used):
- ``HIDDEN_ATOL`` 2e-5 on hidden states and logits of O(1): two layers of
  f32 matmuls summed in another order, RMSNorm rescaling included (7e-6
  seen);
- ``LOSS_RTOL`` 2e-6 on losses and grad norms (f32 sums of ~1e5 terms in
  another order; 3e-7 seen);
- ``PARAM_ATOL`` on parameters after three AdamW steps: Adam divides each
  gradient by its own running RMS, so an element whose gradient is within
  rounding noise of zero moves by up to lr per step on either side in
  either direction; the bound is 2 * lr * steps, and all but a few
  elements must agree to 1e-6 (3.7e-5 at most, 99.996% within 1e-6 seen).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.models import llama as j_llama
from dstack_tpu.models import train as j_train
from dstack_tpu_torch.models import llama, train
from dstack_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

SEQ, BATCH, STEPS = 128, 2, 3
LR = 3e-4
HIDDEN_ATOL = 2e-5
LOSS_RTOL = 2e-6
PARAM_ATOL = 2 * LR * STEPS
CLOSE_ATOL, CLOSE_SHARE = 1e-6, 0.999

CONFIGS = {
    "tiny": dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                 num_layers=2, num_heads=8, num_kv_heads=4, head_dim=16,
                 max_seq_len=256),
    "d64": dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                max_seq_len=256),
}


def _cfgs(name):
    kw = CONFIGS[name]
    return (j_llama.LlamaConfig(dtype=jnp.float32, **kw),
            llama.LlamaConfig(dtype=torch.float32, **kw))


def _batches(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
            for _ in range(STEPS)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=list(CONFIGS))
def ref(request):
    """One JAX init and everything the JAX package computes from it: the
    backbone's hidden states and the forward's logits on the first batch,
    and three train steps (losses, grad norms, final params)."""
    jcfg, tcfg = _cfgs(request.param)
    params = j_llama.init_params(jax.random.PRNGKey(0), jcfg)
    init = _np_tree(params)
    batches = _batches(jcfg.vocab_size)
    tokens = jnp.asarray(batches[0][:, :-1])
    hidden = np.asarray(j_llama.backbone(params, tokens, jcfg))
    logits = np.asarray(j_llama.forward(params, tokens, jcfg))
    opt = j_train.default_optimizer(lr=LR)
    state = j_train.TrainState(params=params, opt_state=opt.init(params),
                               step=jnp.zeros((), jnp.int32))
    step_fn = j_train.make_train_step(jcfg, opt, remat=False)
    losses, norms = [], []
    for b in batches:
        state, metrics = step_fn(state, {"tokens": jnp.asarray(b)})
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return {"name": request.param, "jcfg": jcfg, "cfg": tcfg, "init": init,
            "batches": batches, "hidden": hidden, "logits": logits,
            "losses": losses, "norms": norms,
            "final": _np_tree(state.params)}


def _port_params(ref, unstacked=False):
    tree = ref["init"]
    if unstacked:
        tree = _np_tree(j_llama.unstack_params(tree))
    return llama.params_from_jax(tree, "cpu", torch.float32)


def _port_state(ref, unstacked):
    params = _port_params(ref, unstacked)
    for p in llama.tree_leaves(params):
        p.requires_grad_(True)
    opt = train.default_optimizer(lr=LR)
    return opt, train.TrainState(params, opt.init(params), 0)


def _assert_params_close(got_tree, want_tree):
    got = [t.detach().numpy() for t in llama.tree_leaves(got_tree)]
    want = [np.asarray(w) for w in llama.tree_leaves(want_tree)]
    assert [g.shape for g in got] == [w.shape for w in want]
    diff = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    assert diff.max() <= PARAM_ATOL, diff.max()
    assert np.mean(diff <= CLOSE_ATOL) >= CLOSE_SHARE, np.mean(
        diff <= CLOSE_ATOL)


def test_backbone_and_forward_match_jax(ref):
    """Default positions take the fused route on both sides; custom ones
    the plain attention route."""
    cfg = ref["cfg"]
    assert fa.supports(SEQ, cfg.head_dim, cfg.dtype)
    tokens = ref["batches"][0][:, :-1]
    positions = np.tile(np.arange(SEQ, dtype=np.int32) + 5, (BATCH, 1))
    want_moved = j_llama.backbone(jax.tree.map(jnp.asarray, ref["init"]),
                                  jnp.asarray(tokens), ref["jcfg"],
                                  positions=jnp.asarray(positions))
    with torch.no_grad():
        hidden = llama.backbone(_port_params(ref), torch.from_numpy(tokens),
                                cfg)
        logits = llama.forward(_port_params(ref, unstacked=True),
                               torch.from_numpy(tokens), cfg)
        moved = llama.backbone(_port_params(ref), torch.from_numpy(tokens),
                               cfg, positions=torch.from_numpy(positions))
    assert logits.dtype == torch.float32
    for got, want in ((hidden, ref["hidden"]), (logits, ref["logits"]),
                      (moved, np.asarray(want_moved))):
        np.testing.assert_allclose(got.numpy(), want, atol=HIDDEN_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("unstacked", [False, True],
                         ids=["stacked", "unstacked"])
def test_train_steps_match_jax(ref, unstacked):
    opt, state = _port_state(ref, unstacked)
    step_fn = train.make_train_step(ref["cfg"], opt, remat=False)
    for i, b in enumerate(ref["batches"]):
        state, metrics = step_fn(state, {"tokens": torch.from_numpy(b)})
        assert metrics["step"] == i + 1
        np.testing.assert_allclose(metrics["loss"].item(), ref["losses"][i],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(metrics["grad_norm"].item(),
                                   ref["norms"][i], rtol=LOSS_RTOL)
    final = _np_tree(j_llama.unstack_params(ref["final"])) if unstacked \
        else ref["final"]
    _assert_params_close(state.params, final)
