"""AdamW's step on the CPU (no JAX): the plain path against the three
passes it has always run, the kernel path's Python side with the launch
replaced by a recorder (its table, chunks, flags and counters, read
against the C entry point's parameters by name), the wrapper's refusals,
and the state it keeps for the snapshots and the benchmark.
``chip_smoke.py`` holds the kernel itself to the plain path on the card.
"""

import re

import pytest
import torch

from dstack_tpu_torch.models import checkpoint, train
from dstack_tpu_torch.ops import _build, adamw, flash_attention


def _three_passes(params, grads, opt_state, grad_clip):
    """The optimizer's step as ``AdamW.update`` ran it before the kernel,
    unsharded: the norms, the clip's multiply, torch's fused AdamW."""
    grads = list(grads)
    norm = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(grads, 2, dtype=torch.float32)))
    torch._foreach_mul_(grads, grad_clip / torch.clamp_min(norm, grad_clip))
    for p, g in zip(params, grads):
        p.grad = g.contiguous()
    opt_state.step()
    opt_state.zero_grad(set_to_none=True)
    return norm


#: leaves of each case: shape and dtype; "head" is given a transposed
#: gradient (a tied head's)
LEAVES = {
    "bf16": {"embed": ((48, 16), torch.bfloat16),
             "norm": ((16,), torch.bfloat16),
             "wq": ((2, 16, 24), torch.bfloat16)},
    "mixed": {"embed": ((48, 16), torch.bfloat16),
              "router": ((16, 4), torch.float32),
              "w_up": ((4, 16, 8), torch.bfloat16)},
    "odd": {"a": ((5, 7), torch.bfloat16), "b": ((3,), torch.float32),
            "c": ((13, 3), torch.bfloat16)},
    "tied": {"head": ((24, 16), torch.bfloat16),
             "norm": ((16,), torch.bfloat16)},
}
#: gradient scales: a global norm far above the clip of 1, and below it
SCALES = {"above": 1.0, "below": 1e-3}


def _leaves(case, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).mul_(0.02).to(dtype)
            for shape, dtype in LEAVES[case].values()]


def _grads(case, scale, seed):
    gen = torch.Generator().manual_seed(1000 + seed)
    out = []
    for name, (shape, dtype) in LEAVES[case].items():
        if name == "head":
            g = torch.randn(shape[::-1], generator=gen).t()
        else:
            g = torch.randn(shape, generator=gen)
        out.append((g * scale).to(dtype))
    return out


def _optimizer(leaves):
    opt = train.default_optimizer()
    return opt, torch.optim.AdamW(leaves, lr=opt.lr, betas=(opt.b1, opt.b2),
                                  eps=opt.eps, weight_decay=opt.weight_decay,
                                  fused=True)


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), (a - b).abs().max()


@pytest.mark.parametrize("scale", sorted(SCALES))
@pytest.mark.parametrize("case", sorted(LEAVES))
def test_plain_path_is_the_three_passes_bit_for_bit(case, scale):
    """Three steps of ``AdamW.update`` on CPU leaves equal the three passes
    on a copy, bit for bit: parameters, both moments, the step count and
    the returned norm (whether the norm is above or below the clip, bf16
    and f32 leaves mixed, element counts off multiples of 8, a transposed
    gradient); the state then resumes at step 3 and takes three more."""
    ours = _leaves(case)
    theirs = [p.clone() for p in ours]
    opt, ours_state = _optimizer(ours)
    _, theirs_state = _optimizer(theirs)
    for step in range(3):
        g = _grads(case, SCALES[scale], step)
        norm = opt.update(ours, [t.clone() for t in g], ours_state)
        want = _three_passes(theirs, g, theirs_state, opt.grad_clip)
        _assert_same(norm, want)
        assert (norm.item() > opt.grad_clip) == (scale == "above")
    # resumed: a fresh optimizer given the state at step 3 as a snapshot
    # restore gives it (checkpoint.read_snapshot)
    _, resumed = _optimizer(ours)
    for p in ours:
        resumed.state[p] = {k: v.clone()
                            for k, v in ours_state.state[p].items()}
    for step in range(3, 6):
        g = _grads(case, SCALES[scale], step)
        _assert_same(opt.update(ours, [t.clone() for t in g], resumed),
                     _three_passes(theirs, g, theirs_state, opt.grad_clip))
    for p, q in zip(ours, theirs):
        _assert_same(p, q)
        for key in ("step", "exp_avg", "exp_avg_sq"):
            _assert_same(resumed.state[p][key], theirs_state.state[q][key])
    assert float(resumed.state[ours[0]]["step"]) == 6.0


def test_plain_path_clips_the_gradients_in_place():
    """On the CPU the clipped gradients are left in ``grads``, as before."""
    leaves = _leaves("mixed")
    opt, state = _optimizer(leaves)
    grads = _grads("mixed", 1.0, 0)
    want = [g.clone() for g in grads]
    norm = opt.update(leaves, grads, state)
    assert norm.item() > opt.grad_clip
    torch._foreach_mul_(want, opt.grad_clip / norm)
    for g, w in zip(grads, want):
        _assert_same(g, w)


# -- the kernel path's Python side, the launch recorded

def _entry_names():
    """The C entry point's parameter names, in order."""
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / "adamw.cu").read_text())
    params = re.search(r'extern\s+"C"\s+int\s+dstack_adamw\s*\(([^)]*)\)',
                       text).group(1)
    return [p.replace("*", " ").split()[-1] for p in params.split(",")]


@pytest.fixture
def launches(monkeypatch):
    calls = []

    def launch(name, *args):
        assert name == "adamw"
        names = _entry_names()
        assert len(args) + 1 == len(names) == len(
            _build.SIGNATURES["adamw"][1])
        call = dict(zip(names, args))
        call["rows"] = call["table"].tolist()
        calls.append(call)

    monkeypatch.setattr(flash_attention, "_launch", launch)
    monkeypatch.setattr(flash_attention, "_sm_count", lambda index: 132)
    monkeypatch.setattr(adamw, "norm_launches", 0)
    monkeypatch.setattr(adamw, "step_launches", 0)
    return calls


def test_launch_arguments_name_the_entry_points_parameters(launches):
    """One norm launch over every leaf, then one step launch a dtype, each
    argument on the C parameter of its meaning: the table's rows hold the
    leaf's, its gradient's and its state's pointers, the element count and
    the flags; the hyperparameters are the optimizer group's."""
    leaves = _leaves("mixed")
    opt, state = _optimizer(leaves)
    grads = _grads("mixed", 1.0, 0)
    norm = adamw._kernel_update(leaves, grads, state, opt.grad_clip)
    assert [c["phase"] for c in launches] == [0, 1, 1]
    first, *steps = launches
    assert first["leaves"] == 3 and (first["first"], first["last"]) == (1, 1)
    assert first["blocks"] == 132 * adamw._NORM_BLOCKS_PER_SM
    assert first["partials"].shape == (first["blocks"],)
    assert first["counter"].dtype == torch.int32 and first["norm"] is None
    for p, g, row in zip(leaves, grads, first["rows"]):
        s = state.state[p]
        assert row == [p.data_ptr(), g.data_ptr(), s["exp_avg"].data_ptr(),
                       s["exp_avg_sq"].data_ptr(), s["step"].data_ptr(),
                       p.numel(), adamw._DTYPES[p.dtype] | adamw._IN_NORM]
    assert [(c["dtype"], c["leaves"]) for c in steps] == [(0, 1), (1, 2)]
    assert steps[0]["rows"] == [first["rows"][1]]
    assert steps[1]["rows"] == [first["rows"][0], first["rows"][2]]
    for c in steps:
        assert c["sumsq"] is first["sumsq"] and c["sumsq"].shape == ()
        assert (c["lr"], c["beta1"], c["beta2"], c["weight_decay"],
                c["eps"], c["clip"]) == (opt.lr, opt.b1, opt.b2,
                                         opt.weight_decay, opt.eps,
                                         opt.grad_clip)
        assert c["partials"] is None and c["counter"] is None
    assert all(c["norm"] is norm for c in steps) and norm.shape == ()
    assert (adamw.norm_launches, adamw.step_launches) == (1, 2)


def test_a_transposed_gradient_is_made_contiguous(launches):
    leaves = _leaves("tied")
    opt, state = _optimizer(leaves)
    grads = _grads("tied", 1.0, 0)
    assert not grads[0].is_contiguous()
    adamw._kernel_update(leaves, grads, state, opt.grad_clip)
    assert launches[0]["rows"][0][1] != grads[0].data_ptr()


@pytest.mark.parametrize("count,norm_calls,step_calls", [
    (64, [(64, 1, 1)], [64]),
    (65, [(64, 1, 0), (1, 0, 1)], [64, 1]),
    (130, [(64, 1, 0), (64, 0, 0), (2, 0, 1)], [64, 64, 2])])
def test_a_long_table_is_split_into_launches(launches, count, norm_calls,
                                             step_calls):
    """An unstacked state's hundreds of leaves: launches of at most
    MAX_LEAVES rows, the norm's partials started by the first and summed
    by the last; every launch is counted."""
    leaves = [torch.zeros(9, dtype=torch.bfloat16) for _ in range(count)]
    opt, state = _optimizer(leaves)
    adamw._kernel_update(leaves, [torch.ones_like(p) for p in leaves],
                         state, opt.grad_clip)
    norms = [c for c in launches if c["phase"] == 0]
    assert [(c["leaves"], c["first"], c["last"]) for c in norms] == \
        norm_calls
    assert [len(c["rows"]) for c in norms] == [n for n, _, _ in norm_calls]
    assert [c["leaves"] for c in launches if c["phase"] == 1] == step_calls
    assert [r[-1] for c in norms for r in c["rows"]] == [
        1 | adamw._IN_NORM] * count
    assert (adamw.norm_launches, adamw.step_launches) == (
        len(norm_calls), len(step_calls))


@pytest.mark.parametrize("case,steps", [("bf16", 1), ("mixed", 2)])
def test_a_train_step_counts_one_norm_launch_and_one_step_launch_a_dtype(
        launches, case, steps):
    leaves = _leaves(case)
    opt, state = _optimizer(leaves)
    for i in range(2):
        adamw._kernel_update(leaves, _grads(case, 1.0, i), state,
                             opt.grad_clip)
    assert (adamw.norm_launches, adamw.step_launches) == (2, 2 * steps)


def _bad(leaves, grads, state, match):
    with pytest.raises(ValueError, match=match):
        adamw._kernel_update(leaves, grads, state, 1.0)


def test_the_kernel_path_refuses_what_the_kernel_does_not_take(launches):
    """A non-contiguous leaf or moment, a gradient or moment of another
    dtype or shape, tensors on two devices, an integer leaf: raised before
    any launch."""
    leaves = _leaves("bf16")
    grads = _grads("bf16", 1.0, 0)
    bent = [leaves[0], leaves[1], leaves[2].transpose(1, 2)]
    _bad(bent, [grads[0], grads[1], grads[2].transpose(1, 2)],
         _optimizer(bent)[1], "contiguous")
    _bad(leaves, [grads[0], grads[1].float(), grads[2]],
         _optimizer(leaves)[1], "share their dtype")
    _bad(leaves, [grads[0], grads[1], grads[2][:, :8]],
         _optimizer(leaves)[1], "shape")
    _bad(leaves, [grads[0], grads[1].to("meta"), grads[2]],
         _optimizer(leaves)[1], "one device")
    ints = [torch.zeros(4, dtype=torch.int32)]
    _bad(ints, [torch.zeros(4, dtype=torch.int32)], torch.optim.AdamW(
        [torch.zeros(4)], fused=False), "bf16 or f32")
    state = _optimizer(leaves)[1]
    adamw.state_of(state, leaves[0])["exp_avg"] = torch.zeros(
        48, 16, dtype=torch.float32)
    _bad(leaves, grads, state, "share their dtype")
    state = _optimizer(leaves)[1]
    adamw.state_of(state, leaves[1])["exp_avg_sq"] = torch.zeros(
        32, dtype=torch.bfloat16)[::2]
    _bad(leaves, grads, state, "contiguous")
    assert launches == []


def test_update_refuses_a_device_it_does_not_step():
    leaves = [torch.zeros(4, device="meta")]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        adamw.update(leaves, [torch.zeros(4, device="meta")],
                     _optimizer(leaves)[1], 1.0)


def test_the_state_is_torchs_layout_for_snapshots_and_the_benchmark(
        launches):
    """The kernel path makes each leaf's state as torch's fused AdamW makes
    it at its first step (the plain path's, on a copy): the same keys,
    dtypes, shapes, strides and devices, ``step`` an f32 0-dim tensor; the
    snapshot's leaves read it, and ``exp_avg`` sits where the benchmark
    reads the first gradient."""
    leaves = _leaves("mixed")
    opt, state = _optimizer(leaves)
    adamw._kernel_update(leaves, _grads("mixed", 1.0, 0), state,
                         opt.grad_clip)
    copies = [p.clone() for p in leaves]
    _, plain = _optimizer(copies)
    _three_passes(copies, _grads("mixed", 1.0, 0), plain, opt.grad_clip)
    for p, q in zip(leaves, copies):
        ours, theirs = state.state[p], plain.state[q]
        assert list(ours) == list(theirs) == ["step", "exp_avg",
                                             "exp_avg_sq"]
        for key in ours:
            a, b = ours[key], theirs[key]
            assert (a.dtype, a.shape, a.stride(), a.device) == (
                b.dtype, b.shape, b.stride(), b.device), key
        assert ours["step"].dtype == torch.float32 and ours["step"].dim() == 0
        assert state.state[p].get("exp_avg") is ours["exp_avg"]
    params = {"embed": leaves[0], "final_norm": torch.ones(16),
              "layers": {"router": leaves[1], "w_up": leaves[2]}}
    ts = train.TrainState(params=params, opt_state=state, step=0)
    items = dict(checkpoint.state_leaves(ts))
    mu = {k: v for k, v in items.items() if ".mu" in k}
    assert any(v is state.state[leaves[1]]["exp_avg"] for v in mu.values())
    assert int(items[f"{checkpoint._ADAM_PATH}.count"]) == 0


def test_the_wrapper_constants_are_the_kernels():
    """MAX_LEAVES, the table's columns and flags as ``csrc/adamw.cu``
    reads them."""
    text = (_build.CSRC / "adamw.cu").read_text()
    assert re.search(r"kMaxLeaves = (\d+);", text).group(1) == str(
        adamw.MAX_LEAVES)
    cols = re.search(r"enum Col \{([^}]*)\}", text).group(1)
    assert [c.strip() for c in cols.split(",")].index("kFlags") == \
        adamw._FLAGS
    assert re.search(r"kBf16 = (\d+);", text).group(1) == str(
        adamw._DTYPES[torch.bfloat16])
    assert re.search(r"kInNorm = (\d+);", text).group(1) == str(
        adamw._IN_NORM)
