"""The row kernel's plain versions and its Python side, on the CPU (no JAX).

``rownorm.rows_fwd_plain`` / ``rows_bwd_plain`` are the arithmetic
``csrc/rownorm.cu`` does;
``chip_smoke.py`` holds the kernel to them on the card.  Here they are held
to autograd of the eager chain the layers ran before (``rms_norm`` then
``apply_rope``), the cos/sin table to ``apply_rope``'s own angles, the CPU
paths to the plain torch they were, a layer through ``qk_prologue`` to the
layer through that chain, and the launch's arguments to the C entry point's
parameters by name.
"""

import collections
import re
import types

import pytest
import torch

from dstack_tpu_torch.models import llama
from dstack_tpu_torch.ops import _build, flash_attention, rmsnorm, rotary, \
    rownorm
from dstack_tpu_torch.ops.rotary import RopeScaling

EPS = 1e-5
#: head rows at head_dim 64 and 128, and D-wide rows
SHAPES = [(2, 12, 4, 64), (2, 12, 3, 128), (1, 6, 1, 2048)]
MODES = ["norm", "rope", "both", "neither"]


def _rand(shape, dtype, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype)


def _eager_rms_norm(x, w, eps):
    """``rms_norm`` as the layers ran it before the kernel."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def _inputs(shape, dtype, mode, seed=0, batch_positions=False):
    b, s, _, d = shape
    x = _rand(shape, dtype, seed, 3.0)
    w = (1 + _rand((d,), torch.float32, seed + 1, 0.1)).to(dtype)
    positions = (torch.arange(s)[None, :] + 5 * torch.arange(b)[:, None]
                 if batch_positions else torch.arange(s)[None, :])
    inv = torch.from_numpy(rotary.rope_frequencies(d, 10_000.0))
    return (x, w if mode in ("norm", "both") else None,
            positions if mode in ("rope", "both") else None, inv)


def _chain(x, w, positions, inv):
    y = x if w is None else _eager_rms_norm(x, w, EPS)
    return y if positions is None else rotary.apply_rope(y, positions, inv)


def _ulps(got, want):
    """The largest |got - want| in bf16 ulps of its row's largest |want|
    (rows: the last dimension), as chip_smoke holds the kernel."""
    want32, got32 = want.float(), got.float()
    top = want32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    return float(((got32 - want32).abs()
                  / torch.exp2(torch.floor(torch.log2(top)) - 7)).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"d{s[-1]}")
@pytest.mark.parametrize("mode", MODES[:3])
def test_plain_versions_match_autograd_of_the_eager_chain(mode, shape, dtype):
    """The forward is the chain's operations, so bit for bit; the backward
    is the chain's arithmetic in closed form.  Tolerance, in bf16 ulps of
    the row's largest value: 1 for bf16 (the closed form multiplies in
    another order than autograd, a few f32 ulps that can flip one bf16
    rounding), 0.001 for f32 (those f32 ulps alone)."""
    x, w, positions, inv = _inputs(shape, dtype, mode)
    table = None if positions is None else rotary.rope_table(positions, inv)
    xr = x.clone().requires_grad_(True)
    wr = None if w is None else w.clone().requires_grad_(True)
    want = _chain(xr, wr, positions, inv)
    got, rstd = rownorm.rows_fwd_plain(x, w, table, EPS)
    assert torch.equal(got, want.detach())
    dy = _rand(shape, dtype, 7)
    want.backward(dy)
    dx, dw = rownorm.rows_bwd_plain(x, w, table, rstd, dy)
    limit = 1.0 if dtype == torch.bfloat16 else 1e-3
    assert dx.dtype == x.dtype and _ulps(dx, xr.grad) <= limit
    if w is None:
        assert dw is None and rstd is None
    else:
        assert dw.dtype == w.dtype and _ulps(dw, wr.grad) <= limit


def test_rms_norm_plain_names_are_the_row_arithmetic():
    x, w, _, _ = _inputs((3, 5, 1, 2048), torch.bfloat16, "norm")
    """``rms_norm`` is the row arithmetic without a rotation: its CPU
    path equals the plain forward, whose rstd the plain backward takes,
    and the backward equals autograd of that path (ulps as above)."""
    y, rstd = rownorm.rows_fwd_plain(x, w, None, EPS)
    assert torch.equal(y, rmsnorm.rms_norm(x, w, EPS))
    assert rstd.shape == x.shape[:-1] and rstd.dtype == torch.float32
    dy = _rand(x.shape, x.dtype, 3)
    dx, dw = rownorm.rows_bwd_plain(x, w, None, rstd, dy)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    rmsnorm.rms_norm(xr, wr, EPS).backward(dy)
    assert _ulps(dx, xr.grad) <= 1.0 and _ulps(dw, wr.grad) <= 1.0


def test_neither_norm_nor_rope_hands_back_q_and_k():
    q, k = _rand((1, 4, 2, 16), torch.bfloat16, 0), _rand(
        (1, 4, 1, 16), torch.bfloat16, 1)
    out = rotary.qk_prologue(q, k)
    assert out[0] is q and out[1] is k
    with pytest.raises(ValueError, match="both"):
        rotary.qk_prologue(q, k, q_w=torch.ones(16))


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "llama3"])
@pytest.mark.parametrize("batch_positions", [False, True],
                         ids=["P1", "PB"])
def test_rope_table_is_apply_ropes_angles_bit_for_bit(scaled,
                                                      batch_positions):
    scaling = RopeScaling(factor=8.0, original_max_position=64) if scaled \
        else None
    x, _, positions, _ = _inputs((2, 40, 3, 64), torch.bfloat16, "rope",
                                 batch_positions=batch_positions)
    positions = positions * 7 + 3
    inv = torch.from_numpy(rotary.rope_frequencies(64, 500_000.0, scaling))
    table = rotary.rope_table(positions, inv)
    angles = positions[..., :, None].float() * inv
    assert table.shape == (2, positions.shape[0], 40, 32)
    assert table.dtype == torch.float32
    assert torch.equal(table[0], torch.cos(angles))
    assert torch.equal(table[1], torch.sin(angles))
    assert torch.equal(rownorm.rotate_half(x, *rownorm.table_cos_sin(table)),
                       rotary.apply_rope(x, positions, inv))
    # one row of positions [S] is P = 1
    assert torch.equal(rotary.rope_table(positions[0], inv),
                       rotary.rope_table(positions[:1], inv))


def test_cpu_paths_keep_the_plain_torch_bit_for_bit():
    """rms_norm on the CPU is the plain chain it was (the JAX parity tests
    of test_torch_ops read it), gradients too; qk_prologue on the CPU is
    rms_norm then apply_rope's arithmetic, and launches nothing."""
    x, w, positions, inv = _inputs((2, 8, 4, 64), torch.bfloat16, "both")
    before = (rmsnorm.rms_norm.launches, rotary.qk_prologue.launches)
    runs = []
    for fn in (rmsnorm.rms_norm, _eager_rms_norm):
        xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(
            True)
        y = fn(xr, wr, EPS)
        y.backward(_rand(x.shape, x.dtype, 5))
        runs.append((y, xr.grad, wr.grad))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    k = _rand((2, 8, 2, 64), torch.bfloat16, 9)
    kw = w.flip(0)
    table = rotary.rope_table(positions, inv)
    grads = []
    for route in ("prologue", "chain"):
        qr, kr = x.clone().requires_grad_(True), k.clone().requires_grad_(
            True)
        wq, wk = w.clone().requires_grad_(True), kw.clone().requires_grad_(
            True)
        if route == "prologue":
            out = rotary.qk_prologue(qr, kr, wq, wk, table, EPS)
        else:
            out = (_chain(qr, wq, positions, inv), _chain(kr, wk, positions,
                                                          inv))
        (out[0].float().sum() * 3 + out[1].float().square().sum()).backward()
        grads.append([*out, qr.grad, kr.grad, wq.grad, wk.grad])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert (rmsnorm.rms_norm.launches, rotary.qk_prologue.launches) == before


@pytest.mark.parametrize("weights_grad", [True, False],
                         ids=["dw", "frozen"])
def test_row_function_carries_both_tensors_through_autograd(weights_grad):
    """The autograd function the kernel runs in, here over the plain
    versions: q and k in one call, the weight gradient only where wanted,
    each gradient within the plain-versions test's tolerance of the
    chain's."""
    shape_q, shape_k = (2, 12, 4, 128), (2, 12, 2, 128)
    q, wq, positions, inv = _inputs(shape_q, torch.bfloat16, "both", 0)
    k, wk, _, _ = _inputs(shape_k, torch.bfloat16, "both", 10)
    table = rotary.rope_table(positions, inv)
    dq, dk = _rand(shape_q, q.dtype, 20), _rand(shape_k, k.dtype, 21)
    runs = []
    for route in ("function", "chain"):
        leaves = [q.clone().requires_grad_(True), wq.clone(),
                  k.clone().requires_grad_(True), wk.clone()]
        if weights_grad:
            leaves[1].requires_grad_(True)
            leaves[3].requires_grad_(True)
        if route == "function":
            out = rownorm._RowNorm.apply(
                rownorm._plain_fwd, rownorm._plain_bwd,
                types.SimpleNamespace(), table, EPS, *leaves)
        else:
            out = (_chain(leaves[0], leaves[1], positions, inv),
                   _chain(leaves[2], leaves[3], positions, inv))
        torch.autograd.backward(out, (dq, dk))
        runs.append((out, [t.grad for t in leaves]))
    (out, grads), (want, want_grads) = runs
    assert all(torch.equal(a, b.detach()) for a, b in zip(out, want))
    for got, ref in zip(grads, want_grads):
        assert (got is None) == (ref is None)
        if got is not None:
            assert _ulps(got, ref) <= 1.0


def _layer_weights(cfg, kind, seed=0):
    d, hd = cfg.hidden_size, cfg.head_dim
    shapes = {"attn_norm": (d,), "mlp_norm": (d,),
              "wq": (d, cfg.num_heads * hd), "wk": (d, cfg.num_kv_heads * hd),
              "wv": (d, cfg.num_kv_heads * hd), "wo": (cfg.num_heads * hd, d),
              "w_gate": (d, cfg.intermediate_size),
              "w_up": (d, cfg.intermediate_size),
              "w_down": (cfg.intermediate_size, d)}
    if kind.qk_norm:
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    if kind.gate:
        shapes["w_attn_gate"] = (d, cfg.num_heads * hd)
    if kind.sandwich:
        shapes.update(post_attn_norm=(d,), post_mlp_norm=(d,))
    out = {}
    for i, (name, shape) in enumerate(sorted(shapes.items())):
        t = _rand(shape, torch.float32, seed + i, 0.1 if len(shape) == 1
                  else shape[0] ** -0.5)
        out[name] = (t + 1 if len(shape) == 1 else t).to(cfg.dtype)
    return out


KINDS = {
    "llama": llama.LayerKind(),
    "trinity-sliding": llama.LayerKind(window=6, rope=True, qk_norm=True,
                                       gate=True, sandwich=True),
    "trinity-full": llama.LayerKind(rope=False, qk_norm=True, gate=True,
                                    sandwich=True),
}


@pytest.mark.parametrize("remat", ["none", "selective"])
@pytest.mark.parametrize("name", sorted(KINDS))
def test_layer_through_qk_prologue_equals_the_eager_layer(name, remat,
                                                          monkeypatch):
    """A ``_layer_fn`` layer forward and backward on the CPU, bit for bit
    the layer whose q and k went through rms_norm and apply_rope."""
    kind = KINDS[name]
    cfg = llama.LlamaConfig.tiny(dtype=torch.bfloat16)
    b, s = 2, 16
    positions = torch.arange(s)[None, :]
    inv = torch.from_numpy(rotary.rope_frequencies(
        cfg.head_dim, cfg.rope_theta, cfg.rope_scaling))
    layout = llama.Layout(None, llama.ShardingPolicy(), cfg)
    specs = collections.defaultdict(lambda: None)
    weights = _layer_weights(cfg, kind)
    x = _rand((b, s, cfg.hidden_size), cfg.dtype, 99)
    dy = _rand((b, s, cfg.hidden_size), cfg.dtype, 98)

    def eager(q, k, q_w, k_w, rope, eps):
        assert eps == cfg.rms_eps
        if q_w is not None:
            q, k = _eager_rms_norm(q, q_w, eps), _eager_rms_norm(k, k_w, eps)
        if rope is not None:
            q, k = (rotary.apply_rope(q, positions, inv),
                    rotary.apply_rope(k, positions, inv))
        return q, k

    runs = []
    for route in ("prologue", "eager"):
        if route == "eager":
            monkeypatch.setattr(llama, "qk_prologue", eager)
        layer = llama._layer_fn(cfg, positions,
                                rotary.rope_table(positions, inv), False,
                                llama.remat_names(remat), layout, specs, kind)
        lp = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
        xr = x.clone().requires_grad_(True)
        y = layer(xr, lp)
        y.backward(dy)
        runs.append((y, xr.grad, {k: v.grad for k, v in lp.items()}))
    (y, dx, dw), (y0, dx0, dw0) = runs
    assert torch.equal(y, y0) and torch.equal(dx, dx0)
    assert dw.keys() == dw0.keys()
    assert all(torch.equal(dw[k], dw0[k]) for k in dw)


def _entry_names():
    """The C entry point's parameter names, in order."""
    text = re.sub(r"//[^\n]*", "", (_build.CSRC / "rownorm.cu").read_text())
    params = re.search(r'extern\s+"C"\s+int\s+dstack_rownorm\s*\(([^)]*)\)',
                       text).group(1)
    return [p.replace("*", " ").split()[-1] for p in params.split(",")]


def _captured(monkeypatch):
    calls = []

    def launch(name, *args):
        assert name == "rownorm"
        names = _entry_names()
        assert len(args) + 1 == len(names) == len(
            _build.SIGNATURES["rownorm"][1])
        calls.append(dict(zip(names, args)))

    monkeypatch.setattr(flash_attention, "_launch", launch)
    monkeypatch.setattr(flash_attention, "_sm_count", lambda index: 132)
    return calls


def test_launch_arguments_name_the_entry_points_parameters(monkeypatch):
    """q and k (one launch each way) and a D-wide rms_norm, with the kernel
    launch replaced by a recorder: each argument lands on the C parameter
    of its meaning (read from the source), without a card."""
    calls = _captured(monkeypatch)
    q, wq, positions, inv = _inputs((2, 12, 4, 64), torch.bfloat16, "both")
    k, wk, _, _ = _inputs((2, 12, 2, 64), torch.bfloat16, "both", 3)
    table = rotary.rope_table(positions, inv)
    ys, rstds = rownorm._kernel_fwd((q, k), (wq, wk), table, EPS,
                                    rotary.qk_prologue)
    fwd = calls[-1]
    assert fwd["x0"] is q and fwd["x1"] is k and fwd["out0"] is ys[0]
    assert fwd["w0"] is wq and fwd["w1"] is wk and fwd["table"] is table
    assert fwd["rstd0"] is rstds[0] and rstds[1].shape == (2, 12, 2)
    assert (fwd["rows0"], fwd["rows1"], fwd["n"], fwd["heads0"],
            fwd["heads1"], fwd["seq"], fwd["table_batch"]) == (
        96, 48, 64, 4, 2, 12, 1)
    assert (fwd["dtype"], fwd["w_dtype"], fwd["backward"], fwd["eps"]) == (
        1, 1, 0, EPS)
    assert fwd["dy0"] is None and fwd["part"] is None
    dys = (torch.ones_like(q), torch.ones_like(k))
    dxs, dws = rownorm._kernel_bwd((q, k), (wq, wk), table, rstds, dys,
                                   [True, False], rotary.qk_prologue)
    bwd = calls[-1]
    assert bwd["dy0"] is dys[0] and bwd["out1"] is dxs[1]
    assert bwd["dw0"] is dws[0] and dws[1] is None and bwd["dw1"] is None
    assert bwd["backward"] == 1 and bwd["part_rows"] == 8 * 132
    assert bwd["part"].shape == (8 * 132, 64)
    x = _rand((5, 7, 2048), torch.float32, 4)
    w = torch.ones(2048, dtype=torch.bfloat16)
    rownorm._kernel_fwd((x,), (w,), None, EPS, rmsnorm.rms_norm, keep=False)
    one = calls[-1]
    assert one["x1"] is None and one["rows1"] == 0 and one["rows0"] == 35
    assert one["rstd0"] is None and (one["dtype"], one["w_dtype"]) == (0, 1)
    assert (one["n"], one["heads0"], one["seq"], one["table_batch"]) == (
        2048, 1, 1, 1)


@pytest.mark.parametrize("rope", [True, False], ids=["rope", "norm"])
def test_launches_are_counted_by_whether_they_rotate(monkeypatch, rope):
    """Every launch counts on ``launches`` / ``bwd_launches``; one with a
    rotation table on ``rope_launches`` / ``rope_bwd_launches`` too."""
    _captured(monkeypatch)
    q, wq, positions, inv = _inputs((2, 12, 4, 64), torch.bfloat16, "both")
    k, wk, _, _ = _inputs((2, 12, 2, 64), torch.bfloat16, "both", 3)
    table = rotary.rope_table(positions, inv) if rope else None
    counter = types.SimpleNamespace(launches=0, bwd_launches=0,
                                    rope_launches=0, rope_bwd_launches=0)
    for _ in range(3):
        _, rstds = rownorm._kernel_fwd((q, k), (wq, wk), table, EPS, counter)
    for _ in range(2):
        rownorm._kernel_bwd((q, k), (wq, wk), table, rstds,
                            (torch.ones_like(q), torch.ones_like(k)),
                            [True, True], counter)
    assert (counter.launches, counter.bwd_launches) == (3, 2)
    assert (counter.rope_launches, counter.rope_bwd_launches) == (
        (3, 2) if rope else (0, 0))


@pytest.mark.parametrize("case", [
    "f16 rows", "odd width", "weight width", "mixed weights", "table shape",
    "one weight", "dtensor"])
def test_kernel_checks_refuse_what_it_does_not_take(case):
    q, wq, positions, inv = _inputs((2, 8, 4, 64), torch.bfloat16, "both")
    k, wk = q[:, :, :2].contiguous(), wq.clone()
    table = rotary.rope_table(positions, inv)
    args = [(q, k), (wq, wk), table]
    if case == "f16 rows":
        args[0] = (q.half(), k.half())
    elif case == "odd width":
        args = [(q[..., :40].contiguous(),), (None,), None]
    elif case == "weight width":
        args[1] = (wq[:32], wk[:32])
    elif case == "mixed weights":
        args[1] = (wq, wk.float())
    elif case == "table shape":
        args[2] = table[:, :, :4]
    elif case == "one weight":
        args[1] = (wq, None)
    else:
        class Sharded(torch.Tensor):
            def to_local(self):
                return self

        args[0] = (q.as_subclass(Sharded), k)
    with pytest.raises((ValueError, TypeError)):
        rownorm._check(*args)
    rownorm._check((q, k), (wq, wk), table)


def test_the_kernel_path_refuses_a_cpu_tensor():
    x = torch.ones(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        rownorm.apply_rows(rmsnorm.rms_norm, (x,), (torch.ones(64),), None,
                           EPS)
