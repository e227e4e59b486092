"""The deepseek_v3 family (Kanana-2): a tiny cell trains through the port
on the CPU with every check ok; a reference with a planted fault fails it
(so the check runs the family's own latent attention); the yardsticks
count what the cell's shape asks; the new readers read what they name,
and the older readers do not read the latent kernels; the family refuses
what it does not compute; and a checkout whose port has no deepseek model
refuses the cell at once."""

import json
import re
import shutil
import sys
import types

import pytest

from portbench import harness, readers, spec
from portbench.families import deepseek_v3
from portbench.frozen import bounds
from portbench.tests.conftest import BIG_SEED, DATA

#: faults planted in a copy of the family's reference: (text, replacement)
FAULTS = {
    "rope_over_all_192": ("    first = nope  # q's and k's first rotated",
                          "    first = 0  # q's and k's first rotated"),
    "split_halves_on_the_published_layout": (
        "    x = x.view(n, h, d // 2, 2).transpose(-1, -2).reshape(n, h, d)",
        "    x = x"),
    "no_latent_norm": (
        '    c = model.rms_norm(ckv[..., :rank], w["kv_norm"], eps)',
        "    c = ckv[..., :rank]"),
    "scale_of_the_nope_width": (
        "    a = attention(q, k, kv[..., nope:], (nope + rope) ** -0.5)",
        "    a = attention(q, k, kv[..., nope:], nope ** -0.5)"),
}
CELL = "kanana2-train-s16384"


def _root_with_family(tmp_path, source=None):
    """A copy of the benchmark with the tiny deepseek cell's files, and the
    family's source replaced by ``source`` where given."""
    root = tmp_path / "portbench"
    shutil.copytree(spec.HERE, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    for kind, name in (("configs", "tiny-deepseek"), ("traffic", "train-tiny"),
                       ("cells", "tiny-deepseek-train")):
        shutil.copy(DATA / kind / f"{name}.json", root / kind)
    if source is not None:
        (root / "families" / "deepseek_v3.py").write_text(source)
    return root


def test_the_tiny_deepseek_cell_trains_with_every_check_ok():
    cell = spec.find("tiny-deepseek-train", DATA)
    cfg = cell.model_config()
    assert cfg.held_experts == (0, 4) and cfg.num_experts == 8
    assert cfg.attn_widths == (24, 16)
    out = harness.run_cell(cell, BIG_SEED, 0.0, False, device="cpu")
    assert out.checks and all(c.ok for c in out.checks), out.checks
    assert {c.name for c in out.checks} == {"loss_gap", "grad_gap",
                                            "update_gap", "router_gap"}
    line = harness.result_line(cell, out, True, harness.device_of("cpu"))
    # no trace on the CPU: the device readers find nothing and are left out
    assert set(line["metrics"]) == {"mfu.train"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_reference_fault_fails_the_check(tmp_path, fault):
    text, planted = FAULTS[fault]
    source = (spec.HERE / "families" / "deepseek_v3.py").read_text()
    assert source.count(text) == 1
    root = _root_with_family(tmp_path, source.replace(text, planted))
    cell = spec.find("tiny-deepseek-train", root)
    out = harness.run_cell(cell, BIG_SEED, 0.0, False, device="cpu")
    assert out.checks and not all(c.ok for c in out.checks), out.checks


def test_a_port_without_deepseek_refuses_the_cell_at_once(monkeypatch):
    """The parent of the change that brings the model: ``port_config``
    raises before a weight is drawn."""
    monkeypatch.setitem(sys.modules, "dstack_tpu_torch.models.deepseek", None)
    cell = spec.find(CELL)
    with pytest.raises(ImportError):
        cell.model_config()


@pytest.mark.parametrize("key,value", [
    ("q_lora_rank", 1536), ("rope_scaling", {"type": "yarn"}), ("n_group", 8),
    ("topk_group", 4), ("topk_method", "greedy"), ("scoring_func", "softmax"),
    ("norm_topk_prob", False), ("hidden_act", "gelu"),
    ("attention_bias", True), ("head_dim", 128), ("moe_layer_freq", 2),
    ("rope_interleave", False)])
def test_port_config_refuses_what_the_port_does_not_compute(key, value):
    hf = json.loads((spec.HERE / "configs"
                     / "kanana2-30b-a3b-l12-e16.json").read_text())
    deepseek_v3.port_config(hf)
    hf[key] = value
    with pytest.raises(ValueError, match=key):
        deepseek_v3.port_config(hf)


def test_the_cells_config_is_the_catalogs_cut():
    """Every published number as the catalog gives it, but the three cut
    keys, whose published values the file keeps; the port's configuration
    holds the whole router and 16 experts."""
    hf = json.loads((spec.HERE / "configs"
                     / "kanana2-30b-a3b-l12-e16.json").read_text())
    assert hf["published"] == {"num_hidden_layers": 48,
                               "n_routed_experts": 128, "vocab_size": 128256}
    assert (hf["num_hidden_layers"], hf["n_routed_experts"],
            hf["vocab_size"]) == (12, 16, 16032)
    cfg = spec.find(CELL).model_config()
    assert (cfg.num_experts, cfg.held_experts, cfg.num_moe_layers,
            cfg.experts_per_token) == (128, (0, 16), 11, 6)
    assert (cfg.attn_widths, cfg.kv_lora_rank, cfg.route_scale,
            cfg.shared_intermediate_size) == ((192, 128), 512, 2.448, 1536)


def test_kanana_yardsticks_count_the_cell():
    cell = spec.find(CELL)
    cfg = cell.model_config()
    d = 2048
    attn = d * 32 * 192 + d * 576 + 512 * 32 * 256 + 32 * 128 * d
    moe_layer = d * 128 + 3 * d * 1536 + 3 * d * 768 * 6 * 16 // 128
    assert attn + moe_layer == 39_583_744           # a token's weights a layer
    active = 12 * attn + 3 * d * 6144 + 11 * moe_layer + d * 16_032
    assert deepseek_v3.active_params(cfg) == active
    pairs = 4 * 32 * 16384 * 16385 // 2
    assert deepseek_v3.train_flops(cfg, 4, 16384) == (
        6 * active * 4 * 16384 + (8 * 192 + 6 * 128) * 12 * pairs)
    least = deepseek_v3.mla_bounds(4, 16384, 32, 192, 128)
    assert least["fwd"][3] == 2 * (192 + 128) * pairs   # 11.0 TFLOP
    assert least["bwd"][3] == 2 * (3 * 192 + 2 * 128) * pairs
    rows = 4 * 16384 * 32
    assert least["fwd"][2] == 2 * 2 * rows * 192 + 2 * 2 * rows * 128 \
        + 4 * 32 * 16384 * 4
    assert least["fwd"][1] == least["bwd"][1] == "operations"
    assert least["fwd"][0] == pytest.approx(
        2 * 320 * pairs / bounds.PEAK_BF16_FLOPS * 1e3)
    # a step's 24 forward and 12 backward launches (selective remat)
    assert deepseek_v3.flash_least_s(cfg, 4, 16384, 24, 12) == pytest.approx(
        (24 * least["fwd"][0] + 12 * least["bwd"][0]) / 1e3)


def _run(ops, spans=()):
    """A run record over a hand-made trace: ``ops`` (name, start us,
    duration us), launched on thread 1 at their start; ``spans`` (name,
    start, end) on thread 1."""
    cell = spec.find(CELL)
    trace = types.SimpleNamespace(
        ops=[(n, t, d, i) for i, (n, t, d) in enumerate(ops)],
        launch={i: (t, 1) for i, (_n, t, _d) in enumerate(ops)},
        ranges={(1, n): [(a, b)] for n, a, b in spans},
        window=(0, 1000), window_s=1e-3,
        busy_s=sum(d for _n, _t, d in ops) / 1e6)
    return types.SimpleNamespace(trace=trace, cell=cell,
                                 cfg=cell.model_config(), batch=4, seq=16384)


NAME = "void flash::(anonymous namespace)::{}(CUtensorMap)"
LATENT = [NAME.format(n) for n in (
    "mla_fwd_kernel<192, 128>", "mla_prep_kernel<192, 128>",
    "mla_bwd_kernel<192, 128>", "mla_post_kernel")]
OLDER = [NAME.format(n) for n in (
    "fwd_kernel<128>", "prep_kernel<128>", "bwd_kernel<128>", "post_kernel",
    "fwd_kernel<128, true>", "bwd_kernel<128, true>")]


def test_the_latent_roofline_reads_the_latent_launches_alone():
    ops = [(LATENT[0], 0, 18000), (OLDER[0], 5, 9000), (LATENT[1], 10, 500),
           (LATENT[2], 20, 70000), (LATENT[3], 30, 1000),
           (OLDER[2], 40, 20000)]
    run = _run(ops)
    reader = spec.metric_reader("flash_mla_roofline.train")
    least = deepseek_v3.flash_least_s(run.cfg, 4, 16384, 1, 1)
    assert reader.read(run) == pytest.approx(100 * least / 89.5e-3)
    assert reader.read(_run([ops[1], ops[5]])) is None
    assert reader.read(types.SimpleNamespace(trace=None)) is None


def test_the_older_readers_do_not_read_the_latent_kernels():
    """``flash_roofline.train``'s and ``flash_window_roofline.train``'s
    patterns match the causal and windowed kernels and none of the latent
    ones, so the cells that had them read as before."""
    window = spec.metric_reader("flash_window_roofline.train")
    for name in LATENT:
        for pattern in (readers.FLASH_FWD, readers.FLASH_BWD,
                        readers.FLASH_BWD_MAIN, window.FWD, window.BWD,
                        window.PREP, window.POST):
            assert not pattern.search(name), (pattern, name)
    assert readers.FLASH_FWD.search(OLDER[0])
    assert readers.FLASH_BWD.search(OLDER[1]) and readers.FLASH_BWD.search(
        OLDER[3])
    latent = spec.metric_reader("flash_mla_roofline.train")
    for name in OLDER:
        assert not any(re.search(p, name) for p in (
            latent.FWD, latent.BWD, latent.PASSES))


def test_the_latent_share_reads_both_latent_spans():
    ops = [("k1", 10, 100), ("k2", 20, 300), ("k3", 30, 600)]
    spans = [("model.attention", 5, 15), ("model.mla.latent", 15, 25),
             ("model.mla.rope", 25, 35)]
    reader = spec.metric_reader("mla_latent_share.train")
    assert reader.read(_run(ops, spans)) == pytest.approx(90.0)
    assert reader.read(_run(ops, spans[:1])) is None
    assert json.loads((spec.HERE / "cells" / f"{CELL}.json").read_text())[
        "per_layer"] == ["flash_mla_roofline.train", "mla_latent_share.train",
                         "mfu.train", "moe_device_share.train",
                         "device_idle_share.train"]


def test_the_references_blocked_attention_is_causal_softmax(monkeypatch):
    """Blocks of 32 queries of 96, every head at once, forward and
    backward, against one explicit causal softmax."""
    import torch

    monkeypatch.setattr(deepseek_v3, "ATTN_BLOCK", 32)
    g = torch.Generator().manual_seed(5)
    q, k = (torch.randn(2, 96, 3, 24, generator=g, requires_grad=True)
            for _ in range(2))
    v = torch.randn(2, 96, 3, 16, generator=g, requires_grad=True)
    do = torch.randn(2, 96, 3, 16, generator=g)
    got = deepseek_v3.attention(q, k, v, 0.3)
    grads = torch.autograd.grad(got, (q, k, v), do)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.3
    keep = torch.ones(96, 96, dtype=torch.bool).tril()
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(
        scores.masked_fill(~keep, float("-inf")), -1), v)
    want_grads = torch.autograd.grad(want, (q, k, v), do)
    assert torch.allclose(got, want, atol=1e-5)
    for a, b in zip(grads, want_grads):
        assert torch.allclose(a, b, atol=1e-4)
