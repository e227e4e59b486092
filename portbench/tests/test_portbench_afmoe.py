"""The afmoe family (Trinity): a tiny cell trains through the port on the
CPU with every check ok; a reference with a planted fault fails it (so the
check runs afmoe's own reference), and so does a program whose expert bias
strays from the rule; the yardsticks count what the cell's
shape asks; the new readers read what they name; and a checkout whose
port has no afmoe model refuses the cell at once."""

import json
import shutil
import sys
import types

import pytest
import torch

from dstack_tpu_torch.models import afmoe as port_afmoe
from portbench import harness, spec
from portbench.families import afmoe
from portbench.frozen import bounds
from portbench.tests.conftest import BIG_SEED, DATA

#: faults planted in a copy of the family's reference: (text, replacement)
FAULTS = {
    "rope_on_full_layers": ("    if sliding:\n        q = torch.stack(",
                            "    if True:\n        q = torch.stack("),
    "no_output_gate": (
        'a = a.reshape(b, s, -1) * torch.sigmoid(mm(h, w["w_attn_gate"]))',
        "a = a.reshape(b, s, -1)"),
    "bias_rule_sign_flipped": ("torch.sign(n.mean() - n)",
                               "torch.sign(n - n.mean())"),
    "bias_never_moves": ("    return bias + (delta - delta.mean())",
                         "    return bias"),
}


def _flipped(bias, counts, rate):
    bias.sub_(rate * torch.sign(counts.mean(-1, keepdim=True) - counts))


def _uncentred(bias, counts, rate):
    bias.add_(rate * torch.sign(counts.mean(-1, keepdim=True) - counts))


_REAL_RULE = port_afmoe.update_expert_bias

#: faults planted in the program's bias rule (``afmoe.update_expert_bias``)
PROGRAM_FAULTS = {
    "sign_flipped": _flipped,
    "not_centred": _uncentred,
    "ten_times_the_rate": lambda bias, counts, rate: _REAL_RULE(
        bias, counts, 10 * rate),
    "never_runs": lambda bias, counts, rate: None,
}


def _root_with_family(tmp_path, source=None):
    """A copy of the benchmark with the tiny afmoe cell's files, and the
    family's source replaced by ``source`` where given."""
    root = tmp_path / "portbench"
    shutil.copytree(spec.HERE, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    for kind, name in (("configs", "tiny-afmoe"), ("traffic", "train-tiny"),
                       ("cells", "tiny-afmoe-train")):
        shutil.copy(DATA / kind / f"{name}.json", root / kind)
    if source is not None:
        (root / "families" / "afmoe.py").write_text(source)
    return root


def test_the_tiny_afmoe_cell_trains_with_every_check_ok():
    cell = spec.find("tiny-afmoe-train", DATA)
    cfg = cell.model_config()
    assert cfg.held_experts == (0, 4) and cfg.num_experts == 8
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
    source = (spec.HERE / "families" / "afmoe.py").read_text()
    assert source.count(text) == 1
    root = _root_with_family(tmp_path, source.replace(text, planted))
    cell = spec.find("tiny-afmoe-train", root)
    out = harness.run_cell(cell, BIG_SEED, 0.0, False, device="cpu")
    assert out.checks and not all(c.ok for c in out.checks), out.checks


@pytest.mark.parametrize("fault", sorted(PROGRAM_FAULTS))
def test_a_program_whose_bias_strays_from_the_rule_fails_the_check(
        monkeypatch, fault):
    """The reference chooses by its own bias and shows the program's
    against it in the router gap, so a program that moves its bias
    otherwise than the rule fails the router check."""
    monkeypatch.setattr(port_afmoe, "update_expert_bias",
                        PROGRAM_FAULTS[fault])
    cell = spec.find("tiny-afmoe-train", DATA)
    out = harness.run_cell(cell, BIG_SEED, 0.0, False, device="cpu")
    gap = next(c for c in out.checks if c.name == "router_gap")
    assert not gap.ok, out.checks


def test_a_port_without_afmoe_refuses_the_cell_at_once(monkeypatch):
    """The parent of the change that brings the model: ``port_config``
    raises before a weight is drawn."""
    monkeypatch.setitem(sys.modules, "dstack_tpu_torch.models.afmoe", None)
    cell = spec.find("trinity-train-s8192")
    with pytest.raises(ImportError):
        cell.model_config()


def test_trinity_yardsticks_count_the_cell():
    cell = spec.find("trinity-train-s8192")
    cfg = cell.model_config()
    assert (cfg.num_experts, cfg.held_experts) == (128, (0, 16))
    assert afmoe.window_pairs(8192, 2048) == 2_098_176 + 6_144 * 2_048
    assert afmoe.window_pairs(1000, 2048) == 1000 * 1001 // 2
    d = 2048
    attn = 3 * d * 4096 + 2 * d * 512
    moe_layer = d * 128 + 3 * d * 1024 + 3 * d * 1024  # router, shared, one
    assert afmoe.active_params(cfg) == (8 * attn + 2 * 3 * d * 6144
                                        + 6 * moe_layer + d * 25_024)
    pairs = 8 * (2 * 8192 * 8193 // 2 + 6 * 14_681_088)
    assert afmoe.train_flops(cfg, 8, 8192) == (
        6 * afmoe.active_params(cfg) * 8 * 8192 + 14 * 128 * 32 * pairs)
    causal = bounds.flash_bounds((8, 8192, 32, 4, 128))
    window = afmoe.window_bounds(cfg, 8, 8192)
    assert window["fwd"][2] == causal["fwd"][2]  # the same bytes
    assert window["bwd"][3] == 10 * 128 * 8 * 32 * 14_681_088
    # a step's 16 forward and 8 backward launches: 6 of 8 layers windowed
    assert afmoe.flash_least_s(cfg, 8, 8192, 16, 8) == pytest.approx(
        (12 * window["fwd"][0] + 6 * window["bwd"][0]
         + 4 * causal["fwd"][0] + 2 * causal["bwd"][0]) / 1e3)


def _run(ops, spans=()):
    """A run record over a hand-made trace: ``ops`` (name, start us,
    duration us), launched on thread 1 at their start; ``spans`` (name,
    start, end) on thread 1."""
    cell = spec.find("trinity-train-s8192")
    trace = types.SimpleNamespace(
        ops=[(n, t, d, i) for i, (n, t, d) in enumerate(ops)],
        launch={i: (t, 1) for i, (_n, t, _d) in enumerate(ops)},
        ranges={(1, n): [(a, b)] for n, a, b in spans},
        window=(0, 1000), window_s=1e-3,
        busy_s=sum(d for _n, _t, d in ops) / 1e6)
    return types.SimpleNamespace(trace=trace, cell=cell,
                                 cfg=cell.model_config(), batch=8, seq=8192)


def test_the_window_roofline_reads_the_windowed_launches_alone():
    name = "void flash::(anonymous namespace)::{}<128{}>(CUtensorMap)"
    ops = [(name.format("fwd_kernel", ", true"), 0, 4000),
           (name.format("fwd_kernel", ""), 10, 9000),
           (name.format("prep_kernel", ""), 20, 100),
           (name.format("bwd_kernel", ", true"), 30, 9000),
           (name.format("post_kernel", ""), 40, 100),
           (name.format("prep_kernel", ""), 50, 100),
           (name.format("bwd_kernel", ""), 60, 20000),
           (name.format("post_kernel", ""), 70, 100)]
    run = _run(ops)
    reader = spec.metric_reader("flash_window_roofline.train")
    least = afmoe.flash_window_least_s(run.cfg, 8, 8192, 1, 1)
    assert reader.read(run) == pytest.approx(100 * least / 13.2e-3)
    assert reader.read(_run(ops[1:3] + ops[5:])) is None


def test_the_moe_share_reads_every_moe_span_and_the_shared_one():
    ops = [("k1", 10, 100), ("k2", 20, 300), ("k3", 30, 600)]
    spans = [("model.attention", 5, 15), ("model.moe.shared", 15, 25),
             ("model.moe.experts", 25, 35)]
    reader = spec.metric_reader("moe_device_share.train")
    assert reader.read(_run(ops, spans)) == pytest.approx(90.0)
    assert json.loads((spec.HERE / "cells" / "trinity-train-s8192.json")
                      .read_text())["per_layer"] == [
        "flash_roofline.train", "flash_window_roofline.train", "mfu.train",
        "moe_device_share.train", "device_idle_share.train"]
