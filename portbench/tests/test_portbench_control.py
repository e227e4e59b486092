"""The comparison that decides ``correct`` fails what it must, at a size
a CPU test run holds (the CPU stand-ins of the cells in ``data/``, with
limits of their own, set from these readings as the cells' were): the
control (the reference in the precision below the configuration's), and
a run whose timed path is broken underneath — a token altered where the
engine produces it, a train step that leaves the state unchanged, a step
fed half of its batch."""

import pytest
import torch

from portbench import calibrate, harness, spec
from portbench.reference import judge
from portbench.tests.conftest import BIG_SEED, DATA

CPU = torch.device("cpu")


def _run(name, seed=BIG_SEED, seconds=1.5):
    cell = spec.find(name, DATA)
    return cell, harness.run_cell(cell, seed, seconds, False, device="cpu")


def _correct(out):
    return bool(out.checks) and all(c.ok for c in out.checks)


def test_serving_program_passes_and_its_control_fails():
    cell, out = _run("tiny-chat")
    assert _correct(out), out.checks
    limits = cell.cell["limits"]
    ctrl = judge.served_control(cell.family, cell.model_config(), BIG_SEED,
                                out.compared, CPU)
    assert any(v > limits[k] for k, v in ctrl.items()), ctrl


@pytest.mark.parametrize("name", ["tiny-moe-train", "tiny-dense-train"])
def test_training_program_passes_and_its_control_fails(name):
    cell, out = _run(name, seconds=0.0)
    assert _correct(out), out.checks
    numbers, _ = calibrate.training_control(cell.family, cell.model_config(),
                                            BIG_SEED, out.compared, CPU)
    limits = cell.cell["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers


def test_the_experts_only_control_fails_the_moe_cell():
    """A program that took only the expert matmuls to fp8 still fails."""
    cell, out = _run("tiny-moe-train", seconds=0.0)
    numbers, _ = calibrate.training_control(cell.family, cell.model_config(),
                                            BIG_SEED, out.compared, CPU,
                                            "fp8_experts")
    limits = cell.cell["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers


def test_a_token_altered_where_it_is_produced_fails(monkeypatch):
    from dstack_tpu_torch.serving.engine import InferenceEngine

    emit = InferenceEngine._emit

    def altered(self, slot_id, req, token):
        if len(req.output) == 2:
            token = (token + 1) % self.cfg.vocab_size
        return emit(self, slot_id, req, token)

    monkeypatch.setattr(InferenceEngine, "_emit", altered)
    _, out = _run("tiny-chat")
    assert not _correct(out)
    assert "token_gap_mean" in {c.name for c in out.checks if not c.ok}


@pytest.mark.parametrize("name", ["tiny-moe-train", "tiny-dense-train"])
def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch, name):
    from dstack_tpu_torch.models import train

    monkeypatch.setattr(train.AdamW, "update",
                        lambda self, params, grads, opt: torch.zeros(()))
    _, out = _run(name, seconds=0.0)
    bad = {c.name: c.value for c in out.checks if not c.ok}
    assert bad.get("update_gap") == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["tiny-moe-train", "tiny-dense-train"])
def test_a_step_fed_half_its_batch_fails(monkeypatch, name):
    from dstack_tpu_torch.models import moe, train

    for module in (train, moe):
        make = module.make_train_step

        def halved(*a, _make=make, **k):
            step = _make(*a, **k)
            return lambda state, batch: step(
                state, {"tokens": batch["tokens"][:1]})
        monkeypatch.setattr(module, "make_train_step", halved)
    _, out = _run(name, seconds=0.0)
    assert not _correct(out), out.checks
