"""Nothing of JAX runs in a benchmark process, compared by whole
top-level module name, and a run without a card fails with a message and
no result."""

import os
import subprocess
import sys
import types
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in harness.FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "dstack_tpu_torch_extra",
                        types.ModuleType("dstack_tpu_torch_extra"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("jaxtyping"))
    present = {m.split(".")[0] for m in sys.modules}
    if not present & set(harness.FORBIDDEN):
        assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dstack_tpu.serving",
                        types.ModuleType("dstack_tpu.serving"))
    assert "dstack_tpu" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.np"))
    assert {"dstack_tpu", "jax"} <= set(harness.forbidden_modules())


def test_the_drivers_import_nothing_of_jax():
    code = ("import sys; from portbench import harness, serve, train, "
            "calibrate, readers; from portbench.reference import judge, "
            "model, training; from portbench.families import llama; "
            "import dstack_tpu_torch.serving.engine, "
            "dstack_tpu_torch.models.moe, dstack_tpu_torch.models.train; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "mixtral-train-s4096", "--seed", str(2 ** 31 + 7), "--seconds",
         "5", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "CUDA card" in out.stderr
    assert out.stdout.strip() == ""
