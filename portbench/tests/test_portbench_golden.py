"""Model families leave every number the benchmark reads as the harness
gave it before them, bit for bit: the drawn parameters, the reference's
first three steps (and its fp8 control's), the model operations of a
trained step and the flash kernels' least times.  ``data/golden.json``
holds what that harness gave (floats as ``float.hex``), on the CPU with
one thread: a matmul's sums run in another order on more."""

import hashlib
import json
import types

import numpy as np
import pytest
import torch

from portbench import spec
from portbench.frozen import bounds
from portbench.reference.training import Reference
from portbench.tests.conftest import DATA

GOLDEN = json.loads((DATA / "golden.json").read_text())
CPU = torch.device("cpu")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hex(x) -> str:
    return float(x).hex()


def _digest(tree) -> str:
    flat = {}

    def walk(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(f"{prefix}{k}/", v)
        else:
            flat[prefix[:-1]] = t
    walk("", tree)
    d = hashlib.sha256()
    for name in sorted(flat):
        t = flat[name].detach().cpu().contiguous()
        d.update(f"{name}|{t.dtype}|{tuple(t.shape)}|".encode())
        d.update(t.view(torch.uint8).numpy().tobytes())
    return d.hexdigest()


def _numbers(out):
    res = {"loss": [_hex(v) for v in out["loss"]],
           "grad": {k: _hex(v) for k, v in out["grad"].items()},
           "update": {k: _hex(v) for k, v in out["update"].items()}}
    if "router_gap" in out:
        res["router_gap"] = _hex(out["router_gap"])
    return res


@pytest.mark.parametrize("name", ["tiny-dense-train", "tiny-moe-train"])
def test_drawn_parameters_are_as_before(name):
    cell = spec.find(name, DATA)
    params = cell.family.program_params(cell.model_config(), GOLDEN["seed"],
                                        CPU)
    assert _digest(params) == GOLDEN["params"][cell.cell["config"]]


@pytest.mark.parametrize("name", ["tiny-dense-train", "tiny-moe-train"])
def test_reference_numbers_are_as_before(name, one_thread):
    cell = spec.find(name, DATA)
    family, cfg, seed = cell.family, cell.model_config(), GOLDEN["seed"]
    mix = cell.traffic
    b, s = int(mix["batch"]), int(mix["seq_len"])
    corpus = cell.generator.corpus(mix, seed, cfg.vocab_size)
    fed = [torch.from_numpy(rows) for rows in corpus[:3 * b * (s + 1)]
           .astype(np.int64).reshape(3, b, s + 1)]
    opt = types.SimpleNamespace(**GOLDEN["optimizer"])
    low = Reference(family, cfg, seed, CPU, precision="fp8")
    ctrl = low.steps(fed, opt)
    follow = [[None if lg is None else (lg, None) for lg in step]
              for step in low.routes]
    ref = Reference(family, cfg, seed, CPU).steps(fed, opt, follow=follow)
    assert _numbers(ctrl) == GOLDEN["reference"][name]["control"]
    assert _numbers(ref) == GOLDEN["reference"][name]["reference"]


@pytest.mark.parametrize("name", ["mixtral-train-s4096",
                                  "mistral7b-train-s4096",
                                  "tiny-dense-train", "tiny-moe-train"])
def test_yardsticks_are_as_before(name):
    cell = spec.find(name, spec.HERE if "s4096" in name else DATA)
    family, cfg = cell.family, cell.model_config()
    b, s = int(cell.traffic["batch"]), int(cell.traffic["seq_len"])
    golden = GOLDEN["yardsticks"][name]
    assert family.train_flops(cfg, b, s) == golden["train_step_flops"]
    least = bounds.flash_bounds((b, s, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.head_dim))
    assert {k: [_hex(v[0]), v[1], v[2], v[3]] for k, v in least.items()} \
        == golden["flash_bounds"]
    for counts, value in golden["flash_least_s"].items():
        n_fwd, n_bwd = (int(n) for n in counts.split("/"))
        assert _hex(family.flash_least_s(cfg, b, s, n_fwd, n_bwd)) == value
