"""The harness finds every piece by name: a cell, a configuration, a
traffic mix, a traffic kind, a metric or a model family is added as new
files (and a manifest entry), and the manifest and the files agree."""

import inspect
import json
import shutil
import textwrap
from pathlib import Path

import pytest

from portbench import harness, spec
from portbench.frozen import bounds, flops
from portbench.tests.conftest import BIG_SEED, DATA

ROOT = Path(__file__).resolve().parents[2]

#: a serving kind the harness has never seen: every request of a burst
#: sent at once, the next burst once the last is answered
BURSTS = textwrap.dedent('''
    import threading

    from portbench.traffic import lengths

    DRIVER = "serve"
    SENT = []


    def schedule(mix, cell, seed, seconds, vocab):
        gen = lengths.rng(seed, "bursts")
        return [{"at": 0.0, "burst": b, "max_new": mix["max_new"],
                 "prompt": gen.integers(0, vocab, n).tolist()}
                for b in range(mix["bursts"]) for n in mix["prompts"]]


    def feed(plan, mix, t0, stop, submit):
        def send():
            for b in range(mix["bursts"]):
                if stop.is_set():
                    return
                sent = [submit(item, t0) for item in plan
                        if item["burst"] == b]
                SENT.append(len(sent))
                for s in sent:
                    s.request.done.wait(60)
        return [threading.Thread(target=send, daemon=True)]


    def settle(mix, served, t0, t1):
        for s in served:
            s.request.done.wait(60)


    def account(run):
        return run.served, sum(1 for s in run.served if not s.finished)
''')


#: a model family the harness has never seen: the port's dense step, a
#: reference of its own, and twice the model operations
TOY = textwrap.dedent('''
    import torch
    import torch.nn.functional as F

    from portbench.families.llama import (
        flash_least_s, globals_table, layer_table, port_config,
        program_params, program_slice, ref_aux_weight, ref_embed,
        ref_embed_grads, ref_head, train_program)
    from portbench.frozen import flops
    from portbench.reference.model import rms_norm, rope
    from portbench.reference.training import causal_attention


    def route_tap(cfg):
        return None


    def train_flops(cfg, batch, seq):
        return 2 * flops.train_step_flops(cfg, batch, seq)


    def ref_layer(cfg, layer, x, w, mms, follow=None):
        mm = mms[0]
        b, s, _ = x.shape
        h = rms_norm(x, w["attn_norm"], cfg.rms_eps)
        q = mm(h, w["wq"]).view(b, s, cfg.num_heads, cfg.head_dim)
        k = mm(h, w["wk"]).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = mm(h, w["wv"]).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        q = torch.stack([rope(q[r], cfg.rope_theta) for r in range(b)])
        k = torch.stack([rope(k[r], cfg.rope_theta) for r in range(b)])
        x = x + mm(causal_attention(q, k, v).reshape(b, s, -1), w["wo"])
        h = rms_norm(x, w["mlp_norm"], cfg.rms_eps)
        y = mm(F.silu(mm(h, w["w_gate"])) * mm(h, w["w_up"]), w["w_down"])
        return x + y, None, None
''')
#: the toy cell's files
TOY_FILES = {"families/toy.py", "configs/toy-tiny.json",
             "traffic/toy-train.json", "cells/toy-train.json"}


def _copy(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(spec.HERE, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    return root


def test_new_cell_config_mix_and_metric_are_found_as_new_files(tmp_path):
    root = _copy(tmp_path)
    config = json.loads((root / "configs" / "mixtral-8x7b-l2.json")
                        .read_text())
    (root / "configs" / "new-model.json").write_text(json.dumps(
        dict(config, num_hidden_layers=4)))
    (root / "traffic" / "new-mix.json").write_text(json.dumps(
        {"kind": "open_poisson", "lead_in_s": 1, "tail_s": 5,
         "prompt_tokens": {"median": 64, "sigma": 0.5, "min": 16, "max": 128},
         "output_tokens": {"median": 16, "sigma": 0.5, "min": 4, "max": 32}}))
    (root / "metrics" / "new_metric.layer.py").write_text(
        'UNIT = "ms"\n\n\ndef read(run):\n    return 42.0\n')
    (root / "cells" / "new-cell.json").write_text(json.dumps(
        {"config": "new-model", "traffic": "new-mix", "chips": 1,
         "why": "added by files alone", "rate_per_s": 1.0,
         "engine": {"batch_size": 4, "max_len": 256, "paged": True,
                    "kv_block_size": 16},
         "end_to_end": ["tpot_p50_ms", "setup_s"],
         "per_layer": ["new_metric.layer"]}))
    cell = spec.find("new-cell", root)
    assert cell.model_config().num_layers == 4
    assert cell.traffic["prompt_tokens"]["max"] == 128
    assert cell.generator.DRIVER == "serve"
    reader = cell.metric_reader("new_metric.layer")
    assert reader.UNIT == "ms" and reader.read(None) == 42.0


def test_a_new_traffic_kind_runs_as_new_files(tmp_path):
    """A kind with its own arrivals, window rule and failure rule drives
    the serving cell end to end, with no file of the harness edited."""
    root = _copy(tmp_path)
    (root / "traffic" / "bursts.py").write_text(BURSTS)
    (root / "traffic" / "bursts-tiny.json").write_text(json.dumps(
        {"kind": "bursts", "lead_in_s": 0.0, "bursts": 2, "max_new": 6,
         "prompts": [8, 20, 33]}))
    shutil.copy(DATA / "configs" / "tiny-moe.json", root / "configs")
    chat = json.loads((DATA / "cells" / "tiny-chat.json").read_text())
    (root / "cells" / "tiny-bursts.json").write_text(json.dumps(
        dict(chat, traffic="bursts-tiny", check={"min_served_tokens": 30,
                                                 "max_requests": 6})))
    cell = spec.find("tiny-bursts", root)
    out = harness.run_cell(cell, BIG_SEED, 0.5, False, device="cpu")
    assert cell.generator.SENT == [3, 3]
    assert out.attempted == 6 and out.failed == 0
    assert out.checks and all(c.ok for c in out.checks), out.checks
    line = harness.result_line(cell, out, False, harness.device_of("cpu"))
    assert set(line["metrics"]) == {"tpot_p50_ms", "setup_s"}


def _toy(root, source=TOY):
    """The toy family's cell: a tiny dense configuration of its
    ``model_type``, a training mix and the cell, as new files."""
    (root / "families" / "toy.py").write_text(source)
    config = json.loads((DATA / "configs" / "tiny-dense.json").read_text())
    (root / "configs" / "toy-tiny.json").write_text(json.dumps(
        dict(config, model_type="toy")))
    shutil.copy(DATA / "traffic" / "train-tiny.json",
                root / "traffic" / "toy-train.json")
    cell = json.loads((DATA / "cells" / "tiny-dense-train.json").read_text())
    (root / "cells" / "toy-train.json").write_text(json.dumps(
        dict(cell, config="toy-tiny", traffic="toy-train")))
    return spec.find("toy-train", root)


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts
            and p.relative_to(root).parts[0] != "tests"}


def test_a_new_model_family_trains_as_new_files(tmp_path):
    """A family the harness has never seen trains its cell end to end with
    every check ok, and ``mfu.train`` reads the family's count."""
    root = _copy(tmp_path)
    cell = _toy(root)
    assert Path(cell.family.__file__) == root / "families" / "toy.py"
    out = harness.run_cell(cell, BIG_SEED, 0.0, False, device="cpu")
    assert out.checks and all(c.ok for c in out.checks), out.checks
    run = out.run
    mfu = harness.read_metrics(cell, out, True)["mfu.train"]["value"]
    assert mfu == pytest.approx(
        2 * 100 * flops.train_step_flops(run.cfg, run.batch, run.seq)
        * run.steps / (run.seconds * bounds.PEAK_BF16_FLOPS))
    original, copy = _files(spec.HERE), _files(root)
    assert set(copy) - set(original) == TOY_FILES
    assert {name: copy.get(name) for name in original} == original


def test_a_family_whose_reference_drops_a_norm_fails_its_check(tmp_path):
    """The check runs the family's reference, not one of its own."""
    norm = 'h = rms_norm(x, w["mlp_norm"], cfg.rms_eps)'
    assert norm in TOY
    cell = _toy(_copy(tmp_path), TOY.replace(norm, "h = x"))
    out = harness.run_cell(cell, BIG_SEED, 0.0, False, device="cpu")
    assert out.checks and not all(c.ok for c in out.checks), out.checks


@pytest.mark.parametrize("name", ["mixtral-train-s4096",
                                  "mistral7b-train-s4096",
                                  "tiny-moe-train"])
def test_mistral_mixtral_and_untyped_configs_are_the_llama_family(name):
    cell = spec.find(name, spec.HERE if "s4096" in name else DATA)
    assert (inspect.getsourcefile(cell.family.port_config)
            == str(spec.HERE / "families" / "llama.py"))


def test_an_unknown_model_type_names_the_missing_file(tmp_path):
    root = _copy(tmp_path)
    config = json.loads((DATA / "configs" / "tiny-dense.json").read_text())
    (root / "configs" / "odd.json").write_text(json.dumps(
        dict(config, model_type="odd")))
    cell = json.loads((DATA / "cells" / "tiny-dense-train.json").read_text())
    (root / "cells" / "odd-train.json").write_text(json.dumps(
        dict(cell, config="odd", traffic="train-b2-s4096")))
    with pytest.raises(FileNotFoundError, match="families/odd.py"):
        spec.find("odd-train", root).model_config()


def test_manifest_and_files_agree():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    metrics = {m["name"]: m for m in manifest["end_to_end"]
               + manifest["per_layer"]}
    configs = {c["name"]: c for c in manifest["configs"]}
    for w in manifest["workloads"]:
        cell = spec.find(w["name"])
        assert cell.cell["config"] == w["config"]
        assert cell.cell["traffic"] == w["traffic"]
        assert cell.cell["chips"] == w["chips"]
        assert cell.cell["why"] == w["why"]
        assert (ROOT / configs[w["config"]]["file"]).is_file()
        for name in cell.cell["end_to_end"] + cell.cell["per_layer"]:
            m = metrics[name]
            assert cell.metric_reader(name).UNIT == m["unit"]
            assert w["name"] in m.get("workloads", [w["name"]])
        for m in manifest["per_layer"]:
            if w["name"] in m["workloads"]:
                assert m["name"] in cell.cell["per_layer"]
    for c in manifest["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        for key in c["reduced"]:
            assert data["published"][key] != data[key]
        assert set(data.get("published", {})) == set(c["reduced"])
