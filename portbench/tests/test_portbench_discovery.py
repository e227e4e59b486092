"""The harness finds every piece by name: a cell, a configuration, a
traffic mix, a traffic kind or a metric is added as new files (and a
manifest entry), and the manifest and the files agree."""

import json
import shutil
import textwrap
from pathlib import Path

from portbench import harness, spec
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
