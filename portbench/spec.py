"""Find a cell, its configuration, its traffic mix and its metrics by
name.

Everything that belongs to one cell, one configuration, one traffic mix
or one metric sits in a file of its own, named after it:

- ``cells/<workload>.json``: the configuration and traffic it runs, the
  system's settings (slots, cache, batch), the metrics it reports, the
  check's sample and limits;
- ``configs/<name>.json``: the model's published ``config.json`` as it is
  run, with the keys changed from the source and the sizes assumed;
- ``traffic/<name>.json``: the parameters of one traffic mix, read by the
  module its ``kind`` names (``traffic/<kind>.py``, which also sends its
  requests and says which of them count; see ``traffic/__init__.py``);
- ``metrics/<name>.py``: one reader a metric.

A cell, configuration, mix, kind or metric is added by adding its file
(and a manifest entry); no file that is there changes.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict

HERE = Path(__file__).resolve().parent


def _load(kind: str, name: str, root: Path = HERE) -> Dict[str, Any]:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def _module(root: Path, kind: str, name: str):
    """``<kind>/<name>.py`` under ``root``, else under the benchmark's own
    folder, loaded by path (names may hold dots)."""
    for base in (root, HERE):
        path = base / kind / f"{name}.py"
        if path.is_file():
            break
    else:
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}._" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: Path = HERE):
    """The reader of metric ``name``: ``metrics/<name>.py``."""
    return _module(root, "metrics", name)


@dataclasses.dataclass
class Cell:
    """One workload: a configuration under a traffic mix, as run."""

    name: str
    cell: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    #: the folder the cell's files were found in
    root: Path = HERE

    def model_config(self):
        return port_config(self.config)

    @functools.cached_property
    def generator(self):
        """The module of the mix's ``kind``: ``traffic/<kind>.py``."""
        return _module(self.root, "traffic", self.traffic["kind"])

    def metric_reader(self, name: str):
        return metric_reader(name, self.root)


def find(name: str, root: Path = HERE) -> Cell:
    cell = _load("cells", name, root)
    return Cell(name=name, cell=cell, config=_load("configs", cell["config"],
                                                   root),
                traffic=_load("traffic", cell["traffic"], root), root=root)


def port_config(hf: Dict[str, Any]):
    """The port's ``LlamaConfig`` or ``MoEConfig`` of a published
    ``config.json`` (Llama, Mistral or Mixtral keys).  A key the port has
    no counterpart for must hold the value the port computes."""
    import torch

    from dstack_tpu_torch.models.llama import LlamaConfig
    from dstack_tpu_torch.models.moe import MoEConfig

    if hf.get("hidden_act", "silu") != "silu":
        raise ValueError("the port's MLP is SwiGLU (silu)")
    if hf.get("sliding_window") is not None:
        raise ValueError("the port has no sliding-window attention")
    if hf.get("rope_scaling") is not None:
        raise ValueError("rope scaling is not mapped")
    heads = hf["num_attention_heads"]
    kw = dict(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"], num_heads=heads,
        num_kv_heads=hf["num_key_value_heads"],
        head_dim=hf.get("head_dim") or hf["hidden_size"] // heads,
        rope_theta=float(hf["rope_theta"]), rms_eps=float(hf["rms_norm_eps"]),
        max_seq_len=hf["max_position_embeddings"],
        dtype=getattr(torch, hf.get("torch_dtype", "bfloat16")),
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)))
    if "num_local_experts" not in hf:
        return LlamaConfig(**kw)
    assumed = hf.get("assumed", {})
    return MoEConfig(num_experts=hf["num_local_experts"],
                     experts_per_token=hf["num_experts_per_tok"],
                     capacity_factor=float(assumed["capacity_factor"]),
                     router_aux_weight=float(hf["router_aux_loss_coef"]),
                     **kw)
