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
- ``metrics/<name>.py``: one reader a metric;
- ``families/<model_type>.py``: one model family, chosen by the
  configuration's published ``model_type`` (see ``families/__init__.py``).

A cell, configuration, mix, kind, metric or family is added by adding its
file (and a manifest entry); no file that is there changes.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict

HERE = Path(__file__).resolve().parent
#: the family of a configuration that names no ``model_type``
UNTYPED = "llama"


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

    @functools.cached_property
    def family(self):
        """The module of the configuration's family:
        ``families/<model_type>.py``."""
        return _module(self.root, "families",
                       self.config.get("model_type", UNTYPED))

    def model_config(self):
        """The port's configuration, as the family maps it."""
        return self.family.port_config(self.config)

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
