"""Weights drawn from the run's seed, on the device, in the served dtype.

Each (leaf, layer) is one draw from a generator of its own, seeded from
(seed, leaf, layer), of the shape, fan-in and dtype its model family's
table gives (``families/``): the family lays the draws out as the
program's tree, and the plain reference draws any one layer again, alone,
when it needs it, so it never reads a tensor the program held.

Scales follow the port's initialisation (a matrix's entries ~ N(0, 1 /
fan_in)); the norm weights are 1 + N(0, 0.1^2) rather than ones, so that a
norm whose weight is dropped shows in the check.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, Tuple

import torch

NORM_JITTER = 0.1


def leaf_seed(seed: int, name: str, layer: int) -> int:
    digest = hashlib.sha256(f"{seed}/{name}/{layer}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def draw(seed: int, name: str, layer: int, shape: tuple, fan_in: int,
         dtype: torch.dtype, device) -> torch.Tensor:
    """One leaf of one layer (``layer`` -1 for the embedding, the final
    norm and the head)."""
    gen = torch.Generator(device=device).manual_seed(
        leaf_seed(seed, name, layer))
    t = torch.empty(shape, dtype=dtype, device=device).normal_(generator=gen)
    if fan_in == 0:
        return t.mul_(NORM_JITTER).add_(1.0)
    return t.mul_(fan_in ** -0.5)


def stack(seed: int, name: str, layers, spec, device) -> torch.Tensor:
    """Leaf ``name`` of each of ``layers``, stacked ``[len(layers), ...]``
    (``spec``: its table entry)."""
    shape, fan_in, dtype = spec
    layers = list(layers)
    out = torch.empty((len(layers),) + shape, dtype=dtype, device=device)
    for i, l in enumerate(layers):
        out[i].copy_(draw(seed, name, l, shape, fan_in, dtype, device))
    return out


def initial(family, cfg, seed: int, name: str, layer: int, device
            ) -> torch.Tensor:
    """Leaf ``name``'s slice of layer ``layer`` (-1: a global leaf) as it
    was drawn, in its stored dtype."""
    table = (family.globals_table(cfg) if layer < 0
             else family.layer_table(cfg, layer))
    return draw(seed, name, layer, *table[name], device)


def reference_layer(family, cfg, seed: int, layer: int, device
                    ) -> Dict[str, torch.Tensor]:
    """Layer ``layer``'s leaves drawn again, in float32."""
    return {name: draw(seed, name, layer, *spec, device).float()
            for name, spec in family.layer_table(cfg, layer).items()}


def reference_globals(family, cfg, seed: int, device
                      ) -> Dict[str, torch.Tensor]:
    return {name: draw(seed, name, -1, *spec, device).float()
            for name, spec in family.globals_table(cfg).items()}


def leaf_slices(family, cfg) -> Iterator[Tuple[str, int]]:
    """(leaf, layer) of every slice the checks compare (``layer`` -1 for
    the global leaves)."""
    for name in family.globals_table(cfg):
        yield name, -1
    for l in range(cfg.num_layers):
        for name in family.layer_table(cfg, l):
            yield name, l
