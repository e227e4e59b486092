"""Weights drawn from the run's seed, on the device, in the served dtype.

Each (leaf, layer) is one draw from a generator of its own, seeded from
(seed, leaf, layer): the program gets the port's tree (stacked ``[L, ...]``
leaves, ``[in, out]`` matrices, a float32 router), and the plain reference
draws any one layer again, alone, when it needs it, so it never reads a
tensor the program held.

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


def _shapes(cfg) -> Dict[str, Tuple[tuple, int, torch.dtype]]:
    """Each layer leaf's per-layer shape, fan-in (0: a norm) and dtype."""
    d, f = cfg.hidden_size, cfg.intermediate_size
    out = {
        "attn_norm": ((d,), 0, cfg.dtype),
        "wq": ((d, cfg.q_dim), d, cfg.dtype),
        "wk": ((d, cfg.kv_dim), d, cfg.dtype),
        "wv": ((d, cfg.kv_dim), d, cfg.dtype),
        "wo": ((cfg.q_dim, d), cfg.q_dim, cfg.dtype),
        "mlp_norm": ((d,), 0, cfg.dtype),
    }
    e = getattr(cfg, "num_experts", 0)
    if e:
        out["router"] = ((d, e), d, torch.float32)
        out.update(w_gate=((e, d, f), d, cfg.dtype),
                   w_up=((e, d, f), d, cfg.dtype),
                   w_down=((e, f, d), f, cfg.dtype))
    else:
        out.update(w_gate=((d, f), d, cfg.dtype), w_up=((d, f), d, cfg.dtype),
                   w_down=((f, d), f, cfg.dtype))
    return out


def _globals(cfg) -> Dict[str, Tuple[tuple, int, torch.dtype]]:
    d = cfg.hidden_size
    out = {"embed": ((cfg.vocab_size, d), d, cfg.dtype),
           "final_norm": ((d,), 0, cfg.dtype)}
    if not cfg.tie_embeddings:
        out["lm_head"] = ((d, cfg.vocab_size), d, cfg.dtype)
    return out


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


def program_params(cfg, seed: int, device) -> dict:
    """The port's parameter tree, every leaf drawn on ``device``."""
    params = {name: draw(seed, name, -1, *spec, device)
              for name, spec in _globals(cfg).items()}
    layers = {}
    for name, (shape, fan_in, dtype) in _shapes(cfg).items():
        stacked = torch.empty((cfg.num_layers,) + shape, dtype=dtype,
                              device=device)
        for l in range(cfg.num_layers):
            stacked[l].copy_(draw(seed, name, l, shape, fan_in, dtype, device))
        layers[name] = stacked
    params["layers"] = layers
    return params


def initial(cfg, seed: int, name: str, layer: int, device) -> torch.Tensor:
    """Leaf ``name``'s slice of layer ``layer`` (-1: an unstacked leaf) as
    it was drawn, in its stored dtype."""
    spec = (_globals(cfg) if layer < 0 else _shapes(cfg))[name]
    return draw(seed, name, layer, *spec, device)


def reference_layer(cfg, seed: int, layer: int, device) -> Dict[str, torch.Tensor]:
    """Layer ``layer``'s leaves drawn again, in float32."""
    return {name: draw(seed, name, layer, shape, fan_in, dtype,
                       device).float()
            for name, (shape, fan_in, dtype) in _shapes(cfg).items()}


def reference_globals(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    return {name: draw(seed, name, -1, *spec, device).float()
            for name, spec in _globals(cfg).items()}


def stored_dtype(cfg, name: str) -> torch.dtype:
    """The dtype the program stores leaf ``name`` in."""
    spec = _globals(cfg).get(name) or _shapes(cfg)[name]
    return spec[2]


def leaf_slices(cfg) -> Iterator[Tuple[str, int]]:
    """(leaf, layer) of every slice the checks compare, in the port's
    order (``layer`` -1 for the unstacked leaves)."""
    for name in _globals(cfg):
        if name != "lm_head":
            yield name, -1
    for name in _shapes(cfg):
        for l in range(cfg.num_layers):
            yield name, l
    if not cfg.tie_embeddings:
        yield "lm_head", -1
