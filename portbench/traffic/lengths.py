"""Sizes and gaps drawn so that every seed does the same work.

A seed orders a fixed set of values instead of drawing new ones: the
i-th of n values is the distribution's (i + 0.5) / n quantile, and the
seed shuffles them.  Each stretch that a run measures gets a set of its
own (the open loop's window holds exactly its share of arrivals, with
gaps summing to the window), so every seed's window meets the same work
in another order, and the runs' spread is the system's, not the
sampler's.
"""

from __future__ import annotations

import hashlib
import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np


def rng(seed: int, *salt) -> np.random.Generator:
    digest = hashlib.sha256("/".join(map(str, (seed,) + salt)).encode())
    return np.random.default_rng(int.from_bytes(digest.digest()[:8], "little"))


def lognormal_set(spec: Dict[str, float], n: int) -> List[int]:
    """``n`` whole sizes at the quantiles of a lognormal of the given
    ``median`` and ``sigma``, clipped to [``min``, ``max``]."""
    z = NormalDist()
    out = []
    for i in range(n):
        x = spec["median"] * math.exp(spec["sigma"] * z.inv_cdf((i + 0.5) / n))
        out.append(int(min(max(round(x), spec["min"]), spec["max"])))
    return out


def gaps_over(span: float, n: int) -> List[float]:
    """``n`` gaps at the quantiles of an exponential (a Poisson process's
    inter-arrival times), scaled to sum to ``span``."""
    raw = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    total = sum(raw)
    return [g * span / total for g in raw]


def shuffled(values: list, gen: np.random.Generator) -> list:
    return [values[i] for i in gen.permutation(len(values))]
