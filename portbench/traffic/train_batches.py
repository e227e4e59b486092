"""Training batches: documents drawn from the seed, concatenated with an
end-of-document token between them and cut into windows of
``seq_len + 1`` tokens, fed by the port's ``DataLoader``.

Parameters: ``batch``, ``seq_len``, ``windows`` (the corpus size in
windows), ``doc_tokens`` (a :func:`lengths.lognormal_set` spec of document
lengths), ``zipf_a`` (each document's tokens follow a Zipf law
over the vocabulary shifted by an offset of its own, so rows differ in
what they teach)
and ``eod`` (the separator id).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from portbench.traffic import lengths

DRIVER = "train"


def corpus(mix: Dict, seed: int, vocab: int) -> np.ndarray:
    """The corpus as one token array (uint32)."""
    need = int(mix["windows"]) * (int(mix["seq_len"]) + 1)
    gen = lengths.rng(seed, "train_batches")
    n_docs = max(need // int(mix["doc_tokens"]["median"]), 1) * 2
    sizes = lengths.shuffled(lengths.lognormal_set(mix["doc_tokens"], n_docs),
                             gen)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    law = ranks ** -float(mix["zipf_a"])
    law /= law.sum()
    parts, total = [], 0
    for size in sizes:
        shift = int(gen.integers(0, vocab))
        parts.append((gen.choice(vocab, size=size, p=law) + shift) % vocab)
        parts.append(np.array([mix["eod"]]))
        total += size + 1
        if total >= need:
            break
    return np.concatenate(parts).astype(np.uint32)[:need]
