"""The comparisons that decide ``correct``.

Served tokens: a sample of finished requests (drawn from the seed, the
longest among them) is run through the plain reference over its prompt
and its served tokens; each served token's logit is compared with the
reference's best at its position, the gap in standard deviations of the
reference's logits there.  ``token_gap_mean`` is the mean gap over the
served tokens.  The widest gap is printed beside it but not compared: it
is set by the one closest tie the rounding tipped, and the int8 control's
widest gap was only about twice the program's, where the mean, which
counts how often a tie tips as well as by how much, separates them
(PERF.md gives both readings).

Routing: the program computes in bf16 and the reference in float32, so a
token whose k-th and (k+1)-th router logits nearly tie can go to other
experts on the two sides, and everything after it then differs.  The
reference therefore follows the program's routing: for each of its own
router rows it finds the program's row of that layer nearest to it (the
router logits the program computed, tapped in the timed path) and takes
that row's top-k experts, and which of them the program's capacity kept,
worked out again from the whole call (GShard's choice-major slots).  That
stage is checked by itself: ``router_gap_mean`` is the mean, over the
rows followed, of the widest difference between a reference row and the
program's row it follows (the widest of all is printed beside it).

Training: see :func:`training`.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.reference import model
from portbench.traffic import lengths

MATCH_CHUNK = 1 << 16


def pick(served, seed: int, conf: Dict) -> list:
    """Finished requests drawn from the seed: the longest first, then
    others until ``min_served_tokens`` are served or ``max_requests``
    taken."""
    done = [s for s in served if s.finished]
    if not done:
        return []
    longest = max(done, key=lambda s: len(s.prompt) + s.max_new)
    rest = [s for s in done if s is not longest]
    order = lengths.rng(seed, "sample").permutation(len(rest))
    out = [longest]
    for i in order:
        if (sum(s.max_new for s in out) >= conf["min_served_tokens"]
                or len(out) >= conf["max_requests"]):
            break
        out.append(rest[i])
    return out


def _fits(logits, k: int, capacity: int, mask) -> torch.Tensor:
    """[T, k]: which of each token's top-k assignments fit its expert's
    capacity, slots taken choice-major, token-minor (masked tokens take
    none)."""
    t, e = logits.shape
    chosen = F.one_hot(model.top_k(logits, k), e).float()      # [T, k, E]
    if mask is not None:
        chosen = chosen * mask.reshape(t).float()[:, None, None]
    flat = chosen.transpose(0, 1).reshape(k * t, e)
    pos = (torch.cumsum(flat, 0) - flat).reshape(k, t, e).transpose(0, 1)
    slot = (pos * chosen).sum(-1)
    return (slot < capacity) & (chosen.sum(-1) > 0)


class _Gaps:
    """The widest and the mean per-row router difference seen."""

    def note(self, theirs, mine) -> None:
        per_row = (theirs - mine).abs().amax(dim=-1)
        self.worst = max(self.worst, per_row.max().item())
        self.total += per_row.sum().item()
        self.rows_seen += per_row.shape[0]

    @property
    def mean(self) -> float:
        return self.total / max(self.rows_seen, 1)


class ProgramRoutes(_Gaps):
    """The program's router calls, by layer (a forward calls the router
    once a layer, in order, and the tap is switched only between steps)."""

    def __init__(self, calls, num_layers: int, k: int, device):
        if not calls or len(calls) % num_layers:
            raise ValueError(f"{len(calls)} router calls for {num_layers} "
                             f"layers")
        self.k, self.calls = k, calls
        self.rows, self.owner = [], []
        for l in range(num_layers):
            mine = list(range(l, len(calls), num_layers))
            self.rows.append(torch.cat([calls[c][0].float().to(device)
                                        for c in mine]))
            self.owner.append(torch.cat([
                torch.stack([torch.full((calls[c][0].shape[0],), c),
                             torch.arange(calls[c][0].shape[0])], 1)
                for c in mine]).to(device))
        self._fit: Dict[int, torch.Tensor] = {}
        self.worst, self.total, self.rows_seen = 0.0, 0.0, 0

    def _kept(self, call: int) -> torch.Tensor:
        if call not in self._fit:
            logits, capacity, mask = self.calls[call]
            self._fit[call] = _fits(logits.float(), self.k, capacity, mask)
        return self._fit[call]

    def route(self, l: int, _i: int):
        def follow(ref_logits):
            rows = self.rows[l]
            best_d = torch.full((ref_logits.shape[0],), float("inf"),
                                device=rows.device)
            best_i = torch.zeros(ref_logits.shape[0], dtype=torch.long,
                                 device=rows.device)
            for s in range(0, rows.shape[0], MATCH_CHUNK):
                d = torch.cdist(ref_logits, rows[s:s + MATCH_CHUNK])
                v, i = d.min(dim=1)
                better = v < best_d
                best_d = torch.where(better, v, best_d)
                best_i = torch.where(better, i + s, best_i)
            theirs = rows[best_i]
            self.note(theirs, ref_logits)
            experts = model.top_k(theirs, self.k)
            owner = self.owner[l][best_i]
            kept = torch.stack([self._kept(int(c))[int(r)]
                                for c, r in owner.tolist()]) \
                if owner.shape[0] else experts.bool()
            return experts, kept
        return follow


class ReplayRoutes(_Gaps):
    """Another side's own router logits at each position (the control's),
    followed exactly; the gaps as :class:`ProgramRoutes`'s."""

    def __init__(self, routes, k: int):
        self.routes, self.k = routes, k
        self.worst, self.total, self.rows_seen = 0.0, 0.0, 0

    def route(self, l: int, i: int):
        def follow(ref_logits):
            theirs = self.routes[i][l]
            self.note(theirs, ref_logits)
            experts = model.top_k(theirs, self.k)
            return experts, torch.ones_like(experts, dtype=torch.bool)
        return follow


def token_gaps(logits: Sequence[torch.Tensor],
               tokens: Sequence[Sequence[int]]) -> Dict[str, float]:
    """The gap between the reference's best logit and the given token's at
    each position, in standard deviations of the row: the mean over all
    positions and the widest."""
    gaps = []
    for lg, toks in zip(logits, tokens):
        t = torch.tensor(list(toks), device=lg.device)[:, None]
        gaps.append((lg.max(-1).values - lg.gather(1, t)[:, 0]) / lg.std(-1))
    gaps = torch.cat(gaps)
    return {"mean": gaps.mean().item(), "widest": gaps.max().item()}


def _numbers(gaps: Dict[str, float], follow) -> Dict[str, Optional[float]]:
    """The numbers compared, then the widest ones (``.widest``), which are
    printed beside them."""
    out = {"token_gap_mean": gaps["mean"]}
    if follow is not False:
        out["router_gap_mean"] = None if follow is None else follow.mean
    out["token_gap_widest"] = gaps["widest"]
    if follow is not False:
        out["router_gap_widest"] = None if follow is None else follow.worst
    return out


def _paths(sample):
    seqs = [list(s.prompt) + list(s.request.output[:-1]) for s in sample]
    spans = [(len(s.prompt) - 1, len(s.prompt) - 1 + len(s.request.output))
             for s in sample]
    return seqs, spans


def served(family, cfg, seed: int, sample, calls, device
           ) -> Dict[str, Optional[float]]:
    """The program's numbers: ``token_gap_mean`` and, for a family that
    routes, ``router_gap_mean`` (then the widest gaps, not compared)."""
    follow = family.served_routes(cfg, calls, device)
    if not sample:
        return _numbers({"mean": None, "widest": None},
                        False if follow is False else None)
    seqs, spans = _paths(sample)
    logits, _ = model.forward(family, cfg, seed, seqs, spans, device,
                              route=follow.route if follow else None)
    return _numbers(token_gaps(logits, [s.request.output for s in sample]),
                    follow)


def served_control(family, cfg, seed: int, sample, device
                   ) -> Dict[str, float]:
    """The control's numbers on the same prompts and served tokens: the
    int8 reference's first choice at each position, judged by the float32
    reference following the control's routing."""
    seqs, spans = _paths(sample)
    low, routes = model.forward(family, cfg, seed, seqs, spans, device,
                                precision="int8")
    picks = [lg.argmax(-1).tolist() for lg in low]
    del low
    follow = family.replayed_routes(cfg, routes)
    ref, _ = model.forward(family, cfg, seed, seqs, spans, device,
                           route=follow.route if follow else None)
    return _numbers(token_gaps(ref, picks), follow)


def _leaf_gap(prog: Dict, ref: Dict, skip=()) -> float:
    """The widest gap between the program's and the reference's norm of
    a leaf, against the larger of the reference's norm of that leaf and of
    the median leaf."""
    keys = [k for k in ref if k not in skip]
    median = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], median) for k in keys)


def training(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``loss_gap``: the first step's loss against the reference's (the
    later steps' losses swing with the updates before them: see
    PERF.md); ``grad_gap``: the first gradient as the optimizer got it,
    by the worst leaf (layer slice); ``update_gap``: the parameters'
    change over the steps, by the worst leaf, leaving out leaves whose
    reference gradient is under a thousandth of the median leaf's (their
    change is round-off); for MoE ``router_gap``: the widest difference
    of the reference's router logits from those of the side it follows
    (``ref["router_gap"]``)."""
    g_med = statistics.median(ref["grad"].values())
    still = {k for k, v in ref["grad"].items() if v < 1e-3 * g_med}
    out = {"loss_gap": abs(prog["loss"][0] - ref["loss"][0]),
           "grad_gap": _leaf_gap(prog["grad"], ref["grad"]),
           "update_gap": _leaf_gap(prog["update"], ref["update"], still)}
    if "router_gap" in ref:
        out["router_gap"] = ref["router_gap"]
    return out


def leaf_key(name: str, layer: int) -> str:
    return name if layer < 0 else f"{name}.{layer}"
