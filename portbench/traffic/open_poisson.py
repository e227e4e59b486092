"""Open-loop arrivals: independent users who send on a schedule, whatever
the system's state.  The gaps are exponential (a Poisson process's);
the lead-in, the window and the tail each get exactly their share of
arrivals, the same set of gaps and sizes on every seed, in another order
(:mod:`lengths`).

Parameters (the mix's file): ``lead_in_s`` of arrivals before the window,
``tail_s`` of arrivals after it (load stays on while the window's last
requests finish), ``prompt_tokens`` and ``output_tokens`` as
:func:`lengths.lognormal` specs.  The rate is the cell's
(``rate_per_s``): it is found once for each configuration.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

from portbench.traffic import lengths

DRIVER = "serve"


def schedule(mix: Dict, cell: Dict, seed: int, seconds: float,
             vocab: int) -> List[Dict]:
    """Every request of the run: ``at`` (seconds from the window's start;
    negative in the lead-in), ``prompt`` (token ids) and ``max_new``."""
    rate = float(cell["rate_per_s"])
    gen = lengths.rng(seed, "open_poisson")
    out = []
    for start, span in ((-float(mix["lead_in_s"]), float(mix["lead_in_s"])),
                        (0.0, float(seconds)),
                        (float(seconds), float(mix["tail_s"]))):
        n = max(int(round(rate * span)), 1)
        gaps = lengths.shuffled(lengths.gaps_over(span, n), gen)
        prompts = lengths.shuffled(
            lengths.lognormal_set(mix["prompt_tokens"], n), gen)
        outputs = lengths.shuffled(
            lengths.lognormal_set(mix["output_tokens"], n), gen)
        t = start
        for gap, p, m in zip(gaps, prompts, outputs):
            out.append({"at": t, "prompt": gen.integers(0, vocab, p).tolist(),
                        "max_new": m})
            t += gap
    return out


def _send(plan, t0: float, stop: threading.Event, submit) -> None:
    for item in plan:
        due = t0 + item["at"]
        while not stop.is_set():
            wait = due - time.time()
            if wait <= 0:
                break
            stop.wait(min(wait, 0.5))
        if stop.is_set():
            return
        submit(item, due)


def feed(plan, mix: Dict, t0: float, stop: threading.Event, submit):
    """One sender: each request at its time, whether or not the last
    has been answered."""
    return [threading.Thread(target=_send, args=(plan, t0, stop, submit),
                             daemon=True)]


def settle(mix: Dict, served, t0: float, t1: float) -> None:
    """Load stays on while the window's last requests finish, for up to
    ``tail_s``."""
    deadline = t1 + float(mix["tail_s"])
    window = [s for s in served if t0 <= s.due < t1]
    while (time.time() < deadline
           and not all(s.request.done.is_set() for s in window)):
        time.sleep(0.1)


def account(run):
    """Every request due in the window; one that did not finish failed."""
    window = run.in_window()
    return window, sum(1 for s in window if not s.finished)
