"""The reductions behind the metric readers (``metrics/<name>.py``).

Each takes the driver's run record (``serve.ServeRun`` or
``train.TrainRun``) and returns a number, or None where it finds nothing
to read (no trace, a range the program no longer reaches, no kernel of
that name): the harness then leaves the metric out of the line.
"""

from __future__ import annotations

import re
from typing import Optional

from portbench import stats
from portbench.frozen import bounds

FLASH_FWD = re.compile(r"flash.*\bfwd_kernel")
FLASH_BWD = re.compile(r"flash.*\b(bwd|prep|post)_kernel")
FLASH_BWD_MAIN = re.compile(r"flash.*\bbwd_kernel")


def _missing(run, since: float) -> float:
    """A request that never got there waited until the run ended."""
    return run.end - since


def ttft_s(run, s) -> float:
    return (s.times[0] - s.due) if s.times else _missing(run, s.due)


def tpot_s(run, s) -> Optional[float]:
    if s.finished:
        return ((s.times[-1] - s.times[0]) / (len(s.times) - 1)
                if len(s.times) > 1 else None)
    return _missing(run, s.times[0] if s.times else s.due) / max(
        len(s.times) - 1, 1)


def percentile_ms(values, q: float) -> Optional[float]:
    values = [v for v in values if v is not None]
    return stats.percentile(values, q) * 1e3 if values else None


def ttft_ms(run, q: float) -> Optional[float]:
    return percentile_ms((ttft_s(run, s) for s in run.in_window()), q)


def tpot_ms(run, q: float) -> Optional[float]:
    return percentile_ms((tpot_s(run, s) for s in run.in_window()), q)


def queue_wait_p90_ms(run) -> Optional[float]:
    def wait(s):
        r = s.request
        if r.admitted_at is None:
            return _missing(run, r.submitted_at)
        return r.admitted_at - r.submitted_at
    return percentile_ms((wait(s) for s in run.in_window()), 90)


def idle_share(run) -> Optional[float]:
    tr = run.trace
    if tr is None or tr.window is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def range_share(run, label: str) -> Optional[float]:
    """Device time of the kernels launched inside range ``label``, as a
    share of the device's busy time, in %."""
    tr = run.trace
    if tr is None or tr.window is None:
        return None
    under = tr.device_s(label)
    return 100.0 * under / tr.busy_s if under > 0 else None


def flash_roofline(run) -> Optional[float]:
    """Least time of every traced K1 and K2 launch at the cell's shape (the
    family's count) over their kernels' device time (the backward's pre-
    and post-pass with it), in %."""
    tr = run.trace
    if tr is None:
        return None
    n_fwd = n_bwd = 0
    fwd_s = bwd_s = 0.0
    for name, _ts, dur, _ in tr.ops:
        if FLASH_FWD.search(name):
            n_fwd += 1
            fwd_s += dur / 1e6
        elif FLASH_BWD.search(name):
            bwd_s += dur / 1e6
            n_bwd += bool(FLASH_BWD_MAIN.search(name))
    if fwd_s + bwd_s <= 0:
        return None
    least_s = run.cell.family.flash_least_s(run.cfg, run.batch, run.seq,
                                            n_fwd, n_bwd)
    return 100.0 * least_s / (fwd_s + bwd_s)


def train_tokens_per_s(run) -> float:
    return run.steps * run.batch * run.seq / run.seconds


def train_mfu(run) -> float:
    """The family's model operations of every step in the window over the
    window, against the bf16 peak, in %."""
    total = run.cell.family.train_flops(run.cfg, run.batch,
                                        run.seq) * run.steps
    return 100.0 * total / (run.seconds * bounds.PEAK_BF16_FLOPS)
