"""K1/K2 latent attention (ops/csrc/flash_fwd.cu, flash_bwd.cu: mla_fwd_kernel, mla_bwd_kernel): their least time (the family's flash_least_s at the cell's shape) over their device time, the backward's pre- and post-pass (mla_prep_kernel, mla_post_kernel) with it, traced steps."""

import re

UNIT = "%"
FWD = re.compile(r"flash.*\bmla_fwd_kernel")
BWD = re.compile(r"flash.*\bmla_bwd_kernel")
PASSES = re.compile(r"flash.*\bmla_(prep|post)_kernel")


def read(run):
    """None where the trace holds no latent launch (a program without
    them, as the parent of the change that brings them)."""
    tr = run.trace
    if tr is None:
        return None
    n_fwd = n_bwd = 0
    seconds = 0.0
    for name, _ts, dur, _ in tr.ops:
        if FWD.search(name):
            n_fwd += 1
        elif BWD.search(name):
            n_bwd += 1
        elif not PASSES.search(name):
            continue
        seconds += dur / 1e6
    if n_fwd + n_bwd == 0 or seconds <= 0:
        return None
    least = run.cell.family.flash_least_s(run.cfg, run.batch, run.seq, n_fwd,
                                          n_bwd)
    return 100.0 * least / seconds
