"""K1/K2 (ops/csrc/flash_fwd.cu, flash_bwd.cu): the windowed instantiations' least time (the family's flash_window_least_s at the cell's shape) over their device time, the backward's pre- and post-pass with it, traced steps."""

import re

UNIT = "%"
FWD = re.compile(r"flash.*\bfwd_kernel<\d+, true>")
BWD = re.compile(r"flash.*\bbwd_kernel<\d+, true>")
PREP = re.compile(r"flash.*\bprep_kernel")
POST = re.compile(r"flash.*\bpost_kernel")


def read(run):
    """A windowed backward is the pre-pass launched just before its main
    kernel and the post-pass just after (one stream, in order); None
    where the trace holds no windowed launch or the family gives no
    windowed bound."""
    tr = run.trace
    least = getattr(run.cell.family, "flash_window_least_s", None)
    if tr is None or least is None:
        return None
    n_fwd = n_bwd = 0
    seconds = 0.0
    prep = 0.0
    take_post = False
    for name, _ts, dur, _ in sorted(tr.ops, key=lambda op: op[1]):
        if FWD.search(name):
            n_fwd += 1
            seconds += dur / 1e6
        elif PREP.search(name):
            prep = dur / 1e6
        elif BWD.search(name):
            n_bwd += 1
            seconds += dur / 1e6 + prep
            take_post = True
        elif POST.search(name) and take_post:
            seconds += dur / 1e6
            take_post = False
    if n_fwd + n_bwd == 0 or seconds <= 0:
        return None
    return 100.0 * least(run.cfg, run.batch, run.seq, n_fwd, n_bwd) / seconds
