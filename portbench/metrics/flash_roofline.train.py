"""K1/K2 (ops/csrc/flash_fwd.cu, flash_bwd.cu): least time of the traced launches at the cell's shape over their device time."""

from portbench import readers

UNIT = "%"


def read(run):
    return readers.flash_roofline(run)
