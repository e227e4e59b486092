"""MoE layer (models/moe.py _moe_mlp): device time of what it launches over the device's busy time, traced stretch."""

from portbench import readers

UNIT = "%"


def read(run):
    return readers.range_share(run, "portbench.moe")
