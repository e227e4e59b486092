"""Whole train step: model operations of every step in the window over the window, against the bf16 peak."""

from portbench import readers

UNIT = "%"


def read(run):
    return readers.train_mfu(run)
