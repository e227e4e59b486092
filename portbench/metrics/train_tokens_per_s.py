"""Tokens of every step completed in the window over the window."""

from portbench import readers

UNIT = "tokens/s"


def read(run):
    return readers.train_tokens_per_s(run)
