"""Time per output token after the first, (last - first) / (tokens - 1) a request, median over the window's requests."""

from portbench import readers

UNIT = "ms"


def read(run):
    return readers.tpot_ms(run, 50)
