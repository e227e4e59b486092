"""Set-up: process start to the window (loading, drawing the weights, building or fetching the kernels, warming the cell's shapes; a training cell's first steps, without the check's own reads)."""

UNIT = "s"


def read(run):
    return run.setup_s
