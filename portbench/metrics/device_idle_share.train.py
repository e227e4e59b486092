"""Device: 1 - time any device operation ran over the traced steps."""

from portbench import readers

UNIT = "%"


def read(run):
    return readers.idle_share(run)
