"""Share of the traced training sub-window in which no operation ran on the
device."""

from harness import readers


def read(run):
    return readers.idle_pct(run, "train")
