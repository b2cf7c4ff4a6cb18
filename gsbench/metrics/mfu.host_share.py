"""The whole training step's operations at the float32 peak, as a share of
the traced sub-window."""

from harness import readers


def read(run):
    return readers.mfu(run, "train")
