"""Host milliseconds per training step in the traced sub-window, less its
waits in synchronizing calls."""

from harness import readers


def read(run):
    return readers.host_ms(run, "train")
