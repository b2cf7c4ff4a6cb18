"""Device kernels launched per training step, from the trace."""

from harness import readers


def read(run):
    return readers.launches(run, "train")
