"""Device kernels launched per rendered frame, from the trace."""

from harness import readers


def read(run):
    return readers.launches(run, "view")
