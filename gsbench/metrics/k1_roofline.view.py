"""K1 (rasterize_fwd_kernel) in the render: its least time on the chip over
the traced frames' walks, as a share of its traced time."""

from harness import readers


def read(run):
    return readers.roofline(run, "view", readers.K1)
