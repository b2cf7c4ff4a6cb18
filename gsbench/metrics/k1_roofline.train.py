"""K1 (rasterize_fwd_kernel) in training: its least time on the chip over
the traced steps' walks, as a share of its traced time."""

from harness import readers


def read(run):
    return readers.roofline(run, "train", readers.K1)
