"""K2 (rasterize_bwd_kernel) from K1's checkpoints: its least time on the
chip over the traced steps' walks, as a share of its traced time."""

from harness import readers


def read(run):
    return readers.roofline(run, "train", readers.K2)
