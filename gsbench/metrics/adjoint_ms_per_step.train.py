"""Device milliseconds per training step under the program's span
``gstpu.backward.adjoint`` (the adjoint chain of preprocess: cov2d,
projection, SH, cov3d and depth), with the spans inside it."""

from harness import spans


def read(run):
    return spans.ms_per_item(run, "train", "backward.adjoint")
