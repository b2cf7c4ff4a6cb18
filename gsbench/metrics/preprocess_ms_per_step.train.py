"""Device milliseconds per training step under the program's span
``gstpu.forward.preprocess`` (projection, covariances, SH colours, radii and
tile rects), with the spans inside it."""

from harness import spans


def read(run):
    return spans.ms_per_item(run, "train", "forward.preprocess")
