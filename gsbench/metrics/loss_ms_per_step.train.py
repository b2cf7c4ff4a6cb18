"""Device milliseconds per training step under the program's span
``gstpu.loss`` (L1 and SSIM), with the spans inside it."""

from harness import spans


def read(run):
    return spans.ms_per_item(run, "train", "loss")
