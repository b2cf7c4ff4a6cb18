"""Device milliseconds per training step under the program's span
``gstpu.backward.composite`` (the pixel cotangents to tiles, K2 and its
epilogue), with the spans inside it."""

from harness import spans


def read(run):
    return spans.ms_per_item(run, "train", "backward.composite")
