"""Device milliseconds per training step under the program's span
``gstpu.adam`` (the Adam step), with the spans inside it."""

from harness import spans


def read(run):
    return spans.ms_per_item(run, "train", "adam")
