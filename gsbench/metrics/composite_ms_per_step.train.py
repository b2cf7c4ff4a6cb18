"""Device milliseconds per training step under the program's span
``gstpu.forward.composite`` (the Gaussian table, the work order and K1 with
its checkpoints), with the spans inside it."""

from harness import spans


def read(run):
    return spans.ms_per_item(run, "train", "forward.composite")
