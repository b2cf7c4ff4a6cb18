"""Device milliseconds per rendered frame under the program's span
``gstpu.forward.composite`` (the Gaussian table, the work order and K1),
with the spans inside it."""

from harness import spans


def read(run):
    return spans.ms_per_item(run, "view", "forward.composite")
