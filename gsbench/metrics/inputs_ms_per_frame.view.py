"""Device milliseconds per rendered frame under the program's span
``gstpu.render.inputs`` (the float32 moves of the inputs and the SH
padding), with the spans inside it."""

from harness import spans


def read(run):
    return spans.ms_per_item(run, "view", "render.inputs")
