"""Device milliseconds per training step under the program's span
``gstpu.forward.binning`` (the band clip, the cull threshold and the pair
list, at the pair capacity), with the spans inside it."""

from harness import spans


def read(run):
    return spans.ms_per_item(run, "train", "forward.binning")
