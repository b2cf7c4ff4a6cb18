"""Binning's share of useful pair slots over the traced frames: 100 times
the program's counters ``render.pairs`` over ``render.pair_slots``, as they
changed under the profiler (``gstpu_torch.utils.tracing.traced``).  None
for a program without those counters."""

from harness import readers


def read(run):
    if not readers.traced(run, "view"):
        return None
    try:
        from gstpu_torch.utils import tracing
    except ImportError:
        return None
    slots = tracing.traced("render.pair_slots")
    return 100.0 * tracing.traced("render.pairs") / slots if slots else None
