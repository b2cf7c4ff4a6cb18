"""Shared arithmetic of the per-layer metric readers (``gsbench/metrics``).

Each reads a finished run: ``run.kind`` ("train" or "view"), ``run.trace``
(the profiled sub-window, ``harness.trace.Trace``), ``run.walks`` (the
reference's walk of each traced step or frame) and the program's counters.
A reader that finds nothing to read returns None.
"""

from __future__ import annotations

from harness import counts

K1 = "rasterize_fwd_kernel"
K2 = "rasterize_bwd_kernel"


def traced(run, kind: str) -> bool:
    return run.kind == kind and run.trace is not None and run.traced_items > 0


def host_ms(run, kind: str):
    """The host's milliseconds per traced item: the sub-window less the
    time the host waited in synchronizing calls."""
    if not traced(run, kind):
        return None
    return (run.trace.window_s - run.trace.sync_s) * 1e3 / run.traced_items


def launches(run, kind: str):
    if not traced(run, kind):
        return None
    return run.trace.launches / run.traced_items


def roofline(run, kind: str, kernel: str):
    """The kernel's least time on the chip over the traced items' walks,
    as a share of the time the trace gives it."""
    if not traced(run, kind):
        return None
    seconds, n = run.trace.kernel(kernel)
    if n == 0 or seconds <= 0 or n != len(run.walks):
        return None
    gaussians = run.gaussians
    bound = 0.0
    for w in run.walks:
        if kernel == K1:
            work = counts.k1_work(w["evaluated"], gaussians, w["kept_slots"],
                                  w["tiles"], w.get("segments", 0))
        else:
            work = counts.k2_work(w["evaluated"], w["kept"], gaussians,
                                  w["kept_slots"], w["tiles"], w["segments"])
        bound += counts.bound_s(*work)
    return 100.0 * bound / seconds


def mfu(run, kind: str):
    """The traced items' operations at the float32 peak, as a share of
    the sub-window."""
    if not traced(run, kind) or len(run.walks) != run.traced_items:
        return None
    ops = sum(run.flops(w) for w in run.walks)
    return 100.0 * ops / (counts.PEAK_FP32_FLOPS * run.trace.window_s)


def idle_pct(run, kind: str):
    if not traced(run, kind):
        return None
    return run.trace.idle_pct
