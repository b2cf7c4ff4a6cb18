"""Spans and counters of the port, on the profiler's clock.

``span(name)`` marks one layer of a frame or of a training step.  While a
``torch.profiler`` records it is ``record_function("gstpu." + name)``, so
the span lands in the profiler's Chrome trace beside the device kernels,
on one clock: a kernel, or an idle gap of the device, is put down to the
innermost span open on the thread that launched it.  With no profiler
recording it is one shared ``contextlib.nullcontext()``: tracing is on
exactly when a profiler is on, and has no switch of its own.  Spans nest;
a layer's self time is its span less its children.

``COUNTERS`` holds the port's host integers by name (``KEYS``): kernel
launches and CTAs, binnings and preprocesses through the kernels, the
bytes each collective hands to the backend, and pairs against pair slots.
Each is added where the host already holds the value, so no span or
counter reads the device, synchronizes or launches.

``TRACED`` holds what was added to the counters while a profiler recorded:
the counters of a profiled window alone, read after it.
"""

from __future__ import annotations

import contextlib
import threading

import torch

PREFIX = "gstpu."

KEYS = (
    "k1.launches", "k1.ctas", "k2.launches", "k2.ctas",
    # each binning through the kernels of csrc/binning.cu
    "binning.launches",
    # each preprocess through the kernel of csrc/preprocess.cu
    "preprocess.launches",
    "collective.bytes.all_gather", "collective.bytes.reduce_scatter",
    "collective.bytes.all_reduce", "collective.bytes.exchange",
    # each render_gaussians render: its pairs and the pair capacity it ran at
    "render.pairs", "render.pair_slots",
    # each training step the Trainer's flush fetched: pairs and culled
    # pairs against the capacities, the steps replayed and the windows
    # rolled back
    "train.pairs", "train.pair_slots", "train.kept", "train.kept_slots",
    "train.replays", "train.rollbacks",
)

TRACED: dict[str, int] = {}


class Counters(dict):
    """Host integers by name, every name of ``KEYS`` from 0; ``add`` may be
    called from several threads (K2 is launched on autograd's)."""

    def __init__(self):
        super().__init__(dict.fromkeys(KEYS, 0))
        self._lock = threading.Lock()

    def add(self, key: str, n: int = 1) -> None:
        profiled = torch.autograd._profiler_enabled()
        with self._lock:
            self[key] += n
            if profiled:
                TRACED[key] = TRACED.get(key, 0) + n


COUNTERS = Counters()
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager marking one layer as ``gstpu.<name>`` while a
    profiler records; the shared null context otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def traced(key: str) -> int:
    """What was added to ``COUNTERS[key]`` while a profiler recorded."""
    return TRACED.get(key, 0)
