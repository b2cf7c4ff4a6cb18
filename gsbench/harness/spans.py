"""The profiled window's device time put down to the program's spans.

The port marks each layer of a frame or of a training step with a span,
``gstpu.<layer>`` (``gstpu_torch/utils/tracing.py``): a ``user_annotation``
in the Chrome trace that ``trace.profiled`` writes, on the device kernels'
clock.  For each device operation in the window, ``read`` finds its launch
by ``correlation``, then the innermost span open on the launching thread at
that moment, and returns per span:

- ``device_s``: the device seconds of the operations it launched itself
  (its self time); ``device_incl_s`` with those of the spans inside it;
- ``host_s``: its host seconds less those of the spans inside it;
- ``idle_s``: the device's idle gaps by the span whose launch ends each
  gap (``UNSPANNED`` where no span was open, ``WINDOW_END`` for the gap
  that ends the window, ``NO_LAUNCH`` where the launch is not in the
  trace);

and ``unspanned_s``, the device seconds launched outside every span.  A
trace with no span (a program without them) reads as None.

``of(run)`` finds the trace that this run's ``trace.profiled`` wrote under
``TMPDIR`` (``gsbench_<cell>_<seed>.json.gz``, the newest written since the
run started), reads it once and notes the breakdown on standard error.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import gzip
import json
import os
import tempfile
import time
from pathlib import Path

from harness import base, readers, trace

PREFIX = "gstpu."
UNSPANNED = "_unspanned_"
WINDOW_END = "_window_end_"
NO_LAUNCH = "_no_launch_"


@dataclasses.dataclass
class Spans:
    device_s: dict        # span -> device seconds it launched itself
    device_incl_s: dict   # span -> with the spans inside it
    host_s: dict          # span -> host seconds less the spans inside it
    idle_s: dict          # span (or UNSPANNED, ...) -> idle gaps it ended
    unspanned_s: float    # device seconds launched outside every span
    device_total_s: float  # device seconds of every operation in the window


def _nest(spans):
    """Each span's parent index (the innermost span of its thread that
    holds it) or None; ``spans`` sorted by (thread, start, -end)."""
    parents, open_ = [], []
    for i, (tid, a, b, _) in enumerate(spans):
        while open_ and (spans[open_[-1]][0] != tid or spans[open_[-1]][2] < b):
            open_.pop()
        parents.append(open_[-1] if open_ else None)
        open_.append(i)
    return parents


def read(path) -> Spans | None:
    """The breakdown of one ``trace.profiled`` window by span."""
    with gzip.open(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    win = next(e for e in events if e.get("name") == trace.WINDOW
               and e.get("cat") in ("user_annotation", "cpu_op"))
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    spans, device, launches = [], [], {}
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith(PREFIX):
            spans.append((e.get("tid"), ts, ts + dur, name[len(PREFIX):]))
        elif cat in trace.DEVICE_CATS:
            a, b = max(ts, w0), min(ts + dur, w1)
            if b > a:
                device.append((a, b, (e.get("args") or {}).get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (ts, e.get("tid"))
    if not spans:
        return None
    spans.sort(key=lambda s: (str(s[0]), s[1], -s[2]))
    parents = _nest(spans)
    by_tid = collections.defaultdict(list)     # contiguous, in start order
    for i, s in enumerate(spans):
        by_tid[s[0]].append(i)
    starts = {tid: [spans[i][1] for i in ix] for tid, ix in by_tid.items()}

    def innermost(corr):
        """The index of the span open at the launch, or a label."""
        if corr not in launches:
            return NO_LAUNCH
        ts, tid = launches[corr]
        ix = by_tid.get(tid)
        if not ix:
            return UNSPANNED
        # a span that does not hold the launch ended before it; of the
        # spans open then, each holds that one, so walk up its parents
        k = ix[0] + bisect.bisect_right(starts[tid], ts) - 1
        while k >= ix[0]:
            if spans[k][2] >= ts:
                return k
            k = ix[0] - 1 if parents[k] is None else parents[k]
        return UNSPANNED

    self_s = collections.defaultdict(float)
    incl_s = collections.defaultdict(float)
    unspanned = total = 0.0
    owner = []
    for a, b, corr in device:
        k = innermost(corr)
        owner.append(k)
        seconds = (b - a) * 1e-6
        total += seconds
        if isinstance(k, str):
            unspanned += seconds
            continue
        self_s[spans[k][3]] += seconds
        while k is not None:
            incl_s[spans[k][3]] += seconds
            k = parents[k]

    host = collections.defaultdict(float)
    for i, (_, a, b, name) in enumerate(spans):
        host[name] += (b - a) * 1e-6
        if parents[i] is not None:
            host[spans[parents[i]][3]] -= (b - a) * 1e-6

    order = sorted(range(len(device)), key=lambda i: device[i][0])
    op_starts = [device[i][0] for i in order]
    busy = trace._union([(a, b) for a, b, _ in device])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = collections.defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        i = bisect.bisect_left(op_starts, b)
        k = owner[order[i]] if i < len(order) else WINDOW_END
        idle[k if isinstance(k, str) else spans[k][3]] += (b - a) * 1e-6
    return Spans(device_s=dict(self_s), device_incl_s=dict(incl_s),
                 host_s=dict(host), idle_s=dict(idle), unspanned_s=unspanned,
                 device_total_s=total)


def path_of(run) -> Path | None:
    """The Chrome trace of this run's profiled window: the newest
    ``gsbench_*_<seed>.json.gz`` under ``TMPDIR`` written since the run
    started, or None."""
    folder = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    started = time.time() - (time.perf_counter() - run.t0)
    found = [p for p in folder.glob(f"gsbench_*_{run.seed}.json.gz")
             if p.stat().st_mtime >= started - 1.0]
    return max(found, key=lambda p: p.stat().st_mtime, default=None)


_READ: dict = {}


def of(run) -> Spans | None:
    """This run's breakdown by span (read once, and noted on standard
    error), or None."""
    path = path_of(run)
    if path is None:
        return None
    key = (str(path), path.stat().st_mtime_ns)
    if key not in _READ:
        _READ[key] = found = read(path)
        if found is not None:
            items = max(run.traced_items, 1)

            def per_item_ms(d):
                return {k: round(v * 1e3 / items, 4)
                        for k, v in sorted(d.items(), key=lambda x: -x[1])}
            base.note(spans_ms_per_item={
                "device_incl": per_item_ms(found.device_incl_s),
                "device_self": per_item_ms(found.device_s),
                "host_self": per_item_ms(found.host_s),
                "idle_by_span": per_item_ms(found.idle_s),
                "unspanned": found.unspanned_s * 1e3 / items,
                "unspanned_pct": 100.0 * found.unspanned_s
                / max(found.device_total_s, 1e-12)})
    return _READ[key]


def ms_per_item(run, kind: str, span: str):
    """The device milliseconds under ``span`` (with the spans inside it)
    per traced step or frame, or None."""
    if not readers.traced(run, kind):
        return None
    found = of(run)
    if found is None:
        return None
    return found.device_incl_s.get(span, 0.0) * 1e3 / run.traced_items
