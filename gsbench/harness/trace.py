"""A profiled sub-window, and what its trace says.

``profiled`` runs a callable under ``torch.profiler`` (host and device
activities) inside a ``gsbench.window`` range that ends in a synchronize,
writes the Chrome trace gzipped under ``TMPDIR`` and reads it back into a
``Trace``: the window's length, the seconds in which some operation ran on
the device, the kernels by name, and the idle gaps by the host operation
that launched the work ending each gap.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import gzip
import json
import os
import tempfile
from pathlib import Path

import torch

WINDOW = "gsbench.window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
NAME_CHARS = 64


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    sync_s: float                 # host time inside synchronizing calls
    kernels: dict                 # name -> [seconds, count]
    device_ops: list              # [[name, seconds]], most time first
    idle_gaps: list               # [[host op, seconds]], longest first

    def kernel(self, fragment: str) -> tuple[float, int]:
        """Seconds and launches of the kernels whose name holds
        ``fragment``."""
        hits = [v for k, v in self.kernels.items() if fragment in k]
        return sum(s for s, _ in hits), sum(n for _, n in hits)

    @property
    def launches(self) -> int:
        return sum(n for _, n in self.kernels.values())

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def profiled(fn, name: str) -> Trace:
    """Run ``fn()`` under the profiler and read its trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize()
    path = Path(os.environ.get("TMPDIR") or tempfile.gettempdir()) / f"{name}.json.gz"
    prof.export_chrome_trace(str(path))
    return read(path)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(ops_by_tid, tid, t):
    """The name of the innermost host operation running at ``t``."""
    starts, ops = ops_by_tid.get(tid, ((), ()))
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 400, -1), -1):
        if ops[j][1] >= t:
            return ops[j][2]
    return "_no_host_op_"


def read(path) -> Trace:
    """Reduce a Chrome trace of one ``profiled`` window."""
    with gzip.open(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    win = next(e for e in events if e.get("name") == WINDOW
               and e.get("cat") in ("user_annotation", "cpu_op"))
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])

    device, launches, ops_by_tid = [], {}, collections.defaultdict(list)
    sync_us = 0.0
    for e in events:
        cat = e.get("cat")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            a, b = max(ts, w0), min(ts + dur, w1)
            if b > a:
                device.append((a, b, e["name"], (e.get("args") or {}).get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (ts, e.get("tid"))
            if "Synchronize" in e["name"] and w0 <= ts <= w1:
                sync_us += dur
        elif cat == "cpu_op":
            ops_by_tid[e.get("tid")].append((ts, ts + dur, e["name"]))
    ops_index = {}
    for tid, ops in ops_by_tid.items():
        ops.sort()
        ops_index[tid] = ([o[0] for o in ops], ops)

    kernels = collections.defaultdict(lambda: [0.0, 0])
    by_name = collections.defaultdict(float)
    for a, b, name, _ in device:
        by_name[name[:NAME_CHARS]] += (b - a) * 1e-6
    for e in events:
        if e.get("cat") == "kernel" and w0 <= float(e["ts"]) <= w1:
            k = kernels[e["name"]]
            k[0] += float(e.get("dur", 0.0)) * 1e-6
            k[1] += 1

    busy = _union([(a, b) for a, b, _, _ in device])
    gaps = collections.defaultdict(float)
    device.sort()
    starts = [d[0] for d in device]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        i = bisect.bisect_left(starts, b)
        host = "_window_end_"
        if i < len(device):
            corr = device[i][3]
            if corr in launches:
                ts, tid = launches[corr]
                host = _innermost(ops_index, tid, ts)
            else:
                host = "_no_host_op_"
        gaps[host] += (b - a) * 1e-6
    return Trace(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        sync_s=sync_us * 1e-6,
        kernels=dict(kernels),
        device_ops=sorted(([k, v] for k, v in by_name.items()), key=lambda x: -x[1])[:10],
        idle_gaps=sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:10])
