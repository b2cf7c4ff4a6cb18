"""What every driver shares: the run's protocol and small helpers.

A driver is the general generator of one kind of traffic.  It lives in
``gsbench/drivers/<name>.py`` as a class ``Driver`` derived from
``base.Driver``; a traffic mix names it (``"driver"``), and a
configuration names the scene it is driven on (``"scene"``, a module
``gsbench/scenes/<name>.py``).  A run goes:

    setup() -> window(seconds) -> [traced(items, name)] -> readings() -> compare()

``readings`` is the comparison's protocol, the same for every run, every
calibration and every card test: take the program's readings, free the
program's state, then let the reference work out its own.
"""

from __future__ import annotations

import json
import math
import sys
import time

import numpy as np
import torch

from harness import counts
from reference import splat


def camera(cam: dict, cfg: dict, device) -> splat.Camera:
    return splat.Camera(
        view=torch.from_numpy(cam["view"]).to(device),
        proj=torch.from_numpy(cam["proj"]).to(device),
        campos=torch.from_numpy(cam["campos"]).to(device),
        tan_fovx=cam["tan_fovx"], tan_fovy=cam["tan_fovy"],
        width=cfg["width"], height=cfg["height"])


def camera_tensors(cams: list[dict], device) -> dict:
    """Cameras stacked on the device."""
    return {k: torch.from_numpy(np.stack([c[k] for c in cams])).to(device)
            for k in ("view", "proj", "campos")}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def relative_gap(got: float, want: float, scale: float) -> float:
    return abs(got - want) / scale if scale > 0 else abs(got - want)


def norm_gaps(got: dict, want: dict, skip=()) -> float:
    """The worst leaf's gap between two per-leaf norms, against the
    reference's norm of that leaf."""
    return max((relative_gap(got[k], want[k], want[k])
                for k in want if k not in skip), default=0.0)


def note(**kw) -> None:
    """One JSON line of what the run saw, on standard error."""
    print(json.dumps(kw), file=sys.stderr, flush=True)


def walk_of(pairs, out) -> dict:
    """The reference's walk of one traced step or frame, and its tiles."""
    count = pairs.tile_count
    return {"evaluated": out["evaluated"], "kept": out["kept"],
            "num_pairs": pairs.num_pairs, "num_kept": pairs.num_kept,
            "segments": counts.segments(count), "tiles": len(count),
            "nonempty_tiles": int((count > 0).sum()), "deepest_tile": int(count.max())}


def p95(values) -> float:
    """The 95th percentile, nearest rank, of every value."""
    ordered = sorted(values)
    return ordered[max(math.ceil(0.95 * len(ordered)) - 1, 0)]


class Driver:
    """One run of one cell.  A driver sets ``kind`` (the per-layer
    readers read only runs of their kind) and implements ``setup``,
    ``window``, ``traced``, ``flops``, ``program_readings``, ``free``,
    ``reference_readings`` and ``compare``.  ``faults`` names the faults
    that calibration plants in the reference put in the program's place:
    each a context manager."""

    kind = ""
    faults: dict = {}

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, t0: float, scene):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.scene = scene
        self.t0 = t0
        self.attempted = self.failed = 0
        self.setup_s = 0.0
        self.window_s = 0.0
        self.reference_s = 0.0
        self.trace = None
        self.walks: list[dict] = []     # the reference's walk of traced items
        self.traced_items = 0

    def readings(self) -> tuple:
        """(the program's readings, the reference's), the program's state
        freed before the reference runs."""
        got = self.program_readings()
        self.free()
        t = time.perf_counter()
        want = self.reference_readings(got)
        self.reference_s = time.perf_counter() - t
        return got, want
