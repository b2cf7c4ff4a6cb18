"""Extended benchmark of the port: one JSON line per metric.

Port of ``scripts/bench_suite.py``.  On the bench's 100k-Gaussian scene at
800x800 (``bench.bench_scene``), at a fixed pair capacity of 2^19 with no
pair cull:

- ``render_only_ms_per_frame``: the forward render (the viewer's workload);
- ``rasterize_fwd_bwd_ms_per_frame``: the autograd render, L1 and
  ``torch.autograd.grad`` over the five parameter groups;
- ``train_step_ms``: ``trainer.train_step`` (render, L1, backward, Adam with
  ``schedule_lrs``) of a capacity-100k model that is all alive;

and with ``--ply`` on that point cloud at a pair capacity of 2^20, seen by
the camera of the bench's trained-scene rule (camera 0 and image 0 of
``--dataset``'s train split, else ``scenes.lego_orbit(0, 800)`` and a target
from the headline's generator):

- ``trained_scene_render_ms`` and ``trained_scene_fwd_bwd_ms``.

Each time is the slope between 13 and 3 calls after 2 warm-up calls.

    python -m gstpu_torch.bench_suite [--ply PATH] [--dataset DIR]

It needs the CUDA card.  ``workloads`` builds the timed functions for any
device and size, so a test can call them on the CPU.
"""

from __future__ import annotations

import argparse
import json

import torch

from gstpu_torch import bench
from gstpu_torch.config import GSConfig, RenderSettings
from gstpu_torch.models.gaussians import GaussianModel
from gstpu_torch.ops.rasterize import render_forward
from gstpu_torch.optim import init_adam_state
from gstpu_torch.render import resolve_device
from gstpu_torch.sol_model import card
from gstpu_torch.trainer import train_step

PAIR_CAPACITY = 1 << 19
TRAINED_PAIR_CAPACITY = 1 << 20


def _render(work: bench.Workload):
    v = work.view
    return render_forward(work.settings, v.tan_fovx, v.tan_fovy, 1.0,
                          *work.params, v.view, v.proj, v.campos, work.bg)


def workloads(device, ply=None, dataset: str | None = None,
              n: int = bench.N_GAUSSIANS, width: int = bench.WIDTH,
              height: int = bench.HEIGHT):
    """[(metric, fn, extra)]: each ``fn()`` is one timed call; ``extra``
    describes it."""
    rng, view, params, target = bench.bench_scene(device, n, width, height)
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    work = bench.Workload(RenderSettings(width=width, height=height,
                                         pair_capacity=PAIR_CAPACITY),
                          view, params, target, bg)
    shape = dict(n_gaussians=n, resolution=f"{width}x{height}",
                 pair_capacity=PAIR_CAPACITY)
    cfg = GSConfig()
    model = GaussianModel(*params, alive=torch.ones(n, dtype=torch.bool,
                                                    device=device),
                          n_alive=torch.tensor(n, dtype=torch.int32,
                                               device=device))
    adam = init_adam_state(model.param_dict())
    out = [
        ("render_only_ms_per_frame", lambda: _render(work), shape),
        ("rasterize_fwd_bwd_ms_per_frame", lambda: bench.fwd_bwd(work),
         shape),
        ("train_step_ms", lambda: train_step(
            work.settings, cfg, model, adam, view.view, view.proj,
            view.campos, view.tan_fovx, view.tan_fovy, target, 0), shape),
    ]
    if ply is not None:
        tparams, tview, ttarget, camera = bench.trained_inputs(
            device, ply, dataset, rng, size=width)
        twork = bench.Workload(RenderSettings(
            width=tview.width, height=tview.height,
            pair_capacity=TRAINED_PAIR_CAPACITY), tview, tparams, ttarget, bg)
        tshape = dict(n_gaussians=tparams[0].shape[0], camera=camera,
                      pair_capacity=TRAINED_PAIR_CAPACITY)
        out += [("trained_scene_render_ms", lambda: _render(twork), tshape),
                ("trained_scene_fwd_bwd_ms", lambda: bench.fwd_bwd(twork),
                 tshape)]
    return out


def run(device=None, ply=None, dataset: str | None = None) -> list[dict]:
    """Time every workload on the card; prints and returns one record per
    metric."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the bench suite times the CUDA card")
    gpu = card()
    records = []
    for metric, fn, extra in workloads(device, ply, dataset):
        ms = bench.time_slope(fn, warmup=2, lo=3, hi=13)
        if metric.startswith("render_only") or metric.endswith("render_ms"):
            extra = {**extra, "fps": 1e3 / ms}
        rec = {"metric": metric, "value": ms, "unit": "ms",
               "extra": {**extra, "device": gpu}}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ply", default=None,
                    help="also benchmark this trained point cloud")
    ap.add_argument("--dataset", default=None,
                    help="NeRF-synthetic dataset for the trained scene's "
                         "camera and target")
    args = ap.parse_args(argv)
    return run(ply=args.ply, dataset=args.dataset)


if __name__ == "__main__":
    main()
