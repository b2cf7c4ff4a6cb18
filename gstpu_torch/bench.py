"""Headline benchmark of the port: rasterize fwd+bwd ms per frame at 800x800.

Port of ``bench.py``.  Scene: 100k random Gaussians in the reference's init
cube ([-1.3, 1.3]^3) seen by the reference smoke-test camera, drawn from
``default_rng(0)`` as the JAX bench draws them, with a uniform random
target.  One iteration is the autograd ``render`` (K1 forward, K2 and the
adjoint chain backward), the L1 loss and ``torch.autograd.grad`` over the
five parameter groups, at pair capacities fitted to the scene (tight-radius
``tiles_touched`` x 1.05, then the pair cull's kept count x 1.05, each
rounded up to 8,192).  Time per frame is the slope between 25 and 5
iterations after 3 warm-up iterations, each run ending in
``torch.cuda.synchronize()``.

    python -m gstpu_torch.bench [--skip-parity] [--sol PATH]
                                [--dataset DIR] [--ply PATH]

prints one JSON line ``{"metric": "rasterize_fwd_bwd_ms_per_frame",
"value", "unit", "vs_baseline", "extra"}``; ``vs_baseline`` is a fixed 100
ms budget over the time, as in the JAX bench.  Before the timing the kernel
gate (``ops/kernel_check.compiled_parity_check``) runs in the same process;
its result is ``extra["kernel_parity"]``, and a failed gate is also
reported on stderr and as ``kernel_parity_ok`` false.

``extra`` holds ``gaussians_per_s``, ``n_gaussians``, ``resolution``, the
card's name and power limit (``device``, in place of the JAX bench's
``backend``), the fitted capacities and pair counts, the kernel launches per
iteration, and the trained-scene companion: ``assets/lego_trained.ply``
(``--ply``) through ``render_space_params`` with capacities fitted the same
way, seen by camera 0 of ``--dataset``'s train split against its image 0,
or without a dataset by ``scenes.lego_orbit(0, 800)`` against a target
drawn from the headline's generator; ``trained_scene_camera`` says which.
An error there is recorded in ``trained_scene_error``.  ``sol_ms`` and
``vs_sol`` come only from a ``sol_model`` dict of the same card (``--sol``,
or ``main(sol=...)``).

The bench needs the CUDA card.  Its parts (``headline``,
``fit_capacities``, ``trained_inputs``, ``trained_scene``, ``fwd_bwd``)
take a device and run
on the CPU with the plain compositing at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from gstpu_torch import convert, scenes
from gstpu_torch.config import RenderSettings
from gstpu_torch.ops import kernel_check
from gstpu_torch.ops.cuda_binning import build_pairs
from gstpu_torch.ops.losses import l1_loss
from gstpu_torch.ops.preprocess import preprocess
from gstpu_torch.ops.rasterize import pair_cull_threshold, render
from gstpu_torch.render import resolve_device
from gstpu_torch.sol_model import card
from gstpu_torch.utils import tracing
from gstpu_torch.utils.ply import load_ply, render_space_params

BASELINE_BUDGET_MS = 100.0
N_GAUSSIANS = 100_000
WIDTH = HEIGHT = 800
WARMUP = 3
ITERS_LO = 5
ITERS_HI = 25
RUNS = WARMUP + ITERS_LO + ITERS_HI     # iterations of one timing
CAPACITY_STEP = 8192


class View(NamedTuple):
    view: torch.Tensor        # (4, 4) transposed world-to-camera
    proj: torch.Tensor        # (4, 4) transposed full projection
    campos: torch.Tensor      # (3,)
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int


class Workload(NamedTuple):
    """One fwd+bwd configuration: settings, camera, the five parameter
    tensors (positions, scales, rotations, opacities, shs), target image,
    background, and the pair counts the capacities were fitted to (None
    where they were not)."""
    settings: RenderSettings
    view: View
    params: tuple
    target: torch.Tensor
    bg: torch.Tensor
    live_pairs: int | None = None
    kept_pairs: int | None = None


def camera_view(cam: dict, device) -> View:
    """A ``View`` of a camera dict of ``scenes.example_camera`` (``view``,
    ``proj``, ``campos``) or of ``utils.camera.load_camera``
    (``world_to_camera``, ``full_proj_matrix``, ``camera_center``)."""
    def f32(*keys):
        key = next(k for k in keys if k in cam)
        return torch.tensor(np.asarray(cam[key], np.float32), device=device)

    return View(f32("world_to_camera", "view"), f32("full_proj_matrix", "proj"),
                f32("camera_center", "campos"), float(cam["tan_fovx"]),
                float(cam["tan_fovy"]), int(cam["width"]), int(cam["height"]))


def _round_capacity(pairs: int) -> int:
    return -(-max(pairs, 1) // CAPACITY_STEP) * CAPACITY_STEP


def fit_capacities(params, view: View):
    """(pair_capacity, kept_capacity, live pairs, kept pairs), as
    ``bench.py:113-136`` fits them: the tight-radius preprocess's
    ``tiles_touched`` sum x 1.05, rounded up to 8,192; then the pair cull's
    kept count at that capacity x 1.05, rounded up the same way."""
    probe = RenderSettings(width=view.width, height=view.height,
                           tight_radius=True)
    prep = preprocess(*params, view.view, view.proj, view.campos, view.width,
                      view.height, view.tan_fovx, view.tan_fovy,
                      probe.grid_x, probe.grid_y, 3, tight_radius=True)
    live = int(prep.tiles_touched.sum())
    pair_capacity = _round_capacity(int(live * 1.05))
    pairs = build_pairs(prep.tiles_touched, prep.rect, prep.depth,
                        probe.grid_x, probe.num_tiles, pair_capacity,
                        cull_xy=prep.xy, cull_tcut=pair_cull_threshold(prep))
    kept = int(pairs.num_kept)
    return pair_capacity, _round_capacity(int(kept * 1.05)), live, kept


def fitted_workload(params, view: View, target) -> Workload:
    """The fwd+bwd workload with tight radii, the pair cull and capacities
    from ``fit_capacities``."""
    pair_capacity, kept_capacity, live, kept = fit_capacities(params, view)
    settings = RenderSettings(width=view.width, height=view.height,
                              pair_capacity=pair_capacity,
                              kept_capacity=kept_capacity, pair_cull=True,
                              tight_radius=True)
    bg = torch.zeros(3, dtype=torch.float32, device=target.device)
    return Workload(settings, view, tuple(params), target, bg, live, kept)


def bench_scene(device, n: int = N_GAUSSIANS, width: int = WIDTH,
                height: int = HEIGHT, seed: int = 0):
    """(generator, view, five parameter tensors, target) of the headline
    scene, drawn from ``default_rng(seed)`` as ``bench.py:99-108``."""
    rng = np.random.default_rng(seed)
    cam = scenes.example_camera(width=width, height=height)
    pts, shs, scales, rotations, opacities = scenes.random_scene(
        rng, n=n, extent=1.3, z_center=-10.0,
        opacity_range=(0.05, 0.9), scale_range=(0.01, 0.05))
    params = tuple(torch.tensor(x, device=device)
                   for x in (pts, scales, rotations, opacities, shs))
    target = torch.tensor(rng.uniform(0, 1, (height, width, 3))
                          .astype(np.float32), device=device)
    return rng, camera_view(cam, device), params, target


def headline(device, n: int = N_GAUSSIANS, width: int = WIDTH,
             height: int = HEIGHT):
    """(workload, generator) of the headline; the generator has drawn the
    scene and the target."""
    rng, view, params, target = bench_scene(device, n, width, height)
    return fitted_workload(params, view, target), rng


def trained_inputs(device, ply=scenes.LEGO_PLY, dataset: str | None = None,
                   rng: np.random.Generator | None = None,
                   size: int = WIDTH):
    """(five parameter tensors, view, target, camera name) of the
    trained-scene companion: the point cloud ``ply`` in render space, seen
    by camera 0 of ``dataset``'s train split against its image 0, or
    without a dataset by ``scenes.lego_orbit(0, size)`` against a target
    drawn from ``rng``."""
    p = convert.params_from_numpy(render_space_params(load_ply(ply)), device)
    params = tuple(p[k] for k in convert.PARAM_KEYS)
    if dataset is not None:
        from gstpu_torch.data.nerf import NerfSyntheticDataset

        data = NerfSyntheticDataset(dataset, "train")
        cam, target = data.camera(0), data.image(0)
        name = f"{dataset} train camera 0"
    else:
        cam = scenes.lego_orbit(0.0, size)
        target = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
        name = f"lego_orbit theta=0 {size}x{size}"
    return (params, camera_view(cam, device),
            torch.tensor(target, device=device), name)


def trained_scene(device, ply=scenes.LEGO_PLY, dataset: str | None = None,
                  rng: np.random.Generator | None = None,
                  size: int = WIDTH):
    """(workload with fitted capacities, camera name) of the trained-scene
    companion; arguments as ``trained_inputs``."""
    params, view, target, name = trained_inputs(device, ply, dataset, rng,
                                                size)
    return fitted_workload(params, view, target), name


def fwd_bwd(work: Workload):
    """One iteration: (L1 loss, the five gradients, RenderAux)."""
    p = [x.detach().requires_grad_(True) for x in work.params]
    v = work.view
    img, _, aux = render(work.settings, v.tan_fovx, v.tan_fovy, 1.0, *p,
                         v.view, v.proj, v.campos, work.bg)
    loss = l1_loss(img, work.target)
    return loss.detach(), torch.autograd.grad(loss, p), aux


def time_slope(fn, warmup: int = WARMUP, lo: int = ITERS_LO,
               hi: int = ITERS_HI) -> float:
    """Milliseconds per call of ``fn`` on the card: ``warmup`` calls, then
    the slope between runs of ``hi`` and ``lo`` calls."""
    def run(iters):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(warmup)
    return (run(hi) - run(lo)) / (hi - lo) * 1e3


def main(argv=None, sol: dict | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-parity", action="store_true",
                    help="skip the kernel gate")
    ap.add_argument("--sol", default=None,
                    help="JSON of `python -m gstpu_torch.sol_model --out` "
                         "on this card, for vs_sol")
    ap.add_argument("--dataset", default=None,
                    help="NeRF-synthetic dataset: the trained scene uses "
                         "its train camera 0 and image 0")
    ap.add_argument("--ply", default=str(scenes.LEGO_PLY),
                    help="point cloud of the trained-scene companion")
    args = ap.parse_args(argv)
    device = resolve_device(None)
    gpu = card()

    parity_ok = None
    if not args.skip_parity:
        parity = kernel_check.compiled_parity_check(device=device)
        parity_ok = parity["ok"]
        if not parity_ok:
            print(json.dumps({"error": "kernel_parity_failed", **parity}),
                  file=sys.stderr)

    work, rng = headline(device)
    keys = ("k1.launches", "k2.launches")
    before = {k: tracing.COUNTERS[k] for k in keys}
    ms = time_slope(lambda: fwd_bwd(work))
    launches = {k: (tracing.COUNTERS[k] - before[k]) / RUNS for k in keys}
    n = work.params[0].shape[0]
    extra = {
        "gaussians_per_s": n / (ms / 1e3),
        "n_gaussians": n,
        "resolution": f"{work.view.width}x{work.view.height}",
        "device": gpu,
        "pair_capacity": work.settings.pair_capacity,
        "kept_capacity": work.settings.kept_capacity,
        "live_pairs": work.live_pairs,
        "kept_pairs": work.kept_pairs,
        "launches_per_iteration": launches,
    }
    try:
        twork, camera = trained_scene(device, args.ply, args.dataset, rng)
        extra["trained_scene_ms"] = time_slope(lambda: fwd_bwd(twork))
        extra["trained_scene_gaussians"] = twork.params[0].shape[0]
        extra["trained_scene_pairs_kept"] = twork.kept_pairs
        extra["trained_scene_ply"] = str(args.ply)
        extra["trained_scene_camera"] = camera
    except Exception as e:  # never let the companion kill the headline
        extra["trained_scene_error"] = f"{type(e).__name__}: {e}"[:200]
    if parity_ok is not None:
        extra["kernel_parity_ok"] = parity_ok
        extra["kernel_parity"] = parity
    if sol is None and args.sol:
        with open(args.sol) as f:
            sol = json.load(f)
    if sol is not None and sol.get("device") == gpu:
        extra["sol_ms"] = sol["sol_ms"]
        extra["vs_sol"] = sol["sol_ms"] / ms
    record = {"metric": "rasterize_fwd_bwd_ms_per_frame", "value": ms,
              "unit": "ms", "vs_baseline": BASELINE_BUDGET_MS / ms,
              "extra": extra}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
