#!/usr/bin/env python3
"""Where the time of one training step of the PyTorch port goes, on a CUDA
card.

    python3 scripts/torch_profile_train.py [--trace PATH]

Builds the main path of ``chip_smoke.py`` (the perturbed trained Lego,
capacity 193,579, 800x800, default raw recipe with the trainer's settings),
takes 5 steps to leave the start, and prints JSON lines:

- the median CUDA-event time of each stage of one ``train_step`` at the
  next view of the camera order: forward (preprocess, band clip, pair-cull
  threshold, binning, K1 with its checkpoints, image assembly), loss and
  its pixel gradient, backward (K2 from K1's checkpoints, epilogue, the four
  adjoints of the preprocess chain and the depth chain), Adam; and of the
  whole ``train_step``;
- from ``torch.profiler`` over 5 steps: the device time per step, the share
  of the steps' wall time in which the device was idle, and the operators
  with the most device time.

With ``--trace PATH`` the profiler's Chrome trace is written to PATH.
Imports nothing of JAX or of gstpu.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from gstpu_torch.ops import cuda_rasterize, preprocess_bwd  # noqa: E402
from gstpu_torch.ops import rasterize as R  # noqa: E402
from gstpu_torch.ops.binning import build_pairs  # noqa: E402
from gstpu_torch.ops.losses import l1_loss, l1_pixel_gradients  # noqa: E402
from gstpu_torch.ops.preprocess import preprocess  # noqa: E402
from gstpu_torch.optim import adam_step, schedule_lrs  # noqa: E402
from gstpu_torch.trainer import train_step  # noqa: E402

SIZE = 800
WARM_STEPS = 5
PROFILE_STEPS = 5


def median_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", type=Path, default=None,
                    help="write the profiler's Chrome trace to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    run = chip_smoke.TrainRun(SIZE, dev)

    def step():
        i = run.next_view()
        (run.model, run.adam, _, _, _, run.iteration) = train_step(
            run.settings, run.cfg, run.model, run.adam, *run.view_args(i),
            run.iteration)

    for _ in range(WARM_STEPS):
        step()
    s, cfg, model = run.settings, run.cfg, run.model
    view, proj, campos, tanx, tany, target = run.view_args(run.next_view())
    p = model.param_dict()
    bg = run.bg

    def run_preprocess():
        return preprocess(p["positions"], p["scales"], p["rotations"],
                          p["opacities"], p["shs"], view, proj, campos,
                          s.width, s.height, tanx, tany, s.grid_x, s.grid_y,
                          s.sh_degree, alive=model.alive,
                          tight_radius=s.tight_radius)

    prep = run_preprocess()
    band = R.clip_rect_to_band(prep.rect, prep.tiles_touched, 0, s.band_rows,
                               s.row_stride)
    tcut = R.pair_cull_threshold(prep)

    def run_binning():
        return build_pairs(band[1], band[0], prep.depth, s.grid_x,
                           s.band_tiles, s.pair_capacity, cull_xy=prep.xy,
                           cull_tcut=tcut, kept_capacity=s.kept_capacity)

    pairs = run_binning()
    color, dacc, final_t, _, ckpt = \
        cuda_rasterize.composite_forward_checkpointed(prep, pairs, s)

    def assemble():
        return (R.tiles_to_image(color + final_t[:, :, None] * bg, s),
                R.tiles_to_image(dacc, s))

    image, _ = assemble()
    dl_dpix = R.image_to_tiles(l1_pixel_gradients(image, target), s)
    zeros = torch.zeros_like(final_t)
    bwd_in = dict(color_pre_bg=color, final_t=final_t, dl_dpix=dl_dpix,
                  bg=bg, depth_acc=dacc, dl_ddepth=zeros)
    rows = cuda_rasterize.backward_rows(prep, pairs, s, **bwd_in,
                                        checkpoints=ckpt)
    d_color, d_mean2d, d_conic, _, d_invd = R.segment_sum_pair_rows(
        rows, pairs, s)
    focal_x = s.width / (2.0 * tanx)
    focal_y = s.height / (2.0 * tany)
    dcov3d = preprocess_bwd.cov2d_backward(
        p["positions"], prep.cov3d, prep.radii, focal_x, focal_y, tanx, tany,
        view, d_conic)[1]
    grads = {k: torch.zeros_like(x) for k, x in p.items()}
    lrs = schedule_lrs(cfg, run.iteration)

    def loss_and_pixel_grad():
        img = image.detach().requires_grad_(True)
        return torch.autograd.grad(l1_loss(img, target), img)

    stages = {
        "forward.preprocess": run_preprocess,
        "forward.band_clip": lambda: R.clip_rect_to_band(
            prep.rect, prep.tiles_touched, 0, s.band_rows, s.row_stride),
        "forward.pair_cull_threshold": lambda: R.pair_cull_threshold(prep),
        "forward.binning": run_binning,
        "forward.k1": lambda: cuda_rasterize.composite_forward_checkpointed(
            prep, pairs, s),
        "forward.image_assembly": assemble,
        "loss.l1_and_pixel_grad": loss_and_pixel_grad,
        "backward.image_to_tiles": lambda: (R.image_to_tiles(image, s),
                                            R.image_to_tiles(image[..., 0],
                                                             s)),
        "backward.k2": lambda: cuda_rasterize.backward_rows(
            prep, pairs, s, **bwd_in, checkpoints=ckpt),
        "backward.epilogue": lambda: R.segment_sum_pair_rows(rows, pairs, s),
        "backward.cov2d": lambda: preprocess_bwd.cov2d_backward(
            p["positions"], prep.cov3d, prep.radii, focal_x, focal_y, tanx,
            tany, view, d_conic),
        "backward.projection": lambda: preprocess_bwd.projection_backward(
            p["positions"], prep.radii, proj, d_mean2d),
        "backward.sh": lambda: preprocess_bwd.sh_backward(
            p["positions"], p["shs"], prep.radii, campos, prep.clamped,
            d_color, s.sh_degree),
        "backward.cov3d": lambda: preprocess_bwd.cov3d_backward(
            p["scales"], p["rotations"], prep.radii, 1.0, dcov3d),
        "backward.depth_chain": lambda: (
            -(1.0 / torch.where(prep.depth == 0.0, 1.0, prep.depth)) ** 2
            * d_invd * (prep.radii > 0))[:, None] * view[None, :3, 2],
        "adam": lambda: adam_step(p, grads, run.adam, lrs, run.iteration,
                                  cfg, alive=model.alive),
        "train_step": lambda: train_step(s, cfg, model, run.adam, view, proj,
                                         campos, tanx, tany, target,
                                         run.iteration),
    }
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "size": SIZE, "capacity": model.capacity,
                      "pairs": int(pairs.num_pairs),
                      "kept_pairs": int(pairs.num_kept),
                      "pair_capacity": s.pair_capacity,
                      "kept_capacity": s.kept_capacity}), flush=True)
    print(json.dumps({"stage_ms": {k: median_ms(fn)
                                   for k, fn in stages.items()}}), flush=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted((e for e in events if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:25]
    print(json.dumps({
        "steps": PROFILE_STEPS,
        "wall_ms_per_step": wall_ms / PROFILE_STEPS,
        "device_ms_per_step": device_ms / PROFILE_STEPS,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "top_device_ops_ms_per_step": {
            e.key[:80]: e.self_device_time_total / 1e3 / PROFILE_STEPS
            for e in top}}), flush=True)
    if args.trace is not None:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
