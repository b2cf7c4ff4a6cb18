#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gstpu_torch) on one CUDA card.

    python3 chip_smoke.py [--previous DIR]

Phases, in order; any failure raises and the script exits non-zero:

1. device and build: versions, the card's name and power limit, and the
   nvcc builds of every kernel (K1, csrc/rasterize_fwd.cu; K2,
   csrc/rasterize_bwd.cu; K3, csrc/sol_compositing.cu; binning,
   csrc/binning.cu; preprocess, csrc/preprocess.cu), started together,
   with ptxas's registers, shared memory and spills;
2. K1 against its plain PyTorch version on the card and against the stored
   JAX outputs, on (a) the stored gate (tests/golden/pallas_gate.npz,
   through gstpu_torch/ops/kernel_check.py),
   (b) the span edge cases, (c) one full-size 800x800 Lego view, close
   enough that every tile is occupied; on (a) and (c), K1 asked for
   checkpoints gives bit-identical outputs, writes the work items of their
   plain version, and each checkpoint k is bit-equal to K1's final T, color
   and inverse depth on the tile counts cut to k * segment; and the binning
   kernels on the gate's stored prep against the stored JAX pairs, every
   ``Pairs`` field bit for bit;
3. the render path: ``render_gaussians`` on the trained Lego point cloud
   (assets/lego_trained.ply, 129,053 Gaussians, SH degree 3) at 800x800
   from four orbit views, plus one ``render_forward`` view with
   tight_radius, pair_cull and a fitted kept_capacity; the launch counts
   are zeroed just before and read just after (one preprocess, one binning
   and one K1 launch a view), and every image is held against the plain
   version's image of the same view;
4. render times with CUDA events (medians after a warm-up), K1's bare
   time (``bare_ms``) and its wrapper's (``time_ms``), K1's bound, and a
   ``walk`` line per view (orbit and close): the tiles' pair counts, the
   walk of the CTAs, ``deepest_tile_ms`` (K1 with every other tile's count
   set to 0);
5. K2 (with its epilogue, on K1's outputs, as the kernel gate runs it)
   against the stored JAX gradients of the gate, and against its plain
   version on the card on the gate, the high-opacity
   early-exit scene (tile starts off the multiples of 128, saturated
   pixels) and the close 800x800 view; two runs of K2 give bit-identical
   rows on the gate and on the close view; K2 from K1's checkpoints (the
   main path's form) against the stored JAX gradients, against K2 from
   T = 1 and against the plain version, two runs bit-identical, on the
   gate, the early-exit scene and the close view;
6. the main path, training: 20 ``train_step``s at full width on the
   perturbed trained Lego (capacity 193,579 with the alive mask), in the
   trainer's camera order over 8 orbit views whose targets are the port's
   renders of the unperturbed Lego; the launch counts are zeroed just
   before and read just after (one preprocess, one binning, one K1 and one
   K2 launch per step), with the
   CTAs each launch started (``tracing.COUNTERS``); K2 runs from the
   checkpoints K1 returned (recorded as the render receives them) with
   more work items than tiles, no step overflows, loss and gradients are
   finite, and the L1 loss on a held-out orbit view falls;
7. one step with K1 + K2 against the same step with the plain versions on
   the card, in the raw/L1 and the activated/SSIM configurations;
8. training times with CUDA events, K2's bare time from checkpoints and
   its wrapper's, K2's bound and the ``walk`` line of the step's view;
9. K3 (the speed-of-light model's compositing kernel), forward and backward,
   against its plain version on the card at 2,500 tiles and 1, 2 and 5
   chunks: every tile row bit-identical, two runs bit-identical, one launch
   per call;
10. the second main path, measurement: the speed-of-light model
   (``gstpu_torch.sol_model.run``) on the card, with K3's launch and CTA
   counts zeroed just before and read just after; every stage, the copy
   bandwidth, ``sol_ms``, K3's bare and wrapper times beside its bound and
   its plain version's;
11. the port's bench (``gstpu_torch.bench.main``): the kernel gate with
   ``preprocess_backend_parity``, the headline (100k Gaussians, 800x800,
   fitted capacities) with exactly one preprocess, one binning, one K1 and
   one K2 launch per timed iteration (counts zeroed before, read after; the
   gate adds one preprocess, one K1 and one K2 launch, each capacity fit
   one binning), the trained-scene
   companion, ``vs_sol`` from phase 10's model; one headline iteration
   against the same with the plain compositing; then the bench suite
   (``gstpu_torch.bench_suite``) with the trained Lego, one line a metric;
12. the third main path, training a scene: a COLMAP capture of the Lego
   (16 orbit views at 800x800 rendered by the port from the trained Lego,
   its 129,053 positions as the points, under build/lego_colmap), read back
   by the port's loader within 1e-5; then ``gstpu_torch.train.main`` on it
   (the default GSConfig, 60 steps, densify events at 20 and 40, holdout 8:
   14 train and 2 val/test views) with the launch counts zeroed just before
   and read just after: one K2 launch per step run (replays included), at
   least one K1 launch per step and per eval render, one preprocess and one
   binning per K1 launch; a densify event that
   changes the topology, every overflow replayed, finite losses whose last
   10 average below the first 10, eval and test PSNR, the PLY, cameras,
   losses, metrics and states written; the median step time (CUDA events),
   each densify event's time and the eval renders'; then a resume from the
   state at 30 that starts at 31 and writes the rest of loss.txt;
13. the CLIs, through their ``main``s, with K1's, binning's and
   preprocess's launches counted over each (one binning and one preprocess
   per K1 launch): ``python -m gstpu_torch.render`` writes the 1800x1800
   example (held against the plain compositing at K1's tolerances, the PNG equal to
   the render); ``python -m gstpu_torch.eval_model`` on phase 12's PLY and
   its capture's test split (its PSNR within 0.01 dB of phase 12's test
   PSNR; its PSNR, of images clipped to [0, 1], within 0.01 dB of a render
   of that convention, and the Trainer's, of images as rendered, within
   0.01 dB of one of its own); ``python -m gstpu_torch.render_turntable`` writes 8
   frames at 800x800 of the trained Lego, frame 0 within one 8-bit level of
   the orbit view at theta 0; no K2 launch;
14. the multi-rank path as ranks that share this one card over gloo
   (``torch.distributed``; NCCL refuses two ranks on one device), on the
   phase-12 capture at 800x800: first a probe, in pairs of ranks, of the
   collectives gloo takes CUDA tensors for (it fails if one that
   ``parallel/collectives.py`` sends from the card is refused); for meshes (n_data, n_model) = (1, 2) and
   (2, 2), child processes each take one sharded step (``parallel/
   sharded.py``) from the capture's initial model (capacity 193,580) with
   one preprocess, one binning, one K1 and one K2 launch per rank (counted
   over the step),
   hold K1 on
   their band, K1's checkpoints there and the step's gradients against the
   plain compositing at that band, and render one frame from their bands;
   the loss and the gathered gradients are held against the
   single-process ``loss_and_grads`` (the mean over the cameras) at phase
   7's tolerances, the interleaved frame against the single-process render
   at K1's; then ``python -m gstpu_torch.train --n-model 2 --n-data 2`` as
   4 ranks for 30 steps with a densify event at 20: every exit code within
   the timeout, one K1 and one K2 launch per step on each rank (rank 0 also
   K1 per eval render) and one preprocess and one binning per K1 launch,
   the same model on every rank after the densify
   event, finite losses, rank 0's outputs.  Each group of children is
   killed after SHARDED_TIMEOUT_S seconds.  The step times and the bytes of
   each collective are transport through host memory on one card: they say
   nothing of scaling;
15. binning (``phase_binning``): the kernels of csrc/binning.cu at the
   benchmark's mip360-view shapes from seeded inputs, without and with the
   pair cull and a kept capacity, against the plain
   ``ops/binning.py::build_pairs`` on the card (every ``Pairs`` field bit
   for bit, twice), one ``binning.launches`` a call; the bare times of the
   duplicate kernel, CUB's sort and the finish kernel beside their byte
   bounds, ``torch.sort`` of the same keys, the wrapper and the plain
   version; ptxas's registers and spills of the two kernels;
16. preprocess (``phase_preprocess``): the kernel of csrc/preprocess.cu at
   the benchmark's mip360-view shapes (2.96M seeded Gaussians, 1237x822,
   SH degree 3), without and with an alive mask, against the plain
   ``ops/preprocess.py::preprocess`` on the card (every field bit for bit,
   twice), one ``preprocess.launches`` a call; its bare and wrapper times
   beside its byte bound (every input row read once, every output written
   once) and the bound of the bytes the visible Gaussians need, the plain
   version's time; ptxas's registers and spills.

Times.  ``ms`` on the kernels line is the bare kernel (``bare_ms``: the
launch that the wrapper makes, repeated 20 times back to back between two
CUDA events, median of 5); ``wrapper_ms`` is one wrapper call per
CUDA-event pair, median of 20 (how ``ms`` was timed up to the parent
commit), with the wrapper's PyTorch ops (record table, work list,
checkpoint buffer).

With ``--previous DIR`` (the parent commit's ``PARENT_FILES``: the
``gstpu_torch/csrc/`` sources rasterize_fwd.cu, rasterize_bwd.cu,
composite_common.cuh and sol_compositing.cu and the wrapper modules
``gstpu_torch/ops/cuda_rasterize.py`` and ``gstpu_torch/sol_model.py``,
for example from ``git show HEAD:<path>`` into a directory that .gitignore
lists; see ``PreviousKernels``) phase 1 builds the parent's kernels too,
phases 2 and 4 check that K1's outputs are bit-identical to the parent's on
the gate, the close view and the orbit view, phase 9 reports how far K3's
outputs moved from the parent's, and phases 4, 8 and 10 time the parent's
kernels and wrappers in turns with this tree's (``previous_ms``,
``previous_wrapper_ms``; null without the option), each on the parent's own
main path (K2 from the parent K1's checkpoints), and the step's gradients
(``trainer.loss_and_grads``) with either tree's compositing.

The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}.  It imports nothing of JAX or of gstpu.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import datetime
import importlib.util
import inspect
import json
import math
import shutil
import statistics
import struct
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from gstpu_torch import bench, bench_suite, convert, eval_model
from gstpu_torch import render as render_cli
from gstpu_torch import render_turntable, scenes, sol_model
from gstpu_torch import train as train_cli
from gstpu_torch import trainer as trainer_mod
from gstpu_torch.config import TILE_X, TILE_Y, GSConfig, RenderSettings
from gstpu_torch.data.colmap import ColmapDataset
from gstpu_torch.models.gaussians import (SH_C0, GaussianModel,
                                          activate_params, grow_capacity,
                                          init_model_from_points)
from gstpu_torch.ops import (binning, cuda_binning, cuda_build,
                             cuda_preprocess, cuda_rasterize, kernel_check,
                             rasterize)
from gstpu_torch.ops.cuda_binning import build_pairs
from gstpu_torch.ops.losses import l1_loss, l1_pixel_gradients
from gstpu_torch.ops.preprocess import preprocess
from gstpu_torch.optim import adam_step, init_adam_state, schedule_lrs
from gstpu_torch.render import default_pair_capacity, render_gaussians
from gstpu_torch.trainer import (loss_and_grads, round_capacity,
                                 train_settings, train_step)
from gstpu_torch.utils import tracing
from gstpu_torch.utils.camera import load_camera, look_at_c2w
from gstpu_torch.utils.image import imwrite

SIZE = 800
THETAS = (0.0, 0.5 * math.pi, math.pi, 1.5 * math.pi)
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
FLOPS_PER_STEP = 20       # per evaluated (pixel, pair) step (K1 and K2)
BWD_FLOPS_PER_KEPT = 56   # K2's gradient terms (46) and sums (10) per kept step
RECORD_BYTES = 40         # one packed Gaussian record (10 f32)
OUT_BYTES_PER_PIXEL = 24  # color 12, inverse depth 4, final T 4, n_contrib 4
PIX_IN_BYTES = 28         # K2's per-pixel inputs (7 f32)
ROW_BYTES = 40            # K2's per-pair output row (10 f32)
# thresholds of the kernel gate (gstpu/ops/pallas_check.py:160-188)
MAX_FLIP_FRAC = kernel_check.MAX_FLIP_FRAC
MAX_COLOR_ERR = kernel_check.MAX_COLOR_ERR
MAX_DEPTH_ERR = kernel_check.MAX_DEPTH_ERR
# Gradients: error relative to each output's largest magnitude (the
# compiled gate's 1e-3, gstpu/ops/pallas_check.py:174-182).  Flip-tolerant
# where keep-threshold pairs may flip between the kernel's sequential
# transmittance and the plain version's cumulative product: at most
# GRAD_OUTLIER_FRAC of the elements may exceed GRAD_REL_TOL, none
# GRAD_OUTLIER_CAP.
GRAD_REL_TOL = kernel_check.MAX_GRAD_REL
GRAD_OUTLIER_FRAC = 1e-3
GRAD_OUTLIER_CAP = 2e-2
LOSS_REL_TOL = 1e-5
GRAD_NAMES = kernel_check.GRAD_NAMES
# the plain versions in place of the kernel wrappers, for rasterize.render
PLAIN_COMPOSITING = (rasterize.composite_forward, rasterize.composite_backward)
# Training main path: 8 orbit views (theta = 2 pi k / 8), a held-out view
# between two of them, 20 steps of the default raw recipe.  Its first Adam
# steps move every visible Gaussian by about the learning rate (1e-2 in
# position, 5e-3 in scale, against a median Lego scale of 0.008), which
# takes the converged Lego to a held-out L1 of about 0.04; so the check
# starts from a model perturbed well beyond that, drawn from
# np.random.default_rng(PERTURB_SEED): positions + N(0, 0.05^2) per axis,
# SH DC + N(0, 0.5^2) per channel, opacities x U(0.5, 1).
TRAIN_VIEWS = 8
HELD_OUT_THETA = math.pi / 8
TRAIN_STEPS = 20
PERTURB_SEED = 0
PERTURB_POS = 0.05
PERTURB_SH_DC = 0.5
PERTURB_OPACITY = (0.5, 1.0)
# K3 on the card against its plain version: forward absolute, backward over
# each output row's largest magnitude
K3_CHUNKS = (1, 2, 5)
K3_FWD_TOL = 1e-5
K3_BWD_REL_TOL = 1e-5
# K2's rows from K1's checkpoints against K2's rows from T = 1, over each
# field's largest magnitude.  The checkpoint's prefix C . dL/dpix + D *
# dL/ddepth is one expression, where the walk from T = 1 carries the
# rounding of its running sum of w * cdot over up to a few thousand pairs
# (some ulps of ctot_dot), which 1 / (1 - alpha) <= 100 amplifies; more
# segments meet more of it.  Measured on the H100: 1.5e-6 on the gate and
# 9.2e-6 on the close 800x800 view (3,288-pair tiles, segments of 256);
# 2.7e-6 at most in the CPU tests' scenes
# (tests/test_torch_backward.py::SEGMENT_TOL).
K2_SEGMENT_ROW_TOL = 5e-5
# Phase 12, the trainer: a COLMAP capture of TRAINER_VIEWS orbit views of
# the trained Lego (the port's renders) under CAPTURE_DIR, which .gitignore
# lists; the default GSConfig (raw/L1, init from the capture's points)
# for TRAINER_STEPS steps with densify events at 20 and 40, checkpoints at
# 0, 30 and 59, two views per mid-training eval; then a resume from the
# state at TRAINER_RESUME.  The cameras read back within CAPTURE_TOL.  The
# step of TRAINER_CHECK_STEP, the first after the densify event at 20 (a
# compacted model at the refitted capacities), and the first eval render
# after it are held against the plain compositing.
TRAINER_VIEWS = 16
TRAINER_STEPS = 60
TRAINER_RESUME = 30
TRAINER_CHECK_STEP = 21
TRAINER_FLAGS = ("--densify-from-iter", "10", "--densification-interval",
                 "20", "--save-interval", "30", "--eval-views", "2")
CAPTURE_DIR = Path(__file__).resolve().parent / "build" / "lego_colmap"
CAPTURE_TOL = 1e-5
# Phase 13, the CLIs: eval_model's PSNR of phase 12's PLY against phase 12's
# test PSNR and against a render of its convention (clipped to [0, 1]), and
# the Trainer's test PSNR against one of its (as rendered), within
# EVAL_PSNR_TOL dB; a turntable of TURNTABLE_FRAMES frames.
EVAL_PSNR_TOL = 0.01
TURNTABLE_FRAMES = 8
# Phase 14, the multi-rank path as ranks that share the one card over gloo:
# a step check on each (n_data, n_model) mesh from the phase-12 capture's
# initial model and its first SHARDED_VIEWS train views; then
# ``python -m gstpu_torch.train`` as 2 x 2 ranks for SHARDED_TRAIN_STEPS
# steps with a densify event at SHARDED_DENSIFY_AT.  Every group of child
# processes is killed after SHARDED_TIMEOUT_S seconds.
SHARDED_MESHES = ((1, 2), (2, 2))
SHARDED_VIEWS = 2
SHARDED_TRAIN_STEPS = 30
SHARDED_DENSIFY_AT = 20
SHARDED_TRAIN_FLAGS = ("--densify-from-iter", "10",
                       "--densification-interval", "20", "--eval-views", "2")
SHARDED_TIMEOUT_S = 600
# The parent commit's files that --previous reads, by their paths in the
# repo; PreviousKernels takes them from one directory.
PARENT_FILES = ("gstpu_torch/csrc/rasterize_fwd.cu",
                "gstpu_torch/csrc/rasterize_bwd.cu",
                "gstpu_torch/csrc/composite_common.cuh",
                "gstpu_torch/ops/cuda_rasterize.py",
                "gstpu_torch/csrc/sol_compositing.cu",
                "gstpu_torch/sol_model.py")
# The parent's kernels that --previous builds, and the wrapper module that
# launches each: {wrapper file: library names}
PARENT_WRAPPERS = {"cuda_rasterize.py": ("rasterize_fwd", "rasterize_bwd"),
                   "sol_model.py": ("sol_compositing",)}
# The main path's launch counters in the port's registry: {kernel: key
# prefix}; K1 and K2 count their CTAs too, binning and preprocess only their
# launches
KERNEL_COUNTERS = {"rasterize_fwd": "k1", "rasterize_bwd": "k2",
                   "binning": "binning", "preprocess": "preprocess"}


def log(**kw) -> None:
    print(json.dumps(kw), flush=True)


def to_np(outs):
    return tuple(x.detach().cpu().numpy() for x in outs)


def compare(name: str, got, want) -> dict:
    """Hold compositing outputs (color, depth, final_t, n_contrib) against a
    reference with the gate's flip-tolerant thresholds; raise on failure.

    The errors are ``kernel_check.forward_errors``: a boundary pixel
    (exempt from the value checks) is a contributor-count flip or a pixel
    whose final transmittance is below 6e-4, since summation order
    legitimately flips pairs sitting on the 1/255 or 1e-4 thresholds.
    Outputs are tuples in that order or dicts by name.
    """
    res = {"check": name, **kernel_check.forward_errors(got, want)}
    res["ok"] = bool(res["flip_frac"] < MAX_FLIP_FRAC
                     and res["color_err"] < MAX_COLOR_ERR
                     and res["depth_err"] < MAX_DEPTH_ERR
                     and res["final_t_err"] < MAX_COLOR_ERR)
    log(**res)
    if not res["ok"]:
        raise RuntimeError(f"{name}: outside the gate's thresholds: {res}")
    return res


def kernel_vs_plain(name: str, prep, pairs, settings, row0: int = 0) -> dict:
    got = to_np(cuda_rasterize.composite_forward(prep, pairs, settings,
                                                 row0))
    want = to_np(rasterize.composite_forward(prep, pairs, settings, row0))
    return compare(f"{name}: kernel vs plain on the card", got, want)


def camera_tensors(cam, device):
    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    return (f32(cam["world_to_camera"]), f32(cam["full_proj_matrix"]),
            f32(cam["camera_center"]))


def prep_and_pairs(params, cam, settings, row0: int = 0):
    """Preprocess + binning of the port (with the pair cull when the
    settings ask for it) for the band of ``settings`` from tile row
    ``row0`` (the whole grid by default), as ``render_forward`` runs
    them."""
    view, proj, campos = camera_tensors(cam, params["positions"].device)
    prep = preprocess(params["positions"], params["scales"],
                      params["rotations"], params["opacities"], params["shs"],
                      view, proj, campos, settings.width, settings.height,
                      cam["tan_fovx"], cam["tan_fovy"], settings.grid_x,
                      settings.grid_y, settings.sh_degree,
                      tight_radius=settings.tight_radius)
    cull_xy = cull_tcut = None
    if settings.pair_cull:
        cull_xy, cull_tcut = prep.xy, rasterize.pair_cull_threshold(prep)
    rect, tiles = rasterize.clip_rect_to_band(
        prep.rect, prep.tiles_touched, row0, settings.band_rows,
        settings.row_stride)
    pairs = build_pairs(tiles, rect, prep.depth, settings.grid_x,
                        settings.band_tiles, settings.pair_capacity,
                        cull_xy=cull_xy, cull_tcut=cull_tcut, row0=row0,
                        row_stride=settings.row_stride,
                        kept_capacity=settings.kept_capacity)
    return prep, pairs


def plain_outputs(params, cam, settings, bg):
    """Tile-layout (image, depth, final_t, n_contrib) of the render that
    ``render_forward`` makes, with the plain compositing version."""
    prep, pairs = prep_and_pairs(params, cam, settings)
    color, dacc, final_t, n_contrib = rasterize.composite_forward(
        prep, pairs, settings)
    return color + final_t[:, :, None] * bg, dacc, final_t, n_contrib


def fitted_cull_settings(params, cam) -> RenderSettings:
    """tight_radius + pair_cull with capacities fitted as the bench fits
    them (``gstpu_torch.bench.fit_capacities``)."""
    view = bench.camera_view(cam, params["positions"].device)
    pair_capacity, kept_capacity, _, _ = bench.fit_capacities(
        [params[k] for k in convert.PARAM_KEYS], view)
    return RenderSettings(width=view.width, height=view.height,
                          tight_radius=True, pair_cull=True,
                          pair_capacity=pair_capacity,
                          kept_capacity=kept_capacity)


class Walk(NamedTuple):
    """The sequential walk that K1 and K2 make on some inputs."""
    steps: torch.Tensor   # (T, 256) pairs each pixel evaluates
    kept: int             # (pixel, pair) steps composited
    warp_kept: int        # (warp of 32 pixels, pair) with at least one kept lane

    @property
    def evaluated(self) -> int:
        return int(self.steps.sum(dtype=torch.int64))


def walk(prep, pairs, settings) -> Walk:
    """Count the walk: a pixel evaluates its tile's pairs up to and
    including the first passing pair that would take its transmittance
    below 1e-4 (the break), or the whole tile if it never breaks; kept are
    the pairs it composites."""
    dev = prep.xy.device
    pixf_x, pixf_y = rasterize._tile_pixel_coords(settings, 0, dev)
    t = settings.band_tiles
    big = torch.iinfo(torch.int32).max
    trans = torch.ones((t, 256), dtype=torch.float32, device=dev)
    done = torch.zeros((t, 256), dtype=torch.bool, device=dev)
    brk = torch.full((t, 256), big, dtype=torch.int32, device=dev)
    kept_steps = warp_kept = 0
    chunk = 64
    n_chunks = int(((pairs.tile_count + chunk - 1) // chunk).max())
    for i in range(n_chunks):
        if bool(done.all()):
            break
        gid, pvalid, pos = rasterize._chunk_pair_data(pairs, i, chunk)
        alpha_eff, indiv = rasterize._chunk_alpha(prep, gid, pvalid, pixf_x,
                                                  pixf_y)[:2]
        p_incl = trans[:, :, None] * torch.cumprod(1.0 - alpha_eff, dim=-1)
        live = ~done[:, :, None]
        kept = indiv & (p_incl >= rasterize.T_EPS) & live
        cross = indiv & (p_incl < rasterize.T_EPS) & live
        brk = torch.minimum(brk, torch.where(cross, pos[None, None, :],
                                             big).amin(-1))
        kept_steps += int(kept.sum())
        warp_kept += int(kept.view(t, 8, 32, -1).any(2).sum())
        p_last = torch.where(kept, p_incl, torch.inf).amin(-1)
        trans = torch.where(torch.isfinite(p_last), p_last, trans)
        done = done | cross.any(-1)
    steps = torch.where(brk < big, brk + 1, pairs.tile_count[:, None])
    return Walk(steps.long(), kept_steps, warp_kept)


def walk_iterations(cta_walk, count, batch: int, segment: int | None):
    """Pair iterations of CTAs that walk their tile's segments of
    ``segment`` pairs (None: the whole tile) in batches of ``batch`` and
    leave after the batch in which every pixel is done (a segment that
    starts with every pixel done is left at once)."""
    seg = segment or max(int(count.max()), 1)
    total = 0
    for k in range(-(-max(int(count.max()), 1) // seg)):
        length = torch.clamp(count - k * seg, 0, seg)
        inside = torch.clamp(cta_walk - k * seg, min=0)
        inside = torch.minimum(inside, length)
        total += int(torch.minimum(length, -(-inside // batch) * batch).sum())
    return total


def walk_line(kernel: str, view: str, w: Walk, pairs, **extra) -> dict:
    """The walk's statistics over the occupied tiles: ``tile_count`` max,
    p99 and mean; the CTA walk (pairs walked until every pixel is done) max
    and mean; K2's warp iterations as the parent kernel ran them (whole
    tiles, batches of 128, 8 warps) and the warp-pairs with a kept lane."""
    count = pairs.tile_count.long()
    occ = count > 0
    c = count[occ].double()
    cta = w.steps.amax(1)
    res = {"walk": kernel, "view": view, "occupied_tiles": int(occ.sum()),
           "tile_count_max": int(c.max()),
           "tile_count_p99": float(torch.quantile(c, 0.99)),
           "tile_count_mean": float(c.mean()),
           "cta_walk_max": int(cta[occ].max()),
           "cta_walk_mean": float(cta[occ].double().mean()),
           "evaluated_steps": w.evaluated, "kept_steps": w.kept,
           "parent_k2_warp_iterations": 8 * walk_iterations(
               cta, count, 128, None),
           "k2_warp_pairs_with_a_kept_lane": w.warp_kept, **extra}
    log(**res)
    return res


def only_deepest(pairs):
    """``pairs`` with every tile's count but the deepest's set to 0."""
    count = pairs.tile_count
    keep = torch.zeros_like(count)
    i = int(torch.argmax(count))
    keep[i] = count[i]
    return pairs._replace(tile_count=keep)


def k1_walk_stats(w: Walk, pairs) -> dict:
    """This tree's K1 on the walk: the walk of its CTAs, one per 64-pixel
    strip of an occupied tile."""
    strip = w.steps.view(-1, 4, 64).amax(-1)[pairs.tile_count > 0]
    return {"k1_strip_walk_max": int(strip.max()),
            "k1_strip_walk_mean": float(strip.double().mean())}


def k2_walk_stats(w: Walk, pairs, segment: int) -> dict:
    """This tree's K2 on the walk: its work items of ``segment`` pairs and
    their warp iterations in batches of 64 (and as whole tiles)."""
    count = pairs.tile_count.long()
    cta = w.steps.amax(1)
    work = cuda_rasterize.build_work_list(pairs.tile_count,
                                          pairs.gauss_id.shape[0], segment)
    return {"k2_segment": segment,
            "k2_work_items": int(work.ends[-1]),
            "k2_warp_iterations": 8 * walk_iterations(cta, count, 64, segment),
            "k2_warp_iterations_whole_tiles": 8 * walk_iterations(
                cta, count, 64, None)}


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def bits_equal(a, b) -> bool:
    return all(bool(torch.equal(_bits(x), _bits(y))) for x, y in zip(a, b))


def bare_ms(lib: ctypes.CDLL, fname: str, call, calls: int = 20,
            reps: int = 5) -> float:
    """The time per launch of the kernel that ``call()``, a wrapper call,
    launches through ``lib.<fname>``, without the wrapper's other work.

    For the call, the launch function is replaced by one that (inside the
    wrapper, whose tensors are then alive) launches the kernel once, then
    ``calls`` times back to back between two CUDA events, ``reps`` times,
    and once more for the wrapper's result; returns the median over
    ``calls``.  Each kernel here writes the same outputs at every launch,
    so this times any C interface the same way, the parent's too.  The
    extra launches go to no launch count."""
    fn = getattr(lib, fname)
    if fn.argtypes is None:
        raise RuntimeError(f"{fname} has no argument types yet: call its "
                           "wrapper once before timing it")
    times = []

    def timed(*args):
        err = fn(*args)
        if err:
            return err
        torch.cuda.synchronize()
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn(*args)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / calls)
        return fn(*args)

    setattr(lib, fname, timed)
    try:
        call()
    finally:
        setattr(lib, fname, fn)
    if len(times) != reps:
        raise RuntimeError(f"the call did not launch {fname} once")
    return statistics.median(times)


def in_turns(previous, current) -> tuple[float, float, list]:
    """Two measurements in turns (previous, current, current, previous);
    returns the means of each and the four values."""
    turns = [previous(), current(), current(), previous()]
    return 0.5 * (turns[0] + turns[3]), 0.5 * (turns[1] + turns[2]), turns


def load_wrapper(path: Path, libs: dict):
    """The wrapper module at ``path`` (a ``cuda_rasterize.py`` or a
    ``sol_model.py``), loaded under its own name with a ``cuda_build``
    whose ``library(name)`` returns ``libs[name]``; its ``_library`` has set
    each library's argument types, the module's own.  ``_library`` takes
    the library's name, or nothing where the module wraps one library.  A
    module that counts into the port's ``tracing.COUNTERS`` gets counters
    of its own, so its launches do not count as this tree's."""
    spec = importlib.util.spec_from_file_location(
        f"previous_{Path(path).stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.cuda_build = SimpleNamespace(**{**vars(cuda_build),
                                           "library": libs.__getitem__})
    if hasattr(module, "tracing"):
        module.tracing = SimpleNamespace(**{**vars(tracing),
                                            "COUNTERS": tracing.Counters()})
    if inspect.signature(module._library).parameters:
        for name in libs:
            module._library(name)
    else:
        module._library()
    return module


class PreviousKernels:
    """The parent commit's K1, K2 and K3 behind the parent's own wrappers.

    ``src`` holds the parent's files ``PARENT_FILES`` side by side under
    their base names, for example from
    ``git show HEAD:gstpu_torch/csrc/rasterize_fwd.cu > DIR/rasterize_fwd.cu``
    and so on, in a directory that .gitignore lists.  The three kernels are
    built with this tree's flags, one ``nvcc`` each, started together; the
    parent's wrapper modules are loaded under their own names with a
    ``cuda_build`` whose ``library`` returns these builds
    (``load_wrapper``).  So the parent's wrappers set and pass the
    arguments of the parent's C interfaces themselves, and nothing here
    depends on those interfaces.  ``module`` is the loaded
    ``cuda_rasterize`` (``composite_forward``, ``backward_rows``,
    ``composite_backward``), ``sol`` the loaded ``sol_model``
    (``sol_compositing``); their launches go to counters of their own, not
    to this tree's.  ``libs`` maps each kernel's name to its library,
    ``paths`` to the library's file."""

    def __init__(self, src: Path):
        files = [src / Path(f).name for f in PARENT_FILES]
        missing = [str(f) for f in files if not f.is_file()]
        if missing:
            raise FileNotFoundError(f"--previous: no {missing}")
        out = cuda_build.BUILD_DIR / "previous"
        out.mkdir(parents=True, exist_ok=True)
        procs = {}
        for names in PARENT_WRAPPERS.values():
            for name in names:
                cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                       str(src), "-o", str(out / f"{name}.so"),
                       str(src / f"{name}.cu")]
                procs[name] = subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
        self.libs, self.paths = {}, {}
        for name, proc in procs.items():
            build_log, _ = proc.communicate()
            log(previous_kernel=name, source=str(src / f"{name}.cu"),
                returncode=proc.returncode)
            print(build_log.strip(), flush=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building the parent's {name} failed")
            self.paths[name] = out / f"{name}.so"
            self.libs[name] = ctypes.CDLL(str(self.paths[name]))
        self.module, self.sol = (
            load_wrapper(src / wrapper, {n: self.libs[n] for n in names})
            for wrapper, names in PARENT_WRAPPERS.items())


def k1_checkpoint_checks(name: str, prep, pairs, settings,
                         row0: int = 0) -> dict:
    """K1 asked for checkpoints gives outputs bit-identical to K1 without;
    checkpoint k of every tile with a k-th segment is bit-equal to the final
    T, color and inverse depth of K1 run on the tile counts cut to k *
    ``cuda_rasterize.SEGMENT``.  ``row0``: the band's first tile row.
    Raises otherwise."""
    segment = cuda_rasterize.SEGMENT
    plain = cuda_rasterize.composite_forward(prep, pairs, settings, row0)
    *outs, ckpt = cuda_rasterize.composite_forward_checkpointed(
        prep, pairs, settings, row0)
    identical = bits_equal(outs, plain)
    n = int(ckpt.work.ends[-1])
    items = ckpt.work.items[:n]
    items_ok = bool(torch.equal(items, cuda_rasterize.work_items(
        ckpt.work, pairs.tile_count)[:n]))
    compared, mismatched = 0, 0
    for k in range(1, int(items[:, 1].max()) + 1):
        cut = torch.clamp(pairs.tile_count, max=k * segment)
        color, dacc, final_t, _ = cuda_rasterize.composite_forward(
            prep, pairs._replace(tile_count=cut), settings, row0)
        at_k = items[:, 1] == k
        tiles = items[at_k, 0].long()
        want = torch.cat([final_t[tiles, None], color[tiles].transpose(1, 2),
                          dacc[tiles, None]], dim=1)
        state = ckpt.state[:n][at_k, :5]
        mismatched += int((_bits(state) != _bits(want)).sum())
        compared += int(tiles.numel())
    res = {"check": f"{name}: K1 checkpoints", "segment": segment,
           "outputs_bit_identical_without_checkpoints": identical,
           "work_items": n, "items_equal_plain_version": items_ok,
           "checkpoints_compared": compared,
           "mismatched_values": mismatched}
    res["ok"] = bool(identical and items_ok and compared > 0
                     and mismatched == 0)
    log(**res)
    if not res["ok"]:
        raise RuntimeError(f"{name}: K1 checkpoint check failed: {res}")
    return res


def k2_segmented_checks(name: str, prep, pairs, settings, inputs) -> dict:
    """K2 from K1's checkpoints against K2 from T = 1 (one item per tile):
    rows within K2_SEGMENT_ROW_TOL of each field's largest magnitude; and,
    with its epilogue, against the plain version (flip-tolerant); two runs
    from the checkpoints bit-identical.  Raises otherwise."""
    *_, ckpt = cuda_rasterize.composite_forward_checkpointed(
        prep, pairs, settings, row0=inputs.get("row0", 0))
    seg = [cuda_rasterize.backward_rows(prep, pairs, settings, **inputs,
                                        checkpoints=ckpt) for _ in range(2)]
    whole = cuda_rasterize.backward_rows(prep, pairs, settings, **inputs)
    scale = whole.abs().amax(dim=0).clamp(min=1e-30)
    row_err = float(((seg[0] - whole).abs().amax(dim=0) / scale).max())
    items = int(ckpt.work.ends[-1])
    res = {"check": f"{name}: K2 from checkpoints", "work_items": items,
           "occupied_tiles": int((pairs.tile_count > 0).sum()),
           "row_err_vs_whole_tiles": row_err,
           "runs_bit_identical": bool(torch.equal(_bits(seg[0]),
                                                  _bits(seg[1])))}
    res["ok"] = res["runs_bit_identical"] and row_err < K2_SEGMENT_ROW_TOL
    log(**res)
    if not res["ok"]:
        raise RuntimeError(f"{name}: segmented K2 check failed: {res}")
    got = rasterize.segment_sum_pair_rows(seg[0], pairs, settings)
    want = rasterize.composite_backward(prep, pairs, settings, **inputs)
    return check_grads(f"{name}: K2 from checkpoints vs plain on the card",
                       got, want, flip_tolerant=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``."""
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


def render_view(params, cam, size: int, bg, device):
    return render_gaussians(
        bg, params["positions"], opacity=params["opacities"],
        scales=params["scales"], rotations=params["rotations"],
        viewmatrix=cam["world_to_camera"], projmatrix=cam["full_proj_matrix"],
        tan_fovx=cam["tan_fovx"], tan_fovy=cam["tan_fovy"],
        image_height=size, image_width=size, sh=params["shs"], degree=3,
        campos=cam["camera_center"], device=device)


def render_cull_view(params, cam, settings, bg):
    view, proj, campos = camera_tensors(cam, bg.device)
    return rasterize.render_forward(
        settings, cam["tan_fovx"], cam["tan_fovy"], 1.0, params["positions"],
        params["scales"], params["rotations"], params["opacities"],
        params["shs"], view, proj, campos, bg)


def phase_build() -> None:
    log(phase=1, torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
        image_modules={m: importlib.util.find_spec(m) is not None
                       for m in ("imageio", "PIL", "matplotlib")})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for name, (path, build_log, seconds) in cuda_build.build().items():
        log(kernel=name, library=str(path), build_s=seconds)
        if build_log.strip():
            print(build_log.strip(), flush=True)


def k1_vs_previous(name: str, previous, prep, pairs, settings) -> bool:
    """K1's four outputs bit-identical to the parent's K1; raises if not."""
    parent = previous.module.composite_forward(prep, pairs, settings)
    same = bits_equal(cuda_rasterize.composite_forward(prep, pairs, settings),
                      parent)
    log(check=f"{name}: K1 bit-identical to the parent's K1",
        bit_identical=same)
    if not same:
        raise RuntimeError(f"{name}: K1 differs from the parent's K1")
    return same


def phase_kernel_checks(params, size: int, device, previous=None) -> float:
    """The binning kernels against the stored JAX pairs on the gate; K1
    against the plain version (and the stored JAX outputs on the gate), K1
    with checkpoints against K1 without and against K1 on cut counts, and
    against the parent's K1 when given; returns the max color
    error off boundary at the Lego view."""
    log(phase=2)
    gate = kernel_check.load_gate(device)
    gs = gate.settings
    differ = pairs_equal(build_pairs(gate.prep.tiles_touched, gate.prep.rect,
                                     gate.prep.depth, gs.grid_x, gs.num_tiles,
                                     gs.pair_capacity), gate.pairs)
    log(check="gate: binning kernels vs stored JAX pairs", differ=differ)
    if differ:
        raise RuntimeError(f"gate: binning differs from JAX's in {differ}")
    compare("gate: kernel vs stored JAX outputs",
            kernel_check.gate_forward(gate), gate.stored)
    kernel_vs_plain("gate", gate.prep, gate.pairs, gate.settings)
    k1_checkpoint_checks("gate", gate.prep, gate.pairs, gate.settings)
    if previous is not None:
        k1_vs_previous("gate", previous, gate.prep, gate.pairs, gate.settings)

    settings, prep_np, pairs_np = scenes.span_edge_case()
    kernel_vs_plain("span edge cases",
                    convert.prep_from_numpy(prep_np, device, prefix=""),
                    convert.pairs_from_numpy(pairs_np, device, prefix=""),
                    settings)

    n = params["positions"].shape[0]
    full = RenderSettings(width=size, height=size,
                          pair_capacity=default_pair_capacity(n))
    prep, pairs = prep_and_pairs(params, scenes.lego_close_view(size), full)
    occupied = int((pairs.tile_count > 0).sum())
    log(check="lego full view", tiles=full.num_tiles, occupied_tiles=occupied,
        pairs=int(pairs.num_pairs))
    if occupied != full.num_tiles:
        raise RuntimeError("the full-size Lego view leaves tiles empty")
    k1_checkpoint_checks(f"lego close {size}x{size}", prep, pairs, full)
    if previous is not None:
        k1_vs_previous(f"lego close {size}x{size}", previous, prep, pairs,
                       full)
    return kernel_vs_plain(f"lego {size}x{size}", prep, pairs,
                           full)["color_err"]


def phase_main_path(params, size: int, device, bg) -> int:
    """Drive the main path; returns the kernel launches it made."""
    log(phase=3)
    n = params["positions"].shape[0]
    cams = [scenes.lego_orbit(t, size) for t in THETAS]
    default = RenderSettings(width=size, height=size,
                             pair_capacity=default_pair_capacity(n))
    cull = fitted_cull_settings(params, cams[0])
    views = [(f"orbit theta={t:.4f}", cam, default,
              lambda cam=cam: render_view(params, cam, size, bg, device))
             for t, cam in zip(THETAS, cams)]
    views.append(("orbit theta=0.0000 tight_radius+pair_cull", cams[0], cull,
                  lambda: render_cull_view(params, cams[0], cull, bg)))

    zero_launches()
    renders = []
    for name, cam, settings, fn in views:
        before = launch_counts()["rasterize_fwd"]
        out = fn()
        renders.append((name, cam, settings, out,
                        launch_counts()["rasterize_fwd"] - before))
    torch.cuda.synchronize()
    counts = launch_counts()
    log(path="render", launches=counts)

    for name, cam, settings, (image, depth, aux), n_launch in renders:
        _, pairs = prep_and_pairs(params, cam, settings)
        img = image.cpu().numpy()
        final_t = aux.final_t.cpu().numpy()
        log(view=name, launches=n_launch, pairs=int(aux.num_pairs),
            kept_pairs=int(aux.num_kept),
            nonempty_tiles=int((pairs.tile_count > 0).sum()),
            image_mean=float(img.mean()), image_max=float(img.max()),
            pixels_t_below_1=int((final_t < 1.0).sum()))
        if n_launch != 1:
            raise RuntimeError(f"{name}: {n_launch} kernel launches, not 1")
        if not (np.isfinite(img).all()
                and np.isfinite(depth.cpu().numpy()).all()):
            raise RuntimeError(f"{name}: non-finite image or depth")
        if img.shape != (size, size, 3) or img.max() <= 0.05 \
                or (final_t < 1.0).mean() < 0.05:
            raise RuntimeError(f"{name}: the image is blank")
        got = to_np((rasterize.image_to_tiles(image, settings),
                     rasterize.image_to_tiles(depth, settings),
                     aux.final_t, aux.n_contrib))
        compare(f"{name}: kernel render vs plain render", got,
                to_np(plain_outputs(params, cam, settings, bg)))
    if counts != {"rasterize_fwd": len(renders), "rasterize_bwd": 0,
                  "binning": len(renders), "preprocess": len(renders)}:
        raise RuntimeError(f"{counts} launches for {len(renders)} renders")
    return counts["rasterize_fwd"]


def k1_times(name: str, prep, pairs, settings, previous) -> dict:
    """K1 at these inputs: the bare kernel (``bare_ms``) and the wrapper
    (``time_ms``), each in turns with the parent's (whose outputs must be
    bit-identical) when given; the walk line with ``deepest_tile_ms``.
    Returns the walk line."""
    lib = cuda_rasterize._library("rasterize_fwd")

    def bare(pairs=pairs):
        return bare_ms(lib, "gstpu_rasterize_fwd",
                       lambda: cuda_rasterize.composite_forward(
                           prep, pairs, settings))

    def wrapper():
        return time_ms(lambda: cuda_rasterize.composite_forward(
            prep, pairs, settings), 20)

    deep = only_deepest(pairs)
    if previous is not None:
        k1_vs_previous(name, previous, prep, pairs, settings)
        plib = previous.libs["rasterize_fwd"]
        p_forward = previous.module.composite_forward

        def p_bare(pairs=pairs):
            return bare_ms(plib, "gstpu_rasterize_fwd",
                           lambda: p_forward(prep, pairs, settings))

        previous_ms, ms, turns = in_turns(p_bare, bare)
        previous_wrapper_ms, wrapper_ms, wrapper_turns = in_turns(
            lambda: time_ms(lambda: p_forward(prep, pairs, settings), 20),
            wrapper)
        extra = {"previous_ms": previous_ms, "turns_ms": turns,
                 "previous_wrapper_ms": previous_wrapper_ms,
                 "wrapper_turns_ms": wrapper_turns,
                 "previous_deepest_tile_ms": p_bare(deep)}
    else:
        ms, wrapper_ms = bare(), wrapper()
        extra = {"previous_ms": None, "previous_wrapper_ms": None}
    w = walk(prep, pairs, settings)
    return walk_line("K1", name, w, pairs, k1_ms=ms, wrapper_ms=wrapper_ms,
                     deepest_tile_ms=bare(deep), **k1_walk_stats(w, pairs),
                     **extra)


def phase_timing(params, size: int, device, bg, previous=None) -> dict:
    """Medians of CUDA-event times at the first orbit view and the close
    view (in turns with the parent's K1 when given); K1's bound."""
    log(phase=4)
    n = params["positions"].shape[0]
    cam = scenes.lego_orbit(THETAS[0], size)
    settings = RenderSettings(width=size, height=size,
                              pair_capacity=default_pair_capacity(n))
    frame_ms = time_ms(lambda: render_view(params, cam, size, bg, device), 20)
    prep_bin_ms = time_ms(lambda: prep_and_pairs(params, cam, settings), 20)
    prep, pairs = prep_and_pairs(params, cam, settings)
    line = k1_times("orbit theta=0", prep, pairs, settings, previous)
    plain_ms = time_ms(lambda: rasterize.composite_forward(
        prep, pairs, settings), 5, warmup=1)
    steps = line["evaluated_steps"]
    t = settings.num_tiles
    pair_slots = int(pairs.tile_count.sum())
    nbytes = (n * RECORD_BYTES + pair_slots * 4 + t * 8
              + t * 256 * OUT_BYTES_PER_PIXEL)
    flop_ms = steps * FLOPS_PER_STEP / PEAK_FP32_FLOPS * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(flop_ms, byte_ms)
    c_prep, c_pairs = prep_and_pairs(params, scenes.lego_close_view(size),
                                     settings)
    k1_times("close, every tile occupied", c_prep, c_pairs, settings,
             previous)
    k1_ms = line["k1_ms"]
    log(frame_ms=frame_ms, preprocess_binning_ms=prep_bin_ms, k1_ms=k1_ms,
        plain_ms=plain_ms, pairs=int(pairs.num_pairs), steps=steps,
        bytes=nbytes, flop_bound_ms=flop_ms, byte_bound_ms=byte_ms,
        bound_share=bound_ms / k1_ms,
        library_ms=None, library_note="no single PyTorch call computes "
        "this compositing")
    return {"ms": k1_ms, "previous_ms": line["previous_ms"],
            "wrapper_ms": line["wrapper_ms"],
            "previous_wrapper_ms": line["previous_wrapper_ms"],
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}


def check_grads(name: str, got, want, flip_tolerant: bool) -> dict:
    """Hold gradients against a reference; raise outside the tolerance.
    Returns the largest absolute error and the largest error relative to
    each output's largest magnitude, over the outputs."""
    errs = kernel_check.grad_errors(got, want, GRAD_REL_TOL)
    if flip_tolerant:
        ok = all(e["over_tol_frac"] <= GRAD_OUTLIER_FRAC
                 and e["rel_max"] <= GRAD_OUTLIER_CAP for e in errs.values())
    else:
        ok = all(e["rel_max"] < GRAD_REL_TOL for e in errs.values())
    log(check=name, ok=ok, flip_tolerant=flip_tolerant, errors=errs)
    if not ok:
        raise RuntimeError(f"{name}: gradients outside the tolerance: {errs}")
    return {"max_abs_err": max(e["abs_max"] for e in errs.values()),
            "max_rel_err": max(e["rel_max"] for e in errs.values())}


def backward_inputs(prep, pairs, settings, rng):
    """Forward outputs (K1) and seeded normal cotangents for a K2 check."""
    color, dacc, final_t, _ = cuda_rasterize.composite_forward(prep, pairs,
                                                               settings)
    dev = prep.xy.device
    t = settings.band_tiles
    dl_dpix = torch.tensor(rng.normal(size=(t, 256, 3)), dtype=torch.float32,
                           device=dev)
    dl_ddepth = torch.tensor(rng.normal(size=(t, 256)), dtype=torch.float32,
                             device=dev)
    bg = torch.tensor([0.1, 0.2, 0.3], dtype=torch.float32, device=dev)
    return dict(color_pre_bg=color, final_t=final_t, dl_dpix=dl_dpix, bg=bg,
                depth_acc=dacc, dl_ddepth=dl_ddepth)


def k2_vs_plain(name: str, prep, pairs, settings, inputs) -> dict:
    got = cuda_rasterize.composite_backward(prep, pairs, settings, **inputs)
    want = rasterize.composite_backward(prep, pairs, settings, **inputs)
    return check_grads(f"{name}: K2 vs plain on the card", got, want,
                       flip_tolerant=True)


def k2_deterministic(name: str, prep, pairs, settings, inputs) -> None:
    """Two runs of K2 on the same inputs must give bit-identical rows."""
    rows = [cuda_rasterize.backward_rows(prep, pairs, settings, **inputs)
            for _ in range(2)]
    identical = bool(torch.equal(rows[0].view(torch.int32),
                                 rows[1].view(torch.int32)))
    log(check=f"K2 determinism: two runs on {name}", bit_identical=identical,
        rows=int(rows[0].shape[0]), pairs=int(pairs.num_pairs))
    if not identical:
        raise RuntimeError(f"{name}: two runs of K2 gave different rows")


def phase_k2_checks(params, size: int, device) -> dict:
    """K2 + epilogue against the stored JAX gradients and its plain version,
    from T = 1 and from K1's checkpoints; returns the largest absolute and
    relative errors of K2 from checkpoints against the plain version at the
    close 800x800 view."""
    log(phase=5)
    gate = kernel_check.load_gate(device)
    fwd = kernel_check.gate_forward(gate)
    want = {k: gate.stored[f"g_{k}"] for k in GRAD_NAMES}
    check_grads("gate: K2 + epilogue vs stored JAX gradients",
                kernel_check.gate_backward(gate, fwd), want,
                flip_tolerant=False)
    check_grads("gate: plain version on the card vs stored JAX gradients",
                kernel_check.gate_backward(gate, fwd,
                                           rasterize.composite_backward),
                want, flip_tolerant=False)
    inputs = dict(color_pre_bg=fwd["color"], final_t=fwd["final_t"],
                  dl_dpix=gate.dl_dpix, bg=gate.bg, depth_acc=fwd["depth"],
                  dl_ddepth=gate.ct_d)
    k2_vs_plain("gate", gate.prep, gate.pairs, gate.settings, inputs)
    k2_deterministic("gate", gate.prep, gate.pairs, gate.settings, inputs)
    # the main path's form: K2 from K1's checkpoints
    *_, ckpt = cuda_rasterize.composite_forward_checkpointed(
        gate.prep, gate.pairs, gate.settings)
    check_grads("gate: K2 from checkpoints + epilogue vs stored JAX gradients",
                cuda_rasterize.composite_backward(
                    gate.prep, gate.pairs, gate.settings, **inputs,
                    checkpoints=ckpt), want, flip_tolerant=False)
    k2_segmented_checks("gate", gate.prep, gate.pairs, gate.settings, inputs)

    settings, p_np, cam, dl_dpix, dl_ddepth, bg = scenes.early_exit_scene()
    p = convert.params_from_numpy(p_np, device)
    prep, pairs = prep_and_pairs(
        p, dict(world_to_camera=cam["view"], full_proj_matrix=cam["proj"],
                camera_center=cam["campos"], tan_fovx=cam["tan_fovx"],
                tan_fovy=cam["tan_fovy"]), settings)
    starts = pairs.tile_start[pairs.tile_count > 0]
    color, dacc, final_t, _ = cuda_rasterize.composite_forward(prep, pairs,
                                                               settings)
    misaligned = int((starts % 128 != 0).sum())
    saturated = int((final_t < 1e-2).sum())
    log(check="early-exit scene", pairs=int(pairs.num_pairs),
        misaligned_starts=misaligned, saturated_pixels=saturated)
    if misaligned == 0 or saturated == 0:
        raise RuntimeError("the early-exit scene needs tile starts off the "
                           "multiples of 128 and saturated pixels")
    inputs = dict(color_pre_bg=color, final_t=final_t,
                  dl_dpix=torch.tensor(dl_dpix, device=device),
                  bg=torch.tensor(bg, device=device), depth_acc=dacc,
                  dl_ddepth=torch.tensor(dl_ddepth, device=device))
    k2_vs_plain("early-exit scene", prep, pairs, settings, inputs)
    k2_segmented_checks("early-exit scene", prep, pairs, settings, inputs)

    n = params["positions"].shape[0]
    full = RenderSettings(width=size, height=size,
                          pair_capacity=default_pair_capacity(n))
    prep, pairs = prep_and_pairs(params, scenes.lego_close_view(size), full)
    occupied = int((pairs.tile_count > 0).sum())
    log(check="lego close view for K2", tiles=full.num_tiles,
        occupied_tiles=occupied, pairs=int(pairs.num_pairs))
    if occupied != full.num_tiles:
        raise RuntimeError("the full-size Lego view leaves tiles empty")
    inputs = backward_inputs(prep, pairs, full, np.random.default_rng(11))
    k2_vs_plain(f"lego close {size}x{size}", prep, pairs, full, inputs)
    k2_deterministic(f"lego close {size}x{size}", prep, pairs, full, inputs)
    return k2_segmented_checks(f"lego close {size}x{size}", prep, pairs, full,
                               inputs)


def lego_models(device, capacity_headroom: float):
    """(unperturbed, perturbed) Lego models at capacity
    int(129,053 x headroom), dead slots zero-padded, and the number of live
    Gaussians."""
    params = scenes.lego_params()
    n = params["positions"].shape[0]
    capacity = int(n * capacity_headroom)
    rng = np.random.default_rng(PERTURB_SEED)
    pert = dict(params)
    pert["positions"] = (params["positions"] + rng.normal(
        0, PERTURB_POS, (n, 3))).astype(np.float32)
    shs = params["shs"].reshape(n, -1, 3).copy()
    shs[:, 0] += rng.normal(0, PERTURB_SH_DC, (n, 3)).astype(np.float32)
    pert["shs"] = shs
    pert["opacities"] = (params["opacities"].reshape(n) * rng.uniform(
        *PERTURB_OPACITY, n)).astype(np.float32)
    alive = np.ones(n, bool)
    return tuple(grow_capacity(convert.model_from_numpy(
        {**x, "alive": alive}, device), capacity)
        for x in (params, pert)) + (n,)


def render_model(model: GaussianModel, cam, size: int, bg):
    return render_gaussians(
        bg, model.positions, opacity=model.opacities, scales=model.scales,
        rotations=model.rotations, viewmatrix=cam["world_to_camera"],
        projmatrix=cam["full_proj_matrix"], tan_fovx=cam["tan_fovx"],
        tan_fovy=cam["tan_fovy"], image_height=size, image_width=size,
        sh=model.shs, degree=3, campos=cam["camera_center"],
        alive=model.alive, device=bg.device)[0]


class TrainRun:
    """The main path's state: config, settings, cameras, targets, model."""

    def __init__(self, size: int, device):
        self.cfg = GSConfig()
        self.size = size
        self.device = device
        self.bg = torch.zeros(3, dtype=torch.float32, device=device)
        self.model0, self.model, self.n_live = lego_models(
            device, self.cfg.capacity_headroom)
        cap = round_capacity(self.model.capacity
                             * self.cfg.pair_capacity_per_gaussian)
        self.settings = train_settings(self.cfg, size, size, cap, cap)
        self.cams = [scenes.lego_orbit(2 * math.pi * k / TRAIN_VIEWS, size)
                     for k in range(TRAIN_VIEWS)]
        self.cam_t = [camera_tensors(c, device) for c in self.cams]
        self.targets = [render_model(self.model0, c, size, self.bg)
                        for c in self.cams]
        self.held_out = scenes.lego_orbit(HELD_OUT_THETA, size)
        self.held_out_target = render_model(self.model0, self.held_out, size,
                                            self.bg)
        self.adam = init_adam_state(self.model.param_dict())
        self.rng = np.random.default_rng(self.cfg.seed)
        self.iteration = 0

    def next_view(self) -> int:
        return int(self.rng.integers(0, TRAIN_VIEWS))

    def view_args(self, i: int):
        cam = self.cams[i]
        return (*self.cam_t[i], cam["tan_fovx"], cam["tan_fovy"],
                self.targets[i])

    def held_out_loss(self) -> float:
        return float(l1_loss(render_model(self.model, self.held_out,
                                          self.size, self.bg),
                             self.held_out_target))


@contextlib.contextmanager
def recording_checkpoints():
    """Within the block, ``cuda_rasterize.composite_forward_checkpointed``
    (which ``rasterize.render`` looks up at each call) appends the
    ``Checkpoints`` it returns to the list it yields, and runs unchanged."""
    fn = cuda_rasterize.composite_forward_checkpointed
    found = []

    def recorded(*args, **kwargs):
        out = fn(*args, **kwargs)
        found.append(out[4])
        return out

    cuda_rasterize.composite_forward_checkpointed = recorded
    try:
        yield found
    finally:
        cuda_rasterize.composite_forward_checkpointed = fn


def phase_train(run: TrainRun) -> dict:
    """The main path: TRAIN_STEPS train steps; returns the launch counts,
    the CTAs launched and the work items run."""
    log(phase=6, gaussians=run.n_live, capacity=run.model.capacity,
        pair_capacity=run.settings.pair_capacity,
        kept_capacity=run.settings.kept_capacity, steps=TRAIN_STEPS,
        views=TRAIN_VIEWS)
    before = run.held_out_loss()
    zero_launches()
    losses, counts, views = [], [], []
    with recording_checkpoints() as checkpoints:
        for _ in range(TRAIN_STEPS):
            i = run.next_view()
            views.append(i)
            was = launch_counts()
            (run.model, run.adam, loss, grad_pos, cnt,
             run.iteration) = train_step(run.settings, run.cfg, run.model,
                                         run.adam, *run.view_args(i),
                                         run.iteration)
            now = launch_counts()
            if any(now[k] - was[k] != 1 for k in now):
                raise RuntimeError(f"step {run.iteration}: launches {was} -> "
                                   f"{now}, not one each")
            losses.append(loss)
            counts.append(cnt)
            if not bool(torch.isfinite(grad_pos).all()):
                raise RuntimeError(f"step {run.iteration}: non-finite "
                                   "position gradient")
    torch.cuda.synchronize()
    got, got_ctas = launch_counts(), launch_counts("ctas")
    # K2's work: the (tile, segment) items that K1 wrote beside its
    # checkpoints, not whole tiles
    if len(checkpoints) != TRAIN_STEPS or None in checkpoints:
        raise RuntimeError(f"{len(checkpoints)} checkpointed forwards in "
                           f"{TRAIN_STEPS} steps")
    segments = [c.work.segment for c in checkpoints]
    real = [c.work.items[:int(c.work.ends[-1])] for c in checkpoints]
    work_items = sum(int(r.shape[0]) for r in real)
    item_tiles = sum(int(torch.unique(r[:, 0]).numel()) for r in real)
    split = [bool((r[:, 1] > 0).any()) for r in real]
    after = run.held_out_loss()
    losses = torch.stack(losses).cpu().numpy()
    counts = torch.stack(counts).cpu().numpy()
    alive = run.model.alive
    finite_moments = all(bool(torch.isfinite(m[alive]).all())
                         for m in run.adam.m.values())
    finite_params = all(bool(torch.isfinite(x[alive]).all())
                        for x in run.model.param_dict().values())
    log(path="train", launches=got, ctas=got_ctas, views=views,
        losses=losses.tolist(),
        max_pairs=int(counts[:, 0].max()), max_kept=int(counts[:, 1].max()),
        held_out_l1_before=before, held_out_l1_after=after,
        finite_moments=finite_moments, finite_params=finite_params,
        k2_segments=sorted(set(segments)), k2_work_items=work_items,
        k2_item_tiles=item_tiles, steps_with_a_split_tile=sum(split))
    if got != dict.fromkeys(KERNEL_COUNTERS, TRAIN_STEPS):
        raise RuntimeError(f"{got} launches for {TRAIN_STEPS} train steps")
    if set(segments) != {cuda_rasterize.SEGMENT} or work_items <= item_tiles:
        raise RuntimeError("the main path's K2 did not run from K1's "
                           f"checkpoints in segments: {segments}, {split}, "
                           f"{work_items} items over {item_tiles} tiles")
    if (counts[:, 0] > run.settings.pair_capacity).any() \
            or (counts[:, 1] > run.settings.kept_capacity).any():
        raise RuntimeError("a train step overflowed its pair capacity")
    if not (np.isfinite(losses).all() and finite_moments and finite_params):
        raise RuntimeError("non-finite loss, gradient or parameter")
    if not after < before:
        raise RuntimeError(f"held-out L1 did not fall: {before} -> {after}")
    # a K1 CTA is one work item (a 64-pixel strip of a tile); K2 launches
    # a bound of CTAs, and those past its items return at once
    return {"launches": got, "ctas": got_ctas,
            "work_items": {"rasterize_fwd": got_ctas["rasterize_fwd"],
                           "rasterize_bwd": work_items}}


def activated(model: GaussianModel) -> GaussianModel:
    """The same Gaussians in the official 3DGS storage (log scales, logit
    opacities); opacities clipped to [1e-3, 0.999] and scales floored at
    1e-7 so every stored value is finite."""
    op = torch.clamp(model.opacities, 1e-3, 0.999)
    return model.replace(scales=torch.log(torch.clamp(model.scales,
                                                      min=1e-7)),
                         opacities=torch.log(op / (1.0 - op)))


def step_vs_plain(name: str, settings, cfg, model, view, proj, campos,
                  tan_fovx, tan_fovy, target, **depth) -> dict:
    """One step's loss and gradients with K1 + K2 against the plain
    versions on the card, from the same model and view; raises outside
    LOSS_REL_TOL or check_grads' flip-tolerant thresholds."""
    args = (settings, cfg, model, view, proj, campos, tan_fovx, tan_fovy,
            target)
    loss_k, grads_k, aux = loss_and_grads(*args, **depth)
    loss_p, grads_p, _ = loss_and_grads(*args, **depth,
                                        _compositing=PLAIN_COMPOSITING)
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    log(check=f"{name}: loss kernels vs plain", loss=float(loss_k),
        loss_plain=float(loss_p), rel=rel, pairs=int(aux.num_pairs),
        kept_pairs=int(aux.num_kept), pair_capacity=settings.pair_capacity,
        kept_capacity=settings.kept_capacity, capacity=model.capacity,
        n_alive=int(model.n_alive))
    if not rel < LOSS_REL_TOL:
        raise RuntimeError(f"{name}: loss differs by {rel} relative")
    return check_grads(f"{name}: gradients kernels vs plain", grads_k,
                       grads_p, flip_tolerant=True)


def phase_step_vs_plain(run: TrainRun) -> None:
    """One step's loss and gradients with K1 + K2 against the plain
    versions on the card, from the same model, raw/L1 and activated/SSIM."""
    log(phase=7)
    i = run.next_view()
    for name, cfg, model in (
            ("raw, L1", run.cfg, run.model),
            ("activated, lambda_dssim 0.2",
             run.cfg.replace(parameterization="activated", lambda_dssim=0.2),
             activated(run.model))):
        step_vs_plain(f"step {name}, view {i}", run.settings, cfg, model,
                      *run.view_args(i))


def phase_train_timing(run: TrainRun, previous=None) -> dict:
    """Medians of CUDA-event times of the main path's parts at its shapes
    (the trained model, the next view of the camera order); K2's bare and
    wrapper times, and the step's compositing and gradients, in turns with
    the parent's when given; K2's bound."""
    log(phase=8)
    i = run.next_view()
    view, proj, campos, tanx, tany, target = run.view_args(i)
    s, cfg, model = run.settings, run.cfg, run.model
    train_ms = time_ms(lambda: train_step(s, cfg, model, run.adam, view, proj,
                                          campos, tanx, tany, target,
                                          run.iteration), 10)
    p = {k: x.detach().requires_grad_(True)
         for k, x in model.param_dict().items()}
    fwd_args = (s, tanx, tany, cfg.scale_modifier, p["positions"],
                p["scales"], p["rotations"], p["opacities"], p["shs"], view,
                proj, campos, run.bg, model.alive)
    with torch.no_grad():
        forward_ms = time_ms(lambda: rasterize.render_forward(*fwd_args), 10)
    image, _, _ = rasterize.render(*fwd_args)
    loss = l1_loss(image, target)
    backward_ms = time_ms(lambda: torch.autograd.grad(
        loss, list(p.values()), retain_graph=True), 10)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    lrs = schedule_lrs(cfg, run.iteration)
    adam_ms = time_ms(lambda: adam_step(model.param_dict(), grads, run.adam,
                                        lrs, run.iteration, cfg,
                                        alive=model.alive), 10)

    with torch.no_grad():
        (image, _, aux), (prep, pairs, color, dacc, ckpt) = \
            rasterize._render_fwd(
                *fwd_args, 0, cuda_rasterize.composite_forward_checkpointed)
    final_t = aux.final_t
    dl_dpix = rasterize.image_to_tiles(l1_pixel_gradients(image, target), s)
    inputs = dict(color_pre_bg=color, final_t=final_t, dl_dpix=dl_dpix,
                  bg=run.bg, depth_acc=dacc,
                  dl_ddepth=torch.zeros_like(final_t))

    lib = cuda_rasterize._library("rasterize_bwd")

    def bare(pairs=pairs, checkpoints=ckpt):
        """K2 alone, as the main path runs it: from K1's checkpoints."""
        return bare_ms(lib, "gstpu_rasterize_bwd",
                       lambda: cuda_rasterize.backward_rows(
                           prep, pairs, s, **inputs, checkpoints=checkpoints))

    def wrapper():
        return time_ms(lambda: cuda_rasterize.backward_rows(
            prep, pairs, s, **inputs, checkpoints=ckpt), 20)

    def step_compositing():
        """K1 and K2 with their wrappers, as a training step runs them."""
        *_, c = cuda_rasterize.composite_forward_checkpointed(prep, pairs, s)
        return cuda_rasterize.backward_rows(prep, pairs, s, **inputs,
                                            checkpoints=c)

    args = (s, cfg, model) + run.view_args(i)
    deep = only_deepest(pairs)
    if previous is not None:
        # the parent's main path: its K2 from its own K1's checkpoints
        plib = previous.libs["rasterize_bwd"]
        mod = previous.module
        p_forward = mod.composite_forward_checkpointed
        p_ckpt = p_forward(prep, pairs, s)[4]

        def p_bare(pairs=pairs, checkpoints=p_ckpt):
            return bare_ms(plib, "gstpu_rasterize_bwd",
                           lambda: mod.backward_rows(
                               prep, pairs, s, **inputs,
                               checkpoints=checkpoints))

        def p_step_compositing():
            *_, c = p_forward(prep, pairs, s)
            return mod.backward_rows(prep, pairs, s, **inputs, checkpoints=c)

        previous_ms, k2_ms, turns = in_turns(p_bare, bare)
        previous_wrapper_ms, wrapper_ms, wrapper_turns = in_turns(
            lambda: time_ms(lambda: mod.backward_rows(
                prep, pairs, s, **inputs, checkpoints=p_ckpt), 20),
            wrapper)
        p_comp, comp, comp_turns = in_turns(
            lambda: time_ms(p_step_compositing, 20),
            lambda: time_ms(step_compositing, 20))
        # the step's loss and gradients with either tree's compositing
        p_grads, grads_ms, grads_turns = in_turns(
            lambda: time_ms(lambda: loss_and_grads(
                *args, _compositing=(p_forward,
                                     mod.composite_backward)), 10),
            lambda: time_ms(lambda: loss_and_grads(*args), 10))
        extra = {"previous_ms": previous_ms, "turns_ms": turns,
                 "previous_wrapper_ms": previous_wrapper_ms,
                 "wrapper_turns_ms": wrapper_turns,
                 "step_compositing_ms": comp,
                 "previous_step_compositing_ms": p_comp,
                 "step_compositing_turns_ms": comp_turns,
                 "loss_and_grads_ms": grads_ms,
                 "previous_loss_and_grads_ms": p_grads,
                 "loss_and_grads_turns_ms": grads_turns,
                 "previous_deepest_tile_ms": p_bare(
                     deep, p_forward(prep, deep, s)[4])}
    else:
        k2_ms, wrapper_ms = bare(), wrapper()
        extra = {"previous_ms": None, "previous_wrapper_ms": None,
                 "step_compositing_ms": time_ms(step_compositing, 20)}
    deep_ckpt = cuda_rasterize.composite_forward_checkpointed(prep, deep,
                                                              s)[4]
    rows = cuda_rasterize.backward_rows(prep, pairs, s, **inputs,
                                        checkpoints=ckpt)
    epilogue_ms = time_ms(lambda: rasterize.segment_sum_pair_rows(
        rows, pairs, s), 20)
    # the same function as the plain version: K2 and its epilogue
    k2_epilogue_ms = time_ms(lambda: cuda_rasterize.composite_backward(
        prep, pairs, s, **inputs, checkpoints=ckpt), 20)
    plain_ms = time_ms(lambda: rasterize.composite_backward(
        prep, pairs, s, **inputs), 3, warmup=1)
    w = walk(prep, pairs, s)
    steps, kept = w.evaluated, w.kept
    walk_line("K2", f"train step view {i}", w, pairs, k2_ms=k2_ms,
              wrapper_ms=wrapper_ms, deepest_tile_ms=bare(deep, deep_ckpt),
              **k2_walk_stats(w, pairs, cuda_rasterize.SEGMENT), **extra)
    n = prep.xy.shape[0]
    t = s.band_tiles
    slots = int(pairs.tile_count.sum())
    nbytes = (n * RECORD_BYTES + slots * 4 + t * 8 + t * 256 * PIX_IN_BYTES
              + slots * ROW_BYTES)
    ops = steps * FLOPS_PER_STEP + kept * BWD_FLOPS_PER_KEPT
    flop_ms = ops / PEAK_FP32_FLOPS * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(flop_ms, byte_ms)
    log(view=i, train_step_ms=train_ms, forward_ms=forward_ms,
        backward_ms=backward_ms, adam_ms=adam_ms, k2_ms=k2_ms,
        epilogue_ms=epilogue_ms, k2_epilogue_ms=k2_epilogue_ms,
        plain_ms=plain_ms,
        pairs=int(pairs.num_pairs), kept_pairs=int(pairs.num_kept),
        evaluated_steps=steps, kept_steps=kept, bytes=nbytes, operations=ops,
        flop_bound_ms=flop_ms, byte_bound_ms=byte_ms,
        bound_share=bound_ms / k2_ms, library_ms=None,
        library_note="no single PyTorch call computes this backward")
    return {"train_step_ms": train_ms, "ms": k2_ms,
            "previous_ms": extra["previous_ms"], "wrapper_ms": wrapper_ms,
            "previous_wrapper_ms": extra["previous_wrapper_ms"],
            "ms_with_epilogue": k2_epilogue_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "times_cover": "ms, wrapper_ms and bound_ms: K2 alone (per-pair "
            "rows); ms_with_epilogue and plain_ms: per-Gaussian gradients "
            "(K2 or the plain walk, then the per-Gaussian sums)"}


def phase_k3_checks(device, previous=None) -> dict:
    """K3 against its plain version on the card at the model's 2,500 tiles;
    beside it, when given, how far its outputs moved from the parent's K3's
    (reported: this K3 takes t_ex from the exclusive product where the
    parent divided, so neither form keeps the parent's bits).  Returns
    {form: (largest absolute error, largest error over its row's largest
    magnitude)} against the plain version over the chunk counts."""
    log(phase=9)
    feat = sol_model.feature_block(device)
    tiles = sol_model.TILES
    errs = {}
    for backward in (False, True):
        form = "sol_compositing_bwd" if backward else "sol_compositing_fwd"
        worst = (0.0, 0.0)
        for n_chunks in K3_CHUNKS:
            before = dict(sol_model.LAUNCHES)
            got = sol_model.sol_compositing(feat, n_chunks, tiles, backward)
            again = sol_model.sol_compositing(feat, n_chunks, tiles, backward)
            torch.cuda.synchronize()
            launched = {k: sol_model.LAUNCHES[k] - before[k] for k in before}
            want = sol_model.sol_compositing_plain(feat, n_chunks, tiles,
                                                   backward)
            diff = (got.double() - want.double()).abs()
            row_scale = want.double().abs().amax(dim=(0, 2)).clamp(min=1e-12)
            row_rel = diff.amax(dim=(0, 2)) / row_scale
            res = {"check": f"K3 {'backward' if backward else 'forward'} vs "
                   f"plain on the card", "tiles": tiles, "n_chunks": n_chunks,
                   "shape": list(got.shape), "max_abs_err": float(diff.max()),
                   "row_rel_err": row_rel.tolist(),
                   "row_max": row_scale.tolist(),
                   "tiles_bit_identical": bool(
                       (_bits(got) == _bits(got[:1])).all()),
                   "runs_bit_identical": bool(torch.equal(_bits(got),
                                                          _bits(again))),
                   "launches": launched}
            if previous is not None:
                parent = previous.sol.sol_compositing(feat, n_chunks, tiles,
                                                      backward)
                vs_parent = (got.double() - parent.double()).abs()
                res["parent_bit_identical"] = bool(torch.equal(
                    _bits(got), _bits(parent)))
                res["parent_max_abs_diff"] = float(vs_parent.max())
                res["parent_row_rel_diff"] = (vs_parent.amax(dim=(0, 2))
                                              / row_scale).tolist()
            res["ok"] = bool(
                res["tiles_bit_identical"] and res["runs_bit_identical"]
                and launched == {k: 2 * (k == form) for k in launched}
                and bool(torch.isfinite(got).all())
                and (float(row_rel.max()) < K3_BWD_REL_TOL if backward
                     else res["max_abs_err"] < K3_FWD_TOL))
            log(**res)
            if not res["ok"]:
                raise RuntimeError(f"K3 check failed: {res}")
            worst = (max(worst[0], res["max_abs_err"]),
                     max(worst[1], float(row_rel.max())))
        errs[form] = worst
    return errs


def phase_sol(device, previous=None) -> tuple[dict, dict]:
    """The speed-of-light model on the card, K3's launches and CTAs
    counted; K3's bare and wrapper times beside its bound and its plain
    version's, each in turns with the parent's K3 when given.  Returns the
    model's dict and {form: record fields}."""
    log(phase=10)
    launches, ctas = sol_model.LAUNCHES, sol_model.CTAS
    torch.cuda.synchronize()
    for k in launches:
        launches[k] = ctas[k] = 0
    sol = sol_model.run(device)
    torch.cuda.synchronize()
    counts, got_ctas = dict(launches), dict(ctas)
    log(path="sol model", launches=counts, ctas=got_ctas, **sol)
    if counts != {k: sol_model.TIMED_CALLS for k in counts}:
        raise RuntimeError(f"sol model launched K3 {counts}, not "
                           f"{sol_model.TIMED_CALLS} each")
    if not all(math.isfinite(v) and v > 0 for v in sol["stages"].values()):
        raise RuntimeError(f"sol model stages {sol['stages']}")
    _, b, _, _ = sol_model.sort_inputs(device)
    log(stage="binning_scans, split", cumsum_ms=time_ms(
        lambda: torch.cumsum(b, dim=0, dtype=b.dtype), 20),
        cummax_ms=time_ms(lambda: torch.cummax(b, dim=0), 20))
    feat = sol_model.feature_block(device)
    out = {}
    for backward in (False, True):
        form = "sol_compositing_bwd" if backward else "sol_compositing_fwd"
        args = (feat, sol_model.N_CHUNKS, sol_model.TILES, backward)

        def bare(wrapper=sol_model.sol_compositing, lib=sol_model._library()):
            return bare_ms(lib, "gstpu_sol_compositing",
                           lambda: wrapper(*args))

        def wrapper(fn=sol_model.sol_compositing):
            return time_ms(lambda: fn(*args), 50)

        if previous is not None:
            p_fn = previous.sol.sol_compositing
            previous_ms, ms, turns = in_turns(
                lambda: bare(p_fn, previous.libs["sol_compositing"]), bare)
            previous_wrapper_ms, wrapper_ms, wrapper_turns = in_turns(
                lambda: wrapper(p_fn), wrapper)
            extra = {"previous_ms": previous_ms, "turns_ms": turns,
                     "previous_wrapper_ms": previous_wrapper_ms,
                     "wrapper_turns_ms": wrapper_turns}
        else:
            ms, wrapper_ms = bare(), wrapper()
            extra = {"previous_ms": None, "previous_wrapper_ms": None}
        plain_ms = time_ms(lambda: sol_model.sol_compositing_plain(*args), 5,
                           warmup=1)
        bound = sol_model.k3_bound(sol_model.TILES, sol_model.N_CHUNKS,
                                   backward, PEAK_FP32_FLOPS,
                                   PEAK_BYTES_PER_S)
        stage = "bwd" if backward else "fwd"
        log(kernel=form, ms=ms, wrapper_ms=wrapper_ms, **extra,
            sol_stage_ms=sol["stages"][f"{stage}_compositing_ms"],
            plain_ms=plain_ms, bound_share=bound["bound_ms"] / ms,
            card=sol["device"], library_ms=None,
            library_note="no single PyTorch call computes this", **bound)
        # one CTA, one work item, per tile
        out[form] = {"launches": counts[form], "ctas": got_ctas[form],
                     "work_items": got_ctas[form], "ms": ms,
                     "wrapper_ms": wrapper_ms, **extra, "plain_ms": plain_ms,
                     "bound_ms": bound["bound_ms"],
                     "bound_by": bound["bound_by"]}
    return sol, out


def phase_bench(device, sol: dict) -> None:
    """The port's bench through its entry point, launches counted; the
    headline iteration against the same with the plain compositing; the
    bench suite."""
    log(phase=11)
    zero_launches()
    record = bench.main([], sol=sol)
    torch.cuda.synchronize()
    counts = launch_counts()
    extra = record["extra"]
    gate = extra.get("kernel_parity", {})
    # the gate runs K1 and K2 once on its stored pairs and the preprocess
    # kernel once on its scene; the headline and the trained scene each bin
    # once (after the plain preprocess) to fit their capacities and run
    # bench.RUNS timed fwd+bwd iterations
    want = {"rasterize_fwd": 1 + 2 * bench.RUNS,
            "rasterize_bwd": 1 + 2 * bench.RUNS,
            "binning": 2 + 2 * bench.RUNS,
            "preprocess": 1 + 2 * bench.RUNS}
    log(path="bench", launches=counts, expected=want,
        per_iteration=extra["launches_per_iteration"], gate=gate)
    problems = []
    if not (extra.get("kernel_parity_ok") and gate.get("prep_ok")):
        problems.append("the kernel gate failed")
    if extra["launches_per_iteration"] != {"k1.launches": 1.0,
                                           "k2.launches": 1.0} \
            or counts != want:
        problems.append(f"launches {counts}, per iteration "
                        f"{extra['launches_per_iteration']}")
    if "trained_scene_ms" not in extra or "vs_sol" not in extra:
        problems.append("no trained-scene time or vs_sol: "
                        f"{extra.get('trained_scene_error')}")
    if not (math.isfinite(record["value"]) and record["value"] > 0):
        problems.append(f"headline {record['value']} ms")
    if problems:
        raise RuntimeError(f"bench: {problems}")

    work, _ = bench.headline(device)
    loss_k, grads_k, aux = bench.fwd_bwd(work)
    p = [x.detach().requires_grad_(True) for x in work.params]
    v = work.view
    img, _, _ = rasterize.render(work.settings, v.tan_fovx, v.tan_fovy, 1.0,
                                 *p, v.view, v.proj, v.campos, work.bg,
                                 _compositing=PLAIN_COMPOSITING)
    loss_p = l1_loss(img, work.target)
    grads_p = torch.autograd.grad(loss_p, p)
    loss_p = loss_p.detach()
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    log(check="headline iteration: loss kernels vs plain", loss=float(loss_k),
        loss_plain=float(loss_p), rel=rel, pairs=int(aux.num_pairs),
        kept_pairs=int(aux.num_kept))
    if not rel < LOSS_REL_TOL or int(aux.num_pairs) > work.settings.pair_capacity \
            or int(aux.num_kept) > work.settings.kept_capacity:
        raise RuntimeError("headline iteration: loss or capacity check failed")
    names = convert.PARAM_KEYS
    check_grads("headline iteration: gradients kernels vs plain",
                dict(zip(names, grads_k)), dict(zip(names, grads_p)),
                flip_tolerant=True)

    for rec in bench_suite.main(["--ply", str(scenes.LEGO_PLY)]):
        if not (math.isfinite(rec["value"]) and rec["value"] > 0):
            raise RuntimeError(f"bench suite: {rec}")


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) unit quaternion of a rotation matrix (COLMAP's
    ``rotmat2qvec``: the eigenvector of the largest eigenvalue)."""
    (r00, r01, r02), (r10, r11, r12), (r20, r21, r22) = R
    K = np.array([[r00 - r11 - r22, 0.0, 0.0, 0.0],
                  [r01 + r10, r11 - r00 - r22, 0.0, 0.0],
                  [r02 + r20, r12 + r21, r22 - r00 - r11, 0.0],
                  [r21 - r12, r02 - r20, r10 - r01, r00 + r11 + r22]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def write_colmap_capture(root: Path, cams, images, xyz, rgb) -> None:
    """A COLMAP capture of square views: one PINHOLE camera (the views'
    shared focal), ``images.bin`` with each camera dict's world-to-camera
    pose and no 2D points, ``points3D.bin`` with ``xyz`` and the uint8
    colours ``rgb`` and empty tracks, and ``images/r_XX.png``."""
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True, exist_ok=True)
    (root / "images").mkdir(exist_ok=True)
    size = cams[0]["width"]
    focal = size / (2.0 * cams[0]["tan_fovx"])
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, size, size))  # id 1, PINHOLE
        f.write(struct.pack("<4d", focal, focal, size / 2, size / 2))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for i, (cam, img) in enumerate(zip(cams, images)):
            w2c = np.asarray(cam["world_to_camera"], np.float64).T
            name = f"r_{i:02d}.png"
            f.write(struct.pack("<i4d3di", i + 1, *rotmat_to_qvec(w2c[:3, :3]),
                                *w2c[:3, 3], 1))
            f.write(name.encode() + b"\x00" + struct.pack("<Q", 0))
            imwrite(root / "images" / name, img)
    record = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                       ("error", "<f8"), ("track", "<u8")])
    points = np.zeros(len(xyz), record)
    points["id"] = np.arange(1, len(xyz) + 1)
    points["xyz"], points["rgb"] = xyz, rgb
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(xyz)) + points.tobytes())


def capture_readback_error(root: Path, cams) -> float:
    """Largest difference between the camera dicts and the port's
    ``ColmapDataset`` reading of the capture (every view, no holdout);
    raises if the sizes differ."""
    data = ColmapDataset(str(root), "train", holdout=0)
    if len(data) != len(cams):
        raise RuntimeError(f"{len(data)} views read back, {len(cams)} written")
    err = 0.0
    for got, want in zip(data.cameras, cams):
        if (got["width"], got["height"]) != (want["width"], want["height"]):
            raise RuntimeError("a view was read back at another size")
        for k in ("world_to_camera", "full_proj_matrix", "camera_center",
                  "tan_fovx", "tan_fovy"):
            err = max(err, float(np.max(np.abs(
                np.asarray(got[k], np.float64)
                - np.asarray(want[k], np.float64)))))
    return err


@contextlib.contextmanager
def uncounted():
    """Launches inside compare a kernel with its plain version: K1's, K2's,
    binning's and preprocess's launch and CTA counts are put back on
    leaving."""
    keys = _counter_keys("launches", "ctas")
    saved = {k: tracing.COUNTERS[k] for k in keys}
    try:
        yield
    finally:
        tracing.COUNTERS.update(saved)


def eval_render_vs_plain(name: str, trainer, settings, model, view, proj,
                         campos, tan_fovx=None, tan_fovy=None) -> dict:
    """The compositing of one ``Trainer._render_eval`` call (K1 without
    checkpoints, as ``render_forward`` runs it) against the plain version,
    at the call's settings and model."""
    cfg = trainer.config
    p = activate_params(model.param_dict(), cfg.parameterization)
    bg = torch.tensor(cfg.background_color, dtype=torch.float32,
                      device=trainer.device)
    tx = trainer.tan_fovx if tan_fovx is None else tan_fovx
    ty = trainer.tan_fovy if tan_fovy is None else tan_fovy
    outs = []
    for fwd in (cuda_rasterize.composite_forward,
                rasterize.composite_forward):
        with torch.no_grad():
            (_, _, aux), (_, _, color, dacc, *_) = rasterize._render_fwd(
                settings, tx, ty, cfg.scale_modifier, p["positions"],
                p["scales"], p["rotations"], p["opacities"], p["shs"], view,
                proj, campos, bg, model.alive, 0, fwd)
        outs.append((color, dacc, aux.final_t, aux.n_contrib))
    log(check=f"{name}: settings", pairs=int(aux.num_pairs),
        kept_pairs=int(aux.num_kept), pair_capacity=settings.pair_capacity,
        kept_capacity=settings.kept_capacity, capacity=model.capacity,
        n_alive=int(model.n_alive))
    return compare(f"{name}: K1 vs plain on the card", *outs)


class TrainerProbe:
    """Within ``attached()``, every ``trainer.train_step`` call is recorded
    with its iteration and CUDA events around it, every
    ``Trainer._render_full`` call (an eval or debug render) with CUDA events,
    and every densify event (``Trainer._maybe_densify`` at an iteration of
    the densify schedule) with the host clock between two synchronizes.  The
    functions are put back on leaving.

    With ``check_step``, the first step of that iteration is held against
    the plain compositing at its settings and model before it runs
    (``step_vs_plain``), and so is the first eval render once training has
    passed it (``eval_render_vs_plain``), with their launches uncounted;
    ``checks`` holds their errors and ``check_s`` their host time."""

    def __init__(self, check_step: int | None = None):
        self.steps, self.step_events, self.renders = [], [], []
        self.densify_s = []
        self.check_step, self.checks, self.check_s = check_step, {}, 0.0

    def _check(self, key: str, fn, *args, **kwargs) -> None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with uncounted():
            self.checks[key] = fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.check_s += time.perf_counter() - t0

    @contextlib.contextmanager
    def attached(self):
        step, full = trainer_mod.train_step, trainer_mod.Trainer._render_full
        maybe = trainer_mod.Trainer._maybe_densify
        render_eval = trainer_mod.Trainer._render_eval
        last_eval = []

        def timed(record, fn, *args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            record.append((start, end))
            return out

        def train_step(*args, **kwargs):
            it = args[10]  # the iteration
            if it == self.check_step and "step" not in self.checks:
                settings, cfg, model, _, *view = args[:10]
                self._check("step", step_vs_plain, f"trainer step {it}",
                            settings, cfg, model, *view, **kwargs)
            self.steps.append(it)
            return timed(self.step_events, step, *args, **kwargs)

        def render_eval_args(trainer, *args):
            last_eval[:] = args
            return render_eval(trainer, *args)

        def render_full(trainer, *args, **kwargs):
            out = timed(self.renders, full, trainer, *args, **kwargs)
            if self.check_step is not None \
                    and trainer.iteration > self.check_step \
                    and "eval" not in self.checks:
                self._check("eval", eval_render_vs_plain,
                            f"trainer eval render at {trainer.iteration}",
                            trainer, *last_eval)
            return out

        def maybe_densify(trainer, pos_grads):
            it = trainer.iteration
            if not trainer.densify_due(it):
                return maybe(trainer, pos_grads)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            maybe(trainer, pos_grads)
            torch.cuda.synchronize()
            self.densify_s.append((it, time.perf_counter() - t0))

        trainer_mod.train_step = train_step
        trainer_mod.Trainer._render_full = render_full
        trainer_mod.Trainer._render_eval = render_eval_args
        trainer_mod.Trainer._maybe_densify = maybe_densify
        try:
            yield self
        finally:
            trainer_mod.train_step = step
            trainer_mod.Trainer._render_full = full
            trainer_mod.Trainer._render_eval = render_eval
            trainer_mod.Trainer._maybe_densify = maybe

    def step_ms(self) -> list[float]:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.step_events]

    def render_ms(self) -> list[float]:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.renders]


def lego_capture(root: Path, size: int, device) -> int:
    """Write the Lego capture of phase 12 under ``root``: TRAINER_VIEWS
    orbit views rendered by the port from the trained Lego, its positions
    as the points with colours from their SH DC; check that the port's
    loader reads the cameras back within CAPTURE_TOL.  Returns the number of
    points."""
    params = scenes.lego_params()
    n = params["positions"].shape[0]
    dc = params["shs"].reshape(n, -1, 3)[:, 0]
    rgb = np.round(np.clip(0.5 + SH_C0 * dc, 0.0, 1.0) * 255).astype(np.uint8)
    cams = [scenes.lego_orbit(2 * math.pi * k / TRAINER_VIEWS, size)
            for k in range(TRAINER_VIEWS)]
    p = convert.params_from_numpy(params, device)
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    images = [(torch.clamp(render_view(p, cam, size, bg, device)[0], 0.0, 1.0)
               * 255).round().to(torch.uint8).cpu().numpy() for cam in cams]
    write_colmap_capture(root, cams, images, params["positions"], rgb)
    err = capture_readback_error(root, cams)
    log(check="COLMAP capture read back", views=len(cams), points=n,
        size=size, max_abs_err=err, tol=CAPTURE_TOL)
    if not err <= CAPTURE_TOL:
        raise RuntimeError(f"COLMAP cameras read back {err} from the orbit")
    return n


def _events(out: Path, *names) -> list[dict]:
    with open(out / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    return [r for r in records if r.get("event") in names]


def phase_trainer(device, size: int = SIZE, root: Path = CAPTURE_DIR,
                  train_step_ms=None) -> dict:
    """The third main path: ``python -m gstpu_torch.train``'s ``main`` on
    a COLMAP capture of the Lego; launches counted over the run, then a
    resume from the state at TRAINER_RESUME."""
    steps = TRAINER_STEPS
    log(phase=12, views=TRAINER_VIEWS, size=size, steps=steps,
        flags=list(TRAINER_FLAGS))
    shutil.rmtree(root, ignore_errors=True)
    capture, out = root / "capture", root / "out"
    n_points = lego_capture(capture, size, device)
    argv = ["--dataset", str(capture), "--output", str(out), "--iterations",
            str(steps), *TRAINER_FLAGS]
    if device.type != "cuda":
        argv += ["--device", device.type]

    probe = TrainerProbe(check_step=TRAINER_CHECK_STEP)
    zero_launches()
    t0 = time.perf_counter()
    with probe.attached():
        trainer = train_cli.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    got = launch_counts()

    steps_run = len(probe.steps)
    renders = len(probe.renders)
    step_ms, render_ms = probe.step_ms(), probe.render_ms()
    densify = _events(out, "densify")
    grows = _events(out, "capacity_grow")
    overflows = _events(out, "pair_overflow")
    refits = _events(out, "pair_capacity_grow", "pair_capacity_shrink")
    evals = {tag: [(e["iteration"], e["psnr"], e["ssim"], e["views"])
                   for e in _events(out, tag)]
             for tag in ("eval", "eval_full", "test")}
    losses = np.asarray(trainer.losses)
    first, last = losses[:10], losses[-10:]
    log(path="trainer", launches=got, steps_run=steps_run,
        replayed_steps=steps_run - steps, eval_renders=renders,
        points=n_points, capacity=trainer.model.capacity,
        n_alive=int(trainer.model.n_alive), densify=densify,
        capacity_grows=grows, flushes=trainer.flushes,
        rollbacks=sum(bool(e["rolled_back"]) for e in overflows),
        overflows=overflows, refits=refits,
        first_losses=first.tolist(), last_losses=last.tolist(), evals=evals,
        wall_s=wall_s, check_s=probe.check_s,
        step_ms_median=statistics.median(step_ms),
        step_ms_min=min(step_ms), step_ms_max=max(step_ms),
        phase8_train_step_ms=train_step_ms,
        densify_event_s=probe.densify_s,
        eval_render_ms_median=statistics.median(render_ms),
        kernel_vs_plain=probe.checks)

    problems = []
    if set(probe.checks) != {"step", "eval"}:
        problems.append(f"kernels held against the plain versions at "
                        f"{sorted(probe.checks)}, not at a step and an eval "
                        "render")
    # every forward, a step's, a replay's or an eval render's, preprocesses
    # and bins once
    if got.get("rasterize_bwd") != steps_run \
            or got.get("rasterize_fwd", 0) < steps_run + renders \
            or got.get("binning") != got.get("rasterize_fwd") \
            or got.get("preprocess") != got.get("rasterize_fwd"):
        problems.append(f"launches {got} for {steps_run} steps and "
                        f"{renders} eval renders")
    if not any(e["cloned"] or e["split"] or e["pruned"] for e in densify):
        problems.append(f"no densify event changed the topology: {densify}")
    if not all(e["rolled_back"] for e in overflows):
        problems.append(f"an overflow was not replayed: {overflows}")
    if len(losses) != steps or not np.isfinite(losses).all() \
            or not last.mean() < first.mean():
        problems.append(f"losses: {len(losses)} of {steps}, first 10 mean "
                        f"{first.mean()}, last 10 mean {last.mean()}")
    if not all(evals[t] and all(math.isfinite(e[1]) for e in evals[t])
               for t in evals):
        problems.append(f"evals: {evals}")
    written = [out / "point_cloud" / f"iteration_{steps - 1}" /
               "point_cloud.ply", out / "cameras.json", out / "loss.txt",
               out / f"render_{steps - 1:06d}.png",
               out / "metrics.jsonl", out / "state" / f"{TRAINER_RESUME}.pt",
               out / "state" / f"{steps - 1}.pt"]
    problems += [f"{p} not written" for p in written if not p.is_file()]
    if problems:
        raise RuntimeError(f"trainer: {problems}")

    resume = TrainerProbe()
    with resume.attached():
        resumed = train_cli.main(argv + ["--resume", str(TRAINER_RESUME)])
    with open(out / "loss.txt") as f:
        lines = f.read().split()
    log(path="trainer resume", first_iteration=resume.steps[0],
        steps_run=len(resume.steps), iteration=resumed.iteration,
        loss_lines=len(lines))
    if resume.steps[0] != TRAINER_RESUME + 1 or resumed.iteration != steps \
            or len(lines) != steps \
            or not np.isfinite(np.asarray(lines, float)).all():
        raise RuntimeError("the resume did not go on from "
                           f"{TRAINER_RESUME + 1} to {steps}")
    return got


def _counter_keys(*whats: str) -> list:
    """The registry's keys of ``KERNEL_COUNTERS`` for each of ``whats``."""
    return [f"{k}.{what}" for k in KERNEL_COUNTERS.values() for what in whats
            if f"{k}.{what}" in tracing.COUNTERS]


def launch_counts(what: str = "launches") -> dict:
    """K1's, K2's, binning's and preprocess's launches so far (or, with
    ``"ctas"``, the CTAs that K1 and K2 started), by kernel, from the
    port's counters."""
    return {name: tracing.COUNTERS[f"{k}.{what}"]
            for name, k in KERNEL_COUNTERS.items()
            if f"{k}.{what}" in tracing.COUNTERS}


def zero_launches() -> None:
    """Set K1's, K2's, binning's and preprocess's launch and CTA counts to
    0 (after the card is idle)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    for key in _counter_keys("launches", "ctas"):
        tracing.COUNTERS[key] = 0


def example_vs_plain(size: int, device) -> dict:
    """The example scene at ``size`` through ``render_gaussians`` (K1)
    against the same render with the plain compositing, at K1's
    tolerances; returns the errors."""
    pts, shs, scales, rotations, opacities, cam = \
        render_cli.setup_example_scene(size, size)
    image, depth, aux = render_cli.render_example(size, device)
    settings = RenderSettings(width=size, height=size,
                              pair_capacity=max(default_pair_capacity(3),
                                                int(aux.num_pairs)))
    params = convert.params_from_numpy(
        {"positions": pts, "scales": scales, "rotations": rotations,
         "opacities": opacities.reshape(-1), "shs": shs}, device)
    cam = {**cam, "world_to_camera": cam["view_matrix"]}
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    # in the image's layout: the tiles' pixels past the image's edge are
    # not part of it
    got = (image, depth, rasterize.tiles_to_image(aux.final_t, settings),
           rasterize.tiles_to_image(aux.n_contrib, settings))
    want = [rasterize.tiles_to_image(x, settings)
            for x in plain_outputs(params, cam, settings, bg)]
    return compare(f"example {size}x{size}: K1 vs plain on the card",
                   to_np(got), to_np(want))


def psnr_conventions(ply: Path, capture: Path, device) -> dict:
    """Mean PSNR over the capture's test views of the PLY rendered by
    ``render_forward`` (eval_model's settings), of the image as rendered
    (the Trainer's eval) and clipped to [0, 1] (eval_model's)."""
    from gstpu_torch.ops.losses import psnr
    from gstpu_torch.utils.ply import load_ply, render_space_params

    data = ColmapDataset(str(capture), "test")
    p = render_space_params(load_ply(ply))
    n = p["positions"].shape[0]
    p = {k: np.ascontiguousarray(p[k], np.float32) for k in convert.PARAM_KEYS}
    p["shs"] = p["shs"].reshape(n, 16, 3)
    params = convert.params_from_numpy(p, device)
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    raw, clipped = [], []
    for i in range(len(data)):
        cam = data.camera(i)
        settings = RenderSettings(width=data.width, height=data.height,
                                  pair_capacity=1 << 22, tight_radius=True)
        with uncounted():
            img = render_cull_view(params, cam, settings, bg)[0]
        target = torch.from_numpy(data.image(i)).to(device)
        raw.append(float(psnr(img, target)))
        clipped.append(float(psnr(torch.clamp(img, 0.0, 1.0), target)))
    return {"psnr_as_rendered": float(np.mean(raw)),
            "psnr_clipped": float(np.mean(clipped))}


def phase_clis(device, root: Path = CAPTURE_DIR) -> dict:
    """Phase 13: the render, eval and turntable CLIs on the card, through
    their ``main``s, with K1's launches counted over each; every output held
    against a reference on the card.  Returns the launch counts."""
    log(phase=13)
    out = root / "cli"
    out.mkdir(parents=True, exist_ok=True)
    counts = {}

    zero_launches()
    img8 = render_cli.main(["--out", str(out / "example_render.png")])
    torch.cuda.synchronize()
    counts["render"] = launch_counts()
    with uncounted():
        errs = example_vs_plain(render_cli.EXAMPLE_SIZE, device)
        image = render_cli.render_example(render_cli.EXAMPLE_SIZE, device)[0]
    same_png = bool(np.array_equal(img8, (np.clip(
        image.cpu().numpy(), 0, 1) * 255).astype(np.uint8)))
    log(cli="gstpu_torch.render", launches=counts["render"],
        png=str(out / "example_render.png"), shape=list(img8.shape),
        png_equals_render=same_png, **errs)
    if not (same_png and (out / "example_render.png").is_file()
            and img8.shape == (render_cli.EXAMPLE_SIZE,) * 2 + (3,)
            and counts["render"]["rasterize_fwd"] >= 1):
        raise RuntimeError("the example render CLI failed its checks")

    capture, trained = root / "capture", root / "out"
    ply = trained / "point_cloud" / f"iteration_{TRAINER_STEPS - 1}" \
        / "point_cloud.ply"
    tests = _events(trained, "test")
    zero_launches()
    line = eval_model.main(["--ply", str(ply), "--dataset", str(capture),
                            "--split", "test"])
    torch.cuda.synchronize()
    counts["eval_model"] = launch_counts()
    conventions = psnr_conventions(ply, capture, device)
    trainer_psnr = tests[-1]["psnr"]
    gaps = {"cli_minus_trainer": line["psnr"] - trainer_psnr,
            "as_rendered_minus_trainer":
                conventions["psnr_as_rendered"] - trainer_psnr,
            "clipped_minus_cli": conventions["psnr_clipped"] - line["psnr"]}
    log(cli="gstpu_torch.eval_model", launches=counts["eval_model"],
        line=line, trainer_test_psnr=trainer_psnr, **conventions, gaps=gaps,
        tol_db=EVAL_PSNR_TOL)
    # eval_model's PSNR must be the Trainer's test PSNR; as diagnostics,
    # the Trainer scores the image as rendered, eval_model clipped to [0, 1]
    # (as the JAX package's do), and each must agree with a render of its
    # own convention
    if not (line["views"] == len(ColmapDataset(str(capture), "test"))
            and counts["eval_model"]["rasterize_fwd"] >= line["views"]
            and abs(gaps["cli_minus_trainer"]) < EVAL_PSNR_TOL
            and abs(gaps["as_rendered_minus_trainer"]) < EVAL_PSNR_TOL
            and abs(gaps["clipped_minus_cli"]) < EVAL_PSNR_TOL):
        raise RuntimeError(f"eval_model: {line}, {conventions}, trainer "
                           f"{trainer_psnr}")

    gif = out / "turntable.gif"
    zero_launches()
    frames = render_turntable.main(["--ply", str(scenes.LEGO_PLY), "--out",
                                    str(gif), "--frames",
                                    str(TURNTABLE_FRAMES), "--size",
                                    str(SIZE)])
    torch.cuda.synchronize()
    counts["render_turntable"] = launch_counts()
    with uncounted():
        params = convert.params_from_numpy(scenes.lego_params(), device)
        bg = torch.zeros(3, dtype=torch.float32, device=device)
        want = render_view(params, scenes.lego_orbit(0.0, SIZE), SIZE, bg,
                           device)[0]
    want8 = (torch.clamp(want, 0, 1).cpu().numpy() * 255).astype(np.uint8)
    diff = np.abs(frames[0].astype(int) - want8.astype(int))
    from PIL import Image
    with Image.open(gif) as im:
        n_frames = im.n_frames
    log(cli="gstpu_torch.render_turntable",
        launches=counts["render_turntable"], frames=len(frames),
        gif_frames=n_frames, frame0_max_diff_levels=int(diff.max()),
        frame0_differing_pixels=int((diff > 0).any(-1).sum()))
    if not (len(frames) == n_frames == TURNTABLE_FRAMES
            and counts["render_turntable"]["rasterize_fwd"]
            == TURNTABLE_FRAMES and diff.max() <= 1):
        raise RuntimeError("the turntable CLI failed its checks")
    if any(c["rasterize_bwd"] for c in counts.values()):
        raise RuntimeError(f"a render CLI launched K2: {counts}")
    if any(c["binning"] != c["rasterize_fwd"]
           or c["preprocess"] != c["rasterize_fwd"] for c in counts.values()):
        raise RuntimeError(f"a render CLI's renders did not each preprocess "
                           f"and bin once through the kernels: {counts}")
    return counts


# ---------------------------------------------------------------------------
# Phase 14: the multi-rank path on one card


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_children(commands: list, timeout: float, logs: Path) -> list:
    """Start every command at once (cwd: the checkout), wait for all within
    ``timeout`` seconds, kill every one still running after it; returns
    each one's (exit code, stdout).  Each one's output goes to ``logs``."""
    root = Path(__file__).resolve().parent
    logs.mkdir(parents=True, exist_ok=True)
    procs, files = [], []
    for i, cmd in enumerate(commands):
        out = open(logs / f"rank{i}.out", "w+")
        err = open(logs / f"rank{i}.err", "w+")
        files.append((out, err))
        procs.append(subprocess.Popen(cmd, cwd=root, stdout=out, stderr=err,
                                      text=True))
    deadline = time.monotonic() + timeout
    codes = []
    try:
        for p in procs:
            try:
                codes.append(p.wait(timeout=max(deadline - time.monotonic(),
                                                0.1)))
            except subprocess.TimeoutExpired:
                codes.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for (out, err), code in zip(files, codes):
        out.seek(0)
        err.seek(0)
        text, errors = out.read(), err.read()
        out.close()
        err.close()
        if code != 0:
            print(errors[-4000:], file=sys.stderr, flush=True)
        results.append((code, text))
    return results


GLOO_PROBED = ("all_gather", "all_to_all", "exchange", "all_reduce",
               "reduce_scatter")


def gloo_probe_child(args: dict) -> int:
    """One of two ranks on one card over gloo (run as ``python -c``): runs
    one collective, ``args["collective"]``, on CUDA tensors and saves "ok",
    "wrong" (it ran but gave other values) or the first line of the error.
    A collective that gloo takes but mishandles can kill the process, so
    each runs in a pair of its own."""
    import torch.distributed as dist

    rank = args["rank"]
    device = torch.device(args["device"])
    if device.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://{args['coordinator']}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    other = 1 - rank
    x = torch.arange(4, dtype=torch.float32, device=device) + 10 * rank
    both = torch.cat([torch.arange(4.0), torch.arange(4.0) + 10]).to(device)

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        return torch.cat(parts), both

    def all_to_all():
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out, torch.cat([both[2 * rank:2 * rank + 2],
                               both[4 + 2 * rank:6 + 2 * rank]])

    def exchange():
        got = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, other), dist.P2POp(dist.irecv, got,
                                                             other)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got, both[4 * other:4 * other + 4]

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return y, both[:4] + both[4:]

    def reduce_scatter():
        out = torch.empty_like(x[:2])
        dist.reduce_scatter(out, list(x.clone().chunk(2)))
        s = both[:4] + both[4:]
        return out, s[2 * rank:2 * rank + 2]

    probes = {f.__name__: f for f in (all_gather, all_to_all, exchange,
                                      all_reduce, reduce_scatter)}
    try:
        try:
            got, want = probes[args["collective"]]()
            result = "ok" if torch.equal(got, want) else "wrong"
        except Exception as exc:  # a refusal is the finding
            result = str(exc).splitlines()[0][:200]
        torch.save(result, args["out"])
        return 0
    finally:
        dist.destroy_process_group()


def gloo_probe(device, logs: Path) -> dict:
    """Which collectives gloo takes CUDA tensors for, each from two ranks on
    this card; fails if one that ``parallel/collectives.py`` hands CUDA
    tensors (every transport not in ``collectives.GLOO_HOST_ONLY``) is
    refused."""
    from gstpu_torch.parallel import collectives

    cmds, outs = [], {}
    for name in GLOO_PROBED:
        coordinator = f"127.0.0.1:{free_port()}"
        outs[name] = [logs / f"probe_{name}{r}.pt" for r in range(2)]
        for r in range(2):
            child = dict(rank=r, coordinator=coordinator, collective=name,
                         out=str(outs[name][r]), device=device.type)
            cmds.append([sys.executable, "-c",
                         "import sys, chip_smoke; sys.exit("
                         f"chip_smoke.gloo_probe_child({child!r}))"])
    codes = [c for c, _ in run_children(cmds, 180, logs / "probe")]
    found = {}
    for i, name in enumerate(GLOO_PROBED):
        pair = codes[2 * i:2 * i + 2]
        if pair != [0, 0]:
            found[name] = f"crashed: exit codes {pair}"
            continue
        got = [torch.load(o, weights_only=True) for o in outs[name]]
        found[name] = got[0] if got[0] == got[1] else f"ranks differ: {got}"
    direct = [k for k in collectives.GLOO_TRANSPORTS
              if k not in collectives.GLOO_HOST_ONLY]
    log(path="gloo probe, CUDA tensors", torch=torch.__version__,
        results=found, staged_through_host=sorted(collectives.GLOO_HOST_ONLY),
        sent_direct=direct)
    refused = [k for k in direct if found[k] != "ok"]
    if refused:
        raise RuntimeError(f"gloo fails CUDA tensors for {refused}: {found}")
    return found


def sharded_inputs(capture: Path, path: Path, device) -> dict:
    """Phase 14's step inputs from the phase-12 capture, saved to ``path``
    for the ranks: the default GSConfig's initial model from the capture's
    points at capacity 193,579 rounded up to a multiple of 2, two train
    views (cameras, targets), the trainer's settings at 800x800."""
    cfg = GSConfig()
    data = ColmapDataset(str(capture), "train")
    xyz, rgb = data.points3d()
    cap = int(len(xyz) * cfg.capacity_headroom)
    cap = -(-cap // 2) * 2
    model = init_model_from_points(cfg, xyz, rgb, capacity=cap,
                                   device=device)
    cams = [data.camera(i) for i in range(SHARDED_VIEWS)]
    pair_cap = round_capacity(cap * cfg.pair_capacity_per_gaussian)
    inputs = {
        "model": {f: getattr(model, f).cpu()
                  for f in GaussianModel.__dataclass_fields__},
        "views": torch.stack([torch.from_numpy(np.asarray(
            c["world_to_camera"], np.float32)) for c in cams]),
        "projs": torch.stack([torch.from_numpy(np.asarray(
            c["full_proj_matrix"], np.float32)) for c in cams]),
        "camposes": torch.stack([torch.from_numpy(np.asarray(
            c["camera_center"], np.float32)) for c in cams]),
        "tans": [(float(c["tan_fovx"]), float(c["tan_fovy"])) for c in cams],
        "targets": torch.stack([torch.from_numpy(data.image(i))
                                for i in range(SHARDED_VIEWS)]),
        "size": (data.width, data.height), "pair_capacity": pair_cap}
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, path)
    return inputs


def _inputs_on(inputs: dict, device):
    model = GaussianModel(**{k: x.to(device)
                             for k, x in inputs["model"].items()})
    width, height = inputs["size"]
    settings = train_settings(GSConfig(), width, height,
                              inputs["pair_capacity"],
                              inputs["pair_capacity"])
    return model, settings


def sharded_child(args: dict) -> int:
    """One rank of phase 14's step check (run as ``python -c``): one
    sharded step of the inputs' model on its mesh, with K1 and K2 launches
    counted; K1 on its band (with and without checkpoints) and the step's
    gradients held against the plain compositing at the same band; one
    sharded render.  Saves its results to ``args["out"]``."""
    from gstpu_torch.parallel import collectives, make_mesh
    from gstpu_torch.parallel.multihost import init_distributed, shard_rows
    from gstpu_torch.parallel.sharded import (band_settings, render_sharded,
                                              sharded_loss_and_grads,
                                              target_band)

    rank = args["rank"]
    device = torch.device(args["device"])
    backend = init_distributed(args["coordinator"], args["world"], rank,
                               device=device)
    try:
        mesh = make_mesh(n_data=args["n_data"], n_model=args["n_model"])
        inputs = torch.load(args["inputs"], weights_only=True)
        model, settings = _inputs_on(inputs, device)
        cfg = GSConfig()
        d, m = mesh.coords
        view, proj, campos = (inputs[k][d].to(device)
                              for k in ("views", "projs", "camposes"))
        tx, ty = inputs["tans"][d]
        bset = band_settings(settings, mesh.n_model)
        band = target_band(inputs["targets"][d].to(device), settings,
                           mesh.n_model, m)
        shard = {k: shard_rows(x, mesh)
                 for k, x in model.param_dict().items()}
        alive = shard_rows(model.alive, mesh)

        def step(**kw):
            return sharded_loss_and_grads(settings, cfg, mesh, shard, alive,
                                          view, proj, campos, tx, ty,
                                          band, **kw)

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize()

        step()                                          # warm-up
        zero_launches()
        bytes_before = {k: v for k, v in tracing.COUNTERS.items()
                        if k.startswith("collective.bytes.")}
        t0 = time.perf_counter()
        loss, grads, counts = step()
        sync()
        step_ms = (time.perf_counter() - t0) * 1e3
        got = launch_counts()
        moved = {k: tracing.COUNTERS[k] - v for k, v in bytes_before.items()}
        with uncounted():
            _, grads_plain, _ = step(_compositing=PLAIN_COMPOSITING)
            checks = {"step_vs_plain": check_grads(
                f"rank {rank} {mesh.shape}: sharded step, kernels vs plain "
                "at its band", grads, grads_plain, flip_tolerant=True)}
            live = {k: x[:int(model.n_alive)]
                    for k, x in model.param_dict().items()}
            cam = {"world_to_camera": inputs["views"][d].numpy(),
                   "full_proj_matrix": inputs["projs"][d].numpy(),
                   "camera_center": inputs["camposes"][d].numpy(),
                   "tan_fovx": tx, "tan_fovy": ty}
            prep, pairs = prep_and_pairs(live, cam, bset, row0=m)
            checks["k1_band"] = kernel_vs_plain(
                f"rank {rank}: K1 on band {m}::{mesh.n_model}", prep, pairs,
                bset, row0=m)
            if device.type == "cuda":  # the plain version makes none
                checks["k1_checkpoints_band"] = k1_checkpoint_checks(
                    f"rank {rank}: band {m}::{mesh.n_model}", prep, pairs,
                    bset, row0=m)
            bg = torch.zeros(3, dtype=torch.float32, device=device)
            frame = render_sharded(settings, mesh, model.param_dict(),
                                   model.alive, view, proj, campos, bg, tx,
                                   ty)
        whole = collectives.all_gather_many(list(grads.values()), mesh.model)
        torch.save({"rank": rank, "coords": mesh.coords, "backend": backend,
                    "loss": float(loss), "counts": counts.cpu().tolist(),
                    "grads": {k: x.cpu() for k, x in zip(grads, whole)},
                    "launches": got, "step_ms": step_ms,
                    "collective_bytes": moved,
                    "band_pairs": int(pairs.num_pairs),
                    "band_tiles": bset.band_tiles,
                    "frame": {k: x.cpu() for k, x in frame.items()},
                    "checks": checks}, args["out"])
        return 0
    finally:
        if backend is not None:
            torch.distributed.destroy_process_group()


def sharded_step_check(inputs: dict, inputs_path: Path, device, n_data: int,
                       n_model: int, logs: Path) -> dict:
    """Phase 14's step check on one mesh: spawn its ranks on this card,
    then hold their loss and gathered gradients against the single-process
    ``loss_and_grads`` (the mean over the batch's cameras) and their
    sharded render against the single-process render."""
    world = n_data * n_model
    coordinator = f"127.0.0.1:{free_port()}"
    outs = [logs / f"rank{r}.pt" for r in range(world)]
    child_args = [dict(rank=r, world=world, n_data=n_data, n_model=n_model,
                       coordinator=coordinator, inputs=str(inputs_path),
                       out=str(outs[r]), device=device.type)
                  for r in range(world)]
    cmds = [[sys.executable, "-c",
             "import sys, chip_smoke; sys.exit(chip_smoke.sharded_child("
             f"{child_args[r]!r}))"] for r in range(world)]
    t0 = time.perf_counter()
    results = run_children(cmds, SHARDED_TIMEOUT_S, logs)
    wall_s = time.perf_counter() - t0
    codes = [c for c, _ in results]
    if codes != [0] * world:
        raise RuntimeError(f"sharded step {n_data}x{n_model}: exit codes "
                           f"{codes}")
    ranks = [torch.load(o, weights_only=True) for o in outs]

    model, settings = _inputs_on(inputs, device)
    cfg = GSConfig()
    losses, grads = [], None
    for d in range(n_data):
        tx, ty = inputs["tans"][d]
        loss, g, _ = loss_and_grads(
            settings, cfg, model, inputs["views"][d].to(device),
            inputs["projs"][d].to(device), inputs["camposes"][d].to(device),
            tx, ty, inputs["targets"][d].to(device))
        losses.append(float(loss))
        grads = g if grads is None else {k: grads[k] + g[k] for k in g}
    want_loss = float(np.mean(losses))
    want = {k: (x / n_data).cpu() for k, x in grads.items()}
    name = f"sharded step {n_data}x{n_model}"
    for r in ranks:
        rel = abs(r["loss"] - want_loss) / abs(want_loss)
        log(check=f"{name}: rank {r['rank']} {r['coords']} loss",
            loss=r["loss"], loss_single=want_loss, rel=rel)
        if not rel < LOSS_REL_TOL:
            raise RuntimeError(f"{name}: loss differs by {rel} relative")
        check_grads(f"{name}: rank {r['rank']} gathered gradients vs the "
                    "single-process step", r["grads"], want,
                    flip_tolerant=True)
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    tx, ty = inputs["tans"][0]
    with torch.no_grad(), uncounted():
        p = model.param_dict()  # the raw scheme: stored = render space
        image, depth, aux = rasterize.render_forward(
            settings, tx, ty, 1.0, p["positions"], p["scales"],
            p["rotations"], p["opacities"], p["shs"],
            inputs["views"][0].to(device), inputs["projs"][0].to(device),
            inputs["camposes"][0].to(device), bg, model.alive)
    want_frame = (image, depth,
                  rasterize.tiles_to_image(aux.final_t, settings),
                  rasterize.tiles_to_image(aux.n_contrib, settings))
    frame_errs = {}
    for r in ranks:
        if r["coords"][0] == 0:
            f = r["frame"]
            frame_errs[r["rank"]] = compare(
                f"{name}: rank {r['rank']}'s interleaved bands vs the "
                "single-process render",
                to_np((f["image"], f["depth"], f["final_t"],
                       f["n_contrib"])), to_np(want_frame))
    line = {"mesh": {"data": n_data, "model": n_model},
            "backend": ranks[0]["backend"], "ranks": world,
            "wall_s": wall_s,
            "step_ms_per_rank": [r["step_ms"] for r in ranks],
            "collective_bytes_per_step_per_rank": [r["collective_bytes"]
                                                   for r in ranks],
            "band_pairs": [r["band_pairs"] for r in ranks],
            "launches_per_rank": [r["launches"] for r in ranks],
            "checks_per_rank": [r["checks"] for r in ranks],
            "note": "ranks share one card over gloo; collectives are "
                    "transport through host memory and say nothing of "
                    "NVLink scaling"}
    log(path=name, **line)
    if any(r["launches"] != dict.fromkeys(KERNEL_COUNTERS, 1)
           for r in ranks):
        raise RuntimeError(f"{name}: launches in one step per rank "
                           f"{line['launches_per_rank']}, not one "
                           "preprocess, one binning, one K1 and one K2 each")
    return {"launches": [r["launches"] for r in ranks],
            "k1_band_color_err": max(r["checks"]["k1_band"]["color_err"]
                                     for r in ranks),
            "step_vs_plain": [r["checks"]["step_vs_plain"] for r in ranks],
            "frame": frame_errs}


def sharded_training(capture: Path, out: Path, logs: Path, device) -> dict:
    """Phase 14's training run: ``python -m gstpu_torch.train`` as 2 x 2
    ranks on this card, SHARDED_TRAIN_STEPS steps with a densify event at
    20; checks every rank's exit code, launches and densify digest, and
    rank 0's outputs."""
    shutil.rmtree(out, ignore_errors=True)
    world = 4
    coordinator = f"127.0.0.1:{free_port()}"
    cmds = [[sys.executable, "-m", "gstpu_torch.train", "--dataset",
             str(capture), "--output", str(out), "--iterations",
             str(SHARDED_TRAIN_STEPS), *SHARDED_TRAIN_FLAGS, "--n-model", "2",
             "--n-data", "2", "--coordinator", coordinator,
             "--num-processes", str(world), "--process-id", str(r)]
            + (["--device", device.type] if device.type != "cuda" else [])
            for r in range(world)]
    t0 = time.perf_counter()
    results = run_children(cmds, SHARDED_TIMEOUT_S, logs)
    wall_s = time.perf_counter() - t0
    codes = [c for c, _ in results]
    if codes != [0] * world:
        raise RuntimeError(f"sharded training: exit codes {codes}")
    runs = [json.loads(text.strip().splitlines()[-1]) for _, text in results]
    with open(out / "loss.txt") as f:
        losses = np.asarray(f.read().split(), float)
    densify = _events(out, "densify")
    evals = _events(out, "eval", "eval_full", "test")
    line = {"backend": runs[0]["backend"], "ranks": world,
            "mesh": runs[0]["mesh"], "wall_s": wall_s,
            "steps_run": [r["steps_run"] for r in runs],
            "step_ms_median_per_rank": [r["step_ms_median"] for r in runs],
            "collective_bytes_per_step_per_rank": [
                {k: v / r["steps_run"] for k, v in r["counters"].items()
                 if k.startswith("collective.bytes.")} for r in runs],
            "launches_per_rank": [
                {name: r["counters"][f"{k}.launches"]
                 for name, k in KERNEL_COUNTERS.items()} for r in runs],
            "densify_digests": [r["densify_digests"] for r in runs],
            "densify": densify, "evals": evals,
            "first_losses": losses[:5].tolist(),
            "last_losses": losses[-5:].tolist(),
            "note": "ranks share one card over gloo; collectives are "
                    "transport through host memory and say nothing of "
                    "NVLink scaling; step ms from CUDA events around each "
                    "step"}
    log(path="sharded training", **line)
    problems = []
    for r in runs:
        k1, k2, bins, preps = (r["counters"][f"{k}.launches"]
                               for k in ("k1", "k2", "binning", "preprocess"))
        if k2 != r["steps_run"] or (k1 != r["steps_run"] if r["rank"]
                                    else k1 < r["steps_run"]) \
                or bins != k1 or preps != k1:
            problems.append(f"rank {r['rank']}: launches {k1} / {k2}, "
                            f"binning {bins}, preprocess {preps}, for "
                            f"{r['steps_run']} steps")
        if r["iteration"] != SHARDED_TRAIN_STEPS:
            problems.append(f"rank {r['rank']} ended at {r['iteration']}")
    digests = [r["densify_digests"] for r in runs]
    if not (digests[0] and all(d == digests[0] for d in digests)
            and [it for it, _ in digests[0]] == [SHARDED_DENSIFY_AT]):
        problems.append(f"densify digests differ or are missing: {digests}")
    if len(losses) != SHARDED_TRAIN_STEPS or not np.isfinite(losses).all():
        problems.append(f"losses: {losses}")
    last = SHARDED_TRAIN_STEPS - 1
    written = [out / "point_cloud" / f"iteration_{last}" / "point_cloud.ply",
               out / "cameras.json", out / "metrics.jsonl",
               out / "state" / f"{last}.pt"]
    problems += [f"{p} not written" for p in written if not p.is_file()]
    if problems:
        raise RuntimeError(f"sharded training: {problems}")
    return {"launches": line["launches_per_rank"],
            "steps_run": line["steps_run"]}


def phase_multirank(device, root: Path = CAPTURE_DIR) -> dict:
    """Phase 14: the multi-rank path as ranks that share this one card over
    gloo, on the phase-12 capture at full width."""
    log(phase=14, meshes=SHARDED_MESHES, steps=SHARDED_TRAIN_STEPS)
    capture, base = root / "capture", root / "multirank"
    inputs_path = base / "inputs.pt"
    gloo_probe(device, base)
    inputs = sharded_inputs(capture, inputs_path, device)
    out = {}
    for n_data, n_model in SHARDED_MESHES:
        out[f"{n_data}x{n_model}"] = sharded_step_check(
            inputs, inputs_path, device, n_data, n_model,
            base / f"step_{n_data}x{n_model}")
    out["training"] = sharded_training(capture, base / "train_out",
                                       base / "train", device)
    return out


# Phase 15, binning: the shapes of the benchmark's mip360-view cell (2.96M
# Gaussians at 1237x822, 78 x 52 tiles, 32.8M pair slots) from seeded
# inputs (``binning_inputs``), without and with the training step's pair
# cull and kept capacity.
BINNING_GAUSSIANS = 2_960_000
BINNING_SIZE = (1237, 822)
BINNING_CAPACITY = 32_833_536
BINNING_SEED = 14
BINNING_FUNCTIONS = ("gstpu_binning_duplicate", "gstpu_binning_sort",
                     "gstpu_binning_finish")


def binning_inputs(seed: int, n: int, grid_x: int, grid_y: int, device,
                   side: float = 1.86, hidden: float = 0.1,
                   tied: float = 0.25) -> dict:
    """Seeded ``build_pairs`` inputs for n Gaussians on a grid_x x grid_y
    tile grid: rect sides 1 + Poisson(side) tiles (7.3 pairs a visible
    Gaussian at 1.86), a share ``hidden`` with no tiles (rect and depth 0,
    as preprocess leaves them), depths uniform in [0.2, 60) of which a share
    ``tied`` takes one of 16 values, splat centers near their rect's
    centre, cull thresholds up to about the rect's squared half-diagonal
    (some inf)."""
    rng = np.random.default_rng(seed)
    w = np.minimum(1 + rng.poisson(side, n), grid_x)
    h = np.minimum(1 + rng.poisson(side, n), grid_y)
    x0 = rng.integers(0, grid_x - w + 1)
    y0 = rng.integers(0, grid_y - h + 1)
    rect = np.stack([x0, y0, x0 + w, y0 + h], axis=1).astype(np.int32)
    hide = rng.random(n) < hidden
    rect[hide] = 0
    tiles = ((rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])).astype(
        np.int32)
    depth = rng.uniform(0.2, 60.0, n).astype(np.float32)
    tie = rng.random(n) < tied
    depth[tie] = rng.choice(np.arange(1, 17, dtype=np.float32), tie.sum())
    depth[hide] = 0.0
    centre = (rect[:, :2] + rect[:, 2:]) * 8.0
    xy = (centre + rng.normal(0.0, 4.0, (n, 2))).astype(np.float32)
    xy[hide] = 0.0
    tcut = (64.0 * (w * w + h * h) * rng.uniform(0.15, 1.0, n)).astype(
        np.float32)
    tcut[rng.random(n) < 0.05] = np.inf

    def t(x):
        return torch.as_tensor(x, device=device)

    return dict(tiles_touched=t(tiles), rect=t(rect), depth=t(depth),
                cull_xy=t(xy), cull_tcut=t(tcut))


def pairs_equal(got, want) -> list:
    """The fields of two ``Pairs`` that differ in dtype, shape or any
    element (none: bit for bit the same)."""
    return [f for f, a, b in zip(got._fields, got, want)
            if a.dtype != b.dtype or a.shape != b.shape
            or not torch.equal(a, b)]


def ptxas_facts(build_log: str, kernel: str) -> list:
    """ptxas's lines on registers, shared memory and spills of the kernel
    whose mangled name holds ``kernel``."""
    lines, found = [], False
    for line in build_log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            found = kernel in line
        if found and ("Used" in line or "spill" in line):
            lines.append(line.split("ptxas info    :")[-1].strip())
    return lines


def phase_binning(device, seed: int = BINNING_SEED) -> dict:
    """Phase 15: the binning kernels (csrc/binning.cu) at mip360-view's
    shapes, against the plain ``binning.build_pairs`` on the card (every
    field bit for bit), without and with the pair cull; the bare times of
    the duplicate kernel, the sort and the finish kernel, each beside its
    byte bound, CUB's sort beside ``torch.sort`` of the same int64 keys, the
    whole wrapper beside the plain version; ptxas's registers and spills."""
    log(phase=15, gaussians=BINNING_GAUSSIANS, size=BINNING_SIZE,
        capacity=BINNING_CAPACITY, seed=seed)
    settings = RenderSettings(width=BINNING_SIZE[0], height=BINNING_SIZE[1],
                              pair_capacity=BINNING_CAPACITY)
    inp = binning_inputs(seed, BINNING_GAUSSIANS, settings.grid_x,
                         settings.grid_y, device)
    base = (inp["tiles_touched"], inp["rect"], inp["depth"], settings.grid_x,
            settings.num_tiles, BINNING_CAPACITY)
    probe = binning.build_pairs(*base, cull_xy=inp["cull_xy"],
                                cull_tcut=inp["cull_tcut"])
    kept = int(probe.num_kept)
    del probe
    forms = {"view": {},
             "train": dict(cull_xy=inp["cull_xy"], cull_tcut=inp["cull_tcut"],
                           kept_capacity=min(BINNING_CAPACITY,
                                             round_capacity(kept * 1.05)))}
    _, build_log, _ = cuda_build.build()["binning"]
    sass = {k: ptxas_facts(build_log, k)
            for k in ("duplicate_kernel", "finish_kernel")}
    out = {}
    for form, kw in forms.items():
        want = binning.build_pairs(*base, **kw)
        before = tracing.COUNTERS["binning.launches"]
        got = build_pairs(*base, **kw)
        torch.cuda.synchronize()
        if tracing.COUNTERS["binning.launches"] != before + 1:
            raise RuntimeError("binning: one wrapper call, not one launch")
        differ = pairs_equal(got, want)
        again = pairs_equal(build_pairs(*base, **kw), got)
        total, kept_pairs = int(want.num_pairs), int(want.num_kept)
        del want, got
        log(check=f"binning {form}: kernels against the plain version",
            differ=differ, rerun_differ=again, pairs=total, kept=kept_pairs)
        if differ or again:
            raise RuntimeError(f"binning {form}: {differ or again} differ")

        def call():
            return build_pairs(*base, **kw)

        k, k2 = BINNING_CAPACITY, kw.get("kept_capacity", BINNING_CAPACITY)
        n = BINNING_GAUSSIANS
        cull = "cull_xy" in kw
        end_bit = 32 + settings.num_tiles.bit_length()
        filled = min(total, k)
        nbytes = {
            "gstpu_binning_duplicate": n * (36 + 12 * cull) + filled * 16
            + (k - filled) * 12,
            "gstpu_binning_sort": k * 8 + math.ceil(end_bit / 8) * k * 24,
            "gstpu_binning_finish": k * 8 + k2 * 20 + (k - k2) * 8 * cull}
        lib = cuda_binning._library()
        parts = {}
        for fname in BINNING_FUNCTIONS:
            parts[fname] = {
                "bare_ms": bare_ms(lib, fname, call),
                "bytes": nbytes[fname],
                "bound_ms": nbytes[fname] / PEAK_BYTES_PER_S * 1e3}
        keys = cuda_binning.duplicate(
            *base[:5], k, kw.get("cull_xy"), kw.get("cull_tcut"), 0, 1)[1][0]
        torch_sort_ms = time_ms(lambda: torch.sort(keys, stable=True), 10)
        del keys
        wrapper_ms = time_ms(call, 20)
        plain_ms = time_ms(lambda: binning.build_pairs(*base, **kw), 5,
                           warmup=1)
        bound_ms = sum(p["bound_ms"] for p in parts.values())
        out[form] = dict(parts=parts, torch_sort_ms=torch_sort_ms,
                         wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, pairs=total, kept=kept_pairs,
                         kept_capacity=k2, end_bit=end_bit)
        log(binning=form, **out[form], sass=sass)
    return out


# Phase 16, preprocess: the kernel of csrc/preprocess.cu at the shapes of
# the benchmark's mip360-view cell (2.96M Gaussians at 1237x822, SH degree
# 3) from seeded inputs (``preprocess_inputs``), without and with an alive
# mask.  Bytes a Gaussian: means 12, scales 12, rotation 16 and opacity 4
# read; the SH row (16 x 3 floats) read; PreprocessOut's 101 written; the
# alive mask's 1 read where there is one.
PREPROCESS_SEED = 16
PREP_READ_BYTES = 44
PREP_SH_BYTES = 192
PREP_WRITE_BYTES = 101


def preprocess_inputs(seed: int, n: int, width: int, height: int, device,
                      alive_share: float | None = None):
    """Seeded (args, kwargs) of ``preprocess`` for n Gaussians at SH degree
    3 seen by a width x height camera (horizontal field of view 64 degrees)
    on an orbit of radius 4 at height 1, looking at the origin: 55% of the
    Gaussians in a ball of radius 2 about the origin, 20% on a ground disc
    of radius 6 at height -1, 25% on a shell of radius 14; scales
    log-uniform in [0.003, 0.1], uniformly random rotations, opacities in
    [0.02, 0.99], SH DC N(0, 0.5^2) and the higher orders N(0, 0.05^2); with
    ``alive_share`` an alive mask of that share."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    n_ball, n_ground = int(n * 0.55), int(n * 0.2)
    n_shell = n - n_ball - n_ground
    ball = randn(n_ball, 3)
    ball *= 2.0 * rand(n_ball, 1) ** (1 / 3) / ball.norm(dim=1, keepdim=True)
    angle, radius = 2 * math.pi * rand(n_ground), 6.0 * rand(n_ground).sqrt()
    ground = torch.stack([radius * angle.cos(), radius * angle.sin(),
                          torch.full_like(angle, -1.0)], 1)
    shell = randn(n_shell, 3)
    shell *= 14.0 / shell.norm(dim=1, keepdim=True)
    means = torch.cat([ball, ground, shell])
    scales = torch.exp(math.log(0.003) + math.log(0.1 / 0.003)
                       * rand(n, 3))
    q = randn(n, 4)
    rotations = q / q.norm(dim=1, keepdim=True)
    opacities = 0.02 + 0.97 * rand(n)
    shs = 0.05 * randn(n, 16, 3)
    shs[:, 0] = 0.5 * randn(n, 3)
    theta = 2 * math.pi * float(rand(1))
    eye = np.array([4.0 * math.cos(theta), 4.0 * math.sin(theta), 1.0])
    cam = load_camera({"camera_id": 0, "camera_to_world": look_at_c2w(eye),
                       "width": width, "height": height,
                       "focal": 0.5 * width / math.tan(math.radians(32.0))})
    view, proj, campos = camera_tensors(cam, device)
    kw = {}
    if alive_share is not None:
        kw["alive"] = rand(n) < alive_share
    grid_x, grid_y = -(-width // TILE_X), -(-height // TILE_Y)
    return (means, scales, rotations, opacities, shs, view, proj, campos,
            width, height, cam["tan_fovx"], cam["tan_fovy"], grid_x, grid_y,
            3), kw


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """float32 bits as int64 in the floats' order (-0 and +0 both 0)."""
    i = _bits(x).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def prep_diff(got, want) -> dict:
    """For each field of two ``PreprocessOut``: the elements that differ
    (a float's bits, except that a NaN matches any NaN) and, for float
    fields, the largest distance in units in the last place; a field whose
    dtype or shape differs gets ``None``."""
    out = {}
    for f, a, b in zip(got._fields, got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            out[f] = None
            continue
        if not a.is_floating_point():
            out[f] = {"differ": int((a != b).sum())}
            continue
        both_nan = torch.isnan(a) & torch.isnan(b)
        ulps = (_ordered(a) - _ordered(b)).abs().masked_fill(both_nan, 0)
        same = (_bits(a) == _bits(b)) | both_nan
        out[f] = {"differ": int((~same).sum()), "max_ulps": int(ulps.max())}
    return out


def differing(diff: dict) -> list:
    """The fields of a ``prep_diff`` that differ."""
    return [f for f, d in diff.items() if d is None or d["differ"]]


def prep_equal(got, want) -> list:
    """The fields of two ``PreprocessOut`` that differ in dtype, shape or
    any element (a float's bits; a NaN matches any NaN): none when the two
    are bit for bit the same."""
    return differing(prep_diff(got, want))


def phase_preprocess(device, seed: int = PREPROCESS_SEED) -> dict:
    """Phase 16: the preprocess kernel (csrc/preprocess.cu) at
    mip360-view's shapes against the plain ``ops/preprocess.py::preprocess``
    on the card (every field bit for bit, twice), without and with an alive
    mask, one ``preprocess.launches`` a call; the bare and wrapper times
    beside the byte bound (every input row read) and the bound of what the
    visible Gaussians need (the SH rows of those alone), the plain
    version's time; ptxas's registers and spills."""
    width, height = BINNING_SIZE
    n = BINNING_GAUSSIANS
    log(phase=16, gaussians=n, size=BINNING_SIZE, seed=seed)
    _, build_log, _ = cuda_build.build()["preprocess"]
    sass = ptxas_facts(build_log, "preprocess_kernel")
    lib = cuda_preprocess._library()
    out = {}
    for form, share in (("view", None), ("train", 0.95)):
        args, kw = preprocess_inputs(seed, n, width, height, device, share)
        want = preprocess(*args, **kw)
        before = tracing.COUNTERS["preprocess.launches"]
        got = cuda_preprocess.preprocess(*args, **kw)
        torch.cuda.synchronize()
        if tracing.COUNTERS["preprocess.launches"] != before + 1:
            raise RuntimeError("preprocess: one wrapper call, not one launch")
        diff = prep_diff(got, want)
        again = prep_equal(cuda_preprocess.preprocess(*args, **kw), got)
        visible = int(want.visible.sum())
        del want, got
        log(check=f"preprocess {form}: kernel against the plain version",
            diff=diff, rerun_differ=again, visible=visible)
        if differing(diff) or again:
            raise RuntimeError(f"preprocess {form}: {diff}, {again} differ")

        def call():
            return cuda_preprocess.preprocess(*args, **kw)

        mask = n if share is not None else 0
        nbytes = n * (PREP_READ_BYTES + PREP_SH_BYTES + PREP_WRITE_BYTES) \
            + mask
        need = n * (PREP_READ_BYTES + PREP_WRITE_BYTES) \
            + visible * PREP_SH_BYTES + mask
        bare = bare_ms(lib, "gstpu_preprocess", call)
        out[form] = dict(
            bare_ms=bare, wrapper_ms=time_ms(call, 20),
            plain_ms=time_ms(lambda: preprocess(*args, **kw), 5, warmup=1),
            bytes=nbytes, bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
            visible=visible, visible_bytes=need,
            visible_bound_ms=need / PEAK_BYTES_PER_S * 1e3)
        out[form]["bound_pct"] = 100 * out[form]["bound_ms"] / bare
        log(preprocess=form, **out[form], sass=sass)
        del args, kw
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--previous", type=Path, default=None,
        help="a directory holding the parent commit's rasterize_fwd.cu, "
        "rasterize_bwd.cu, composite_common.cuh, sol_compositing.cu, "
        "cuda_rasterize.py and sol_model.py: build its kernels, time them "
        "and its wrappers in turns with this tree's (previous_ms, "
        "previous_wrapper_ms), check that K1's outputs are bit-identical and "
        "report how far K3's moved")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    phase_build()
    previous = PreviousKernels(args.previous) if args.previous else None
    params = convert.params_from_numpy(scenes.lego_params(), device)
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    k1_err = phase_kernel_checks(params, SIZE, device, previous)
    phase_main_path(params, SIZE, device, bg)
    k1_times = phase_timing(params, SIZE, device, bg, previous)
    k2_errs = phase_k2_checks(params, SIZE, device)
    run = TrainRun(SIZE, device)
    main_path = phase_train(run)
    launches, ctas = main_path["launches"], main_path["ctas"]
    work_items = main_path["work_items"]
    phase_step_vs_plain(run)
    k2_times = phase_train_timing(run, previous)
    train_step_ms = k2_times.pop("train_step_ms")
    del run
    k3_errs = phase_k3_checks(device, previous)
    sol, k3_times = phase_sol(device, previous)
    phase_bench(device, sol)
    trainer_launches = phase_trainer(device, train_step_ms=train_step_ms)
    cli_launches = phase_clis(device)
    multirank = phase_multirank(device)
    binning_times = phase_binning(device)
    preprocess_times = phase_preprocess(device)
    kernels = [
        {"name": "rasterize_fwd (K1)", "route": "cuda",
         "source": "gstpu_torch/csrc/rasterize_fwd.cu",
         "replaces": "gstpu/ops/pallas_rasterize.py:160",
         "launches": launches["rasterize_fwd"],
         "trainer_launches": trainer_launches["rasterize_fwd"],
         "cli_launches": {k: c["rasterize_fwd"]
                          for k, c in cli_launches.items()},
         "sharded_step_launches": {
             m: [r["rasterize_fwd"] for r in v["launches"]]
             for m, v in multirank.items() if m != "training"},
         "sharded_training_launches": [
             r["rasterize_fwd"] for r in multirank["training"]["launches"]],
         "sharded_training_steps": multirank["training"]["steps_run"],
         "band_max_abs_err": max(v["k1_band_color_err"]
                                 for m, v in multirank.items()
                                 if m != "training"),
         "ctas": ctas["rasterize_fwd"],
         "work_items": work_items["rasterize_fwd"], "max_abs_err": k1_err,
         **k1_times, "library_ms": None},
        {"name": "rasterize_bwd (K2)", "route": "cuda",
         "source": "gstpu_torch/csrc/rasterize_bwd.cu",
         "replaces": "gstpu/ops/pallas_rasterize.py:442",
         "launches": launches["rasterize_bwd"],
         "trainer_launches": trainer_launches["rasterize_bwd"],
         "sharded_step_launches": {
             m: [r["rasterize_bwd"] for r in v["launches"]]
             for m, v in multirank.items() if m != "training"},
         "sharded_training_launches": [
             r["rasterize_bwd"] for r in multirank["training"]["launches"]],
         "sharded_training_steps": multirank["training"]["steps_run"],
         "ctas": ctas["rasterize_bwd"],
         "work_items": work_items["rasterize_bwd"], **k2_errs,
         **k2_times, "library_ms": None}]
    for form in ("sol_compositing_fwd", "sol_compositing_bwd"):
        abs_err, rel_err = k3_errs[form]
        kernels.append(
            {"name": f"{form} (K3)", "route": "cuda",
             "source": "gstpu_torch/csrc/sol_compositing.cu",
             "replaces": "scripts/sol_model.py:80", "max_abs_err": abs_err,
             "max_rel_err": rel_err, **k3_times[form], "library_ms": None})
    kernels.append(
        {"name": "binning (duplicate, sort, finish)", "route": "cuda",
         "source": "gstpu_torch/csrc/binning.cu", "replaces": None,
         "launches": launches["binning"],
         "trainer_launches": trainer_launches["binning"],
         "cli_launches": {k: c["binning"] for k, c in cli_launches.items()},
         "sharded_step_launches": {
             m: [r["binning"] for r in v["launches"]]
             for m, v in multirank.items() if m != "training"},
         "sharded_training_launches": [
             r["binning"] for r in multirank["training"]["launches"]],
         **binning_times, "library_ms": None})
    kernels.append(
        {"name": "preprocess", "route": "cuda",
         "source": "gstpu_torch/csrc/preprocess.cu", "replaces": None,
         "launches": launches["preprocess"],
         "trainer_launches": trainer_launches["preprocess"],
         "cli_launches": {k: c["preprocess"]
                          for k, c in cli_launches.items()},
         "sharded_step_launches": {
             m: [r["preprocess"] for r in v["launches"]]
             for m, v in multirank.items() if m != "training"},
         "sharded_training_launches": [
             r["preprocess"] for r in multirank["training"]["launches"]],
         **preprocess_times, "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
