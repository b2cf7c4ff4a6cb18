"""Training: one single-device step, and the loop around it.

Port of ``gstpu/trainer.py``.

- ``train_step`` (``Trainer._train_step``): activate the stored parameters,
  render through the differentiable ``render``, take the loss,
  back-propagate through the hand-written backward (kernel K2 on the card),
  then one Adam step with the scheduled learning rates.
- ``Trainer``: the loop.  A NeRF-synthetic or COLMAP dataset, its targets
  and cameras on the device; deferred loss and pair-count fetches every
  ``flush_interval`` steps, with a rollback and replay of a window whose
  pair list overflowed; densification events (``densify.py``) with a
  capacity regrow; evaluation (PSNR, SSIM); the PLY, ``cameras.json``,
  ``loss.txt``, ``metrics.jsonl`` and a resumable state (``torch.save``).

The device decides the compositing: K1 and K2 on a CUDA device, their plain
versions on the CPU.

With a ``mesh`` (``parallel.make_mesh``, one process per rank), every step
is the sharded step of ``parallel/sharded.py``: the parameters and Adam
moments split over ``model``, the tile rows banded over ``model``, a batch
of ``n_data`` cameras per step summed over ``data``.  Every rank draws the
same cameras and takes the same decisions (flush, rollback, refit, densify)
from all-reduced losses and counts; a densify event gathers the model,
runs on every rank with the same noise generator, checks that the ranks
agree and shards the result again.  Rank 0 alone evaluates and writes the
PLY, ``cameras.json``, ``loss.txt``, ``metrics.jsonl``, the debug images and
the state; the others wait at a barrier.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from gstpu_torch import densify as densify_mod
from gstpu_torch.config import GSConfig, RenderSettings
from gstpu_torch.data.colmap import ColmapDataset, is_colmap_dataset
from gstpu_torch.data.nerf import NerfSyntheticDataset
from gstpu_torch.models.gaussians import (GaussianModel, activate_params,
                                          grow_capacity, init_model,
                                          init_model_from_points)
from gstpu_torch.ops.losses import combined_loss, depth_loss, psnr, ssim
from gstpu_torch.ops.rasterize import render, render_forward
from gstpu_torch.optim import (AdamState, adam_step, init_adam_state,
                               schedule_lrs)
from gstpu_torch.parallel import collectives
from gstpu_torch.parallel.multihost import shard_rows
from gstpu_torch.render import resolve_device
from gstpu_torch.utils import tracing
from gstpu_torch.utils.camera import save_cameras_json
from gstpu_torch.utils.image import imwrite
from gstpu_torch.utils.ply import save_ply


def round_capacity(pairs: float) -> int:
    """Pair capacity: the requested pairs rounded up to a multiple of 32768,
    at least 16384 (every capacity-sized stage pays for the slack)."""
    return max(-(-int(pairs) // 32768) * 32768, 1 << 14)


def train_settings(config: GSConfig, width: int, height: int,
                   pair_capacity: int, kept_capacity: int,
                   iteration: int | None = None,
                   pair_cull: bool = True) -> RenderSettings:
    """Render settings of a training step: tight radii, the exact pair cull
    and the two-tier kept capacity, with the SH degree warm-up when
    ``config.sh_degree_interval`` is set."""
    degree = config.sh_degree
    if config.sh_degree_interval and iteration is not None:
        degree = min(config.sh_degree, iteration // config.sh_degree_interval)
    return RenderSettings(width=width, height=height, sh_degree=degree,
                          pair_capacity=pair_capacity, tight_radius=True,
                          pair_cull=pair_cull,
                          kept_capacity=min(kept_capacity, pair_capacity))


def loss_and_grads(settings: RenderSettings, config: GSConfig,
                   model: GaussianModel, view: torch.Tensor,
                   proj: torch.Tensor, campos: torch.Tensor, tan_fovx: float,
                   tan_fovy: float, target: torch.Tensor,
                   target_depth: torch.Tensor | None = None,
                   depth_mask: torch.Tensor | None = None,
                   _compositing=None):
    """The loss of one view and its gradient with respect to every stored
    parameter group: ``(loss, {group: gradient}, RenderAux)``.

    The loss is ``combined_loss`` plus ``lambda_depth * depth_loss`` when a
    depth target is given.  ``_compositing`` is passed on to ``render``
    (for checks of the kernels against their plain versions).
    """
    bg = torch.tensor(config.background_color, dtype=torch.float32,
                      device=target.device)
    params = {k: x.detach().requires_grad_(True)
              for k, x in model.param_dict().items()}
    p = activate_params(params, config.parameterization)
    image, depth, aux = render(
        settings, tan_fovx, tan_fovy, config.scale_modifier, p["positions"],
        p["scales"], p["rotations"], p["opacities"], p["shs"], view, proj,
        campos, bg, model.alive, 0, _compositing=_compositing)
    with tracing.span("loss"):
        loss = combined_loss(image, target, config.lambda_dssim)
        if target_depth is not None:
            loss = loss + config.lambda_depth * depth_loss(
                depth, config.depth_scale * target_depth, depth_mask)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads)), aux


def train_step(settings: RenderSettings, config: GSConfig,
               model: GaussianModel, adam: AdamState, view: torch.Tensor,
               proj: torch.Tensor, campos: torch.Tensor, tan_fovx: float,
               tan_fovy: float, target: torch.Tensor, iteration: int,
               target_depth: torch.Tensor | None = None,
               depth_mask: torch.Tensor | None = None):
    """One step: render, loss, backward, Adam (``loss_and_grads``, then
    ``adam_step`` with the scheduled learning rates).

    Returns ``(model, adam, loss, grad_positions, counts, iteration + 1)``
    as the JAX step does: ``counts`` is the (2,) int32 tensor (num_pairs,
    num_kept) that the caller holds against ``settings.pair_capacity`` and
    ``settings.kept_capacity`` (a step over either rendered a truncated pair
    list).  ``model`` and ``adam`` are not modified; new ones are returned.

    Float32 throughout: the step sets ``torch.backends.cudnn.allow_tf32 =
    False`` (cuDNN would otherwise run the SSIM convolutions in TF32) and
    keeps ``torch.backends.cuda.matmul.allow_tf32 = False``;
    reduced-precision geometry was found to stall SSIM training in the JAX
    package.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    loss, grads, aux = loss_and_grads(
        settings, config, model, view, proj, campos, tan_fovx, tan_fovy,
        target, target_depth=target_depth, depth_mask=depth_mask)
    with tracing.span("adam"):
        new_params, new_adam = adam_step(
            model.param_dict(), grads, adam, schedule_lrs(config, iteration),
            iteration, config, alive=model.alive)
    counts = torch.stack([aux.num_pairs, aux.num_kept])
    return (model.replace(**new_params), new_adam, loss, grads["positions"],
            counts, iteration + 1)


def _clone_state(model: GaussianModel, adam: AdamState):
    """Copies of the model and the Adam moments (a rollback point)."""
    return (GaussianModel(**{f.name: getattr(model, f.name).clone()
                             for f in dataclasses.fields(model)}),
            AdamState(m={k: x.clone() for k, x in adam.m.items()},
                      v={k: x.clone() for k, x in adam.v.items()}))


def _model_digest(model: GaussianModel) -> int:
    """An exact fingerprint of a model's bits (sums of each field's 32-bit
    words, mixed), to compare the replicas of ranks."""
    digest = 0
    for f in dataclasses.fields(model):
        x = getattr(model, f.name).detach().contiguous().reshape(-1)
        words = x.view(torch.uint8)
        words = torch.nn.functional.pad(words, (0, -len(words) % 4))
        total = int(words.view(torch.int32).to(torch.int64).sum())
        digest = (digest * 1_000_003 + total) % (1 << 61)
    return digest


class Trainer:
    """3DGS training on one device (``device=None``: the CUDA card), or on a
    (data, model) mesh of ranks (``mesh``; one process per rank, each on its
    ``device``).

    ``dataset_path`` is a NeRF-synthetic dataset (``transforms_*.json``) or
    a COLMAP capture (``sparse/0`` and ``images/``), which also seeds the
    Gaussians from its points unless ``config.init_from_points`` is off.
    ``GSTPU_NO_CULL=1`` turns the exact per-tile pair cull off, as
    ``pair_cull=False`` does.

    Under a mesh ``self.model`` and ``self.adam`` hold this rank's shard
    (``n_alive`` is the whole model's); ``full_model()`` gathers it.
    """

    _round_capacity = staticmethod(round_capacity)

    def __init__(self, dataset_path: str, output_path: str,
                 config: Optional[GSConfig] = None, pair_cull: bool = True,
                 device=None, mesh=None):
        self.config = cfg = config or GSConfig()
        self.device = resolve_device(device)
        self.mesh = mesh
        self.n_model = mesh.n_model if mesh is not None else 1
        self.n_data = mesh.n_data if mesh is not None else 1
        # rank 0 evaluates and writes; the others wait at a barrier
        self.is_writer = mesh is None or mesh.rank == 0
        self.pair_cull = pair_cull and os.environ.get(
            "GSTPU_NO_CULL", "0") != "1"
        self.output_path = Path(output_path)
        self.output_path.mkdir(parents=True, exist_ok=True)

        ds_kwargs: Dict[str, Any] = {"downscale": cfg.downscale}
        if is_colmap_dataset(dataset_path):
            ds_cls = ColmapDataset
            # the official 3DGS eval protocol; 0 trains on every image
            ds_kwargs["holdout"] = cfg.eval_holdout
        else:
            ds_cls = NerfSyntheticDataset
        self.train_data = ds_cls(dataset_path, "train", **ds_kwargs)
        self.val_data = self.test_data = None
        try:
            self.val_data = ds_cls(dataset_path, "val", **ds_kwargs)
        except FileNotFoundError:
            pass
        try:
            # the reference loads the test split and never evaluates it;
            # it is evaluated after training here
            self.test_data = ds_cls(dataset_path, "test", **ds_kwargs)
        except FileNotFoundError:
            pass

        self.scene_extent = self._scene_extent()
        self.width = self.train_data.width
        self.height = self.train_data.height
        cam0 = self.train_data.camera(0)
        self.tan_fovx = cam0["tan_fovx"]
        self.tan_fovy = cam0["tan_fovy"]

        # densify's noise; its state is part of a rollback point and of the
        # saved state
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        sfm = None
        if cfg.init_from_points and hasattr(self.train_data, "points3d"):
            sfm = self.train_data.points3d()
        n_init = len(sfm[0]) if sfm is not None else cfg.num_points
        cap = None
        if self.n_model > 1:  # the capacity splits evenly over 'model'
            cap = int(n_init * cfg.capacity_headroom)
            cap = -(-cap // self.n_model) * self.n_model
        if sfm is not None:
            model = init_model_from_points(cfg, *sfm, capacity=cap,
                                           device=self.device)
        else:
            model = init_model(torch.Generator().manual_seed(cfg.seed), cfg,
                               capacity=cap, device=self.device)
        self.model = self._shard_model(model)
        self.adam = init_adam_state(self.model.param_dict())
        self.iteration = 0
        self.losses: list[float] = []
        self.flushes = 0  # deferred fetches of losses and pair counts
        self.steps_run = 0  # steps taken, replays included
        # per step: a CUDA event pair around it on the card, else its
        # host-clock ms (``step_ms``)
        self._step_times: list = []
        # (iteration, digest) of the model after each densify event
        self.densify_digests: list[tuple[int, int]] = []
        self._pair_capacity = self._round_capacity(
            model.capacity * cfg.pair_capacity_per_gaussian)
        # the post-cull capacity starts equal to the pre-cull one; the first
        # flush fits it to the measured kept pairs
        self._kept_capacity = self._pair_capacity
        # full-frame eval and debug renders keep capacities of their own
        self._eval_pair_capacity = self._pair_capacity
        self._eval_kept_capacity = self._kept_capacity
        self._metrics_path = self.output_path / "metrics.jsonl"
        if "holdout" in ds_kwargs:
            self._log({"event": "colmap_split",
                       "holdout": ds_kwargs["holdout"],
                       "train_views": len(self.train_data),
                       "test_views": len(self.test_data)
                       if self.test_data is not None else 0})
        if sfm is not None:
            self._log({"event": "sfm_init", "n_points": len(sfm[0])})

        # Targets, depths and cameras live on the device; a split over
        # 4 GiB of targets is uploaded a view per step instead.
        n_views = len(self.train_data)
        dev = self.device
        self._preload = n_views * self.height * self.width * 12 < 4 << 30
        if self._preload:
            self._targets = torch.from_numpy(np.stack(
                [self.train_data.image(i) for i in range(n_views)])).to(dev)
        self._depths = self._depth_masks = None
        if cfg.lambda_depth > 0.0:
            if not self.train_data.has_depth:
                raise FileNotFoundError(
                    f"lambda_depth={cfg.lambda_depth} but the train split "
                    "has no *_depth_*.png files")
            pairs = [self.train_data.depth(i) for i in range(n_views)]
            self._depths = torch.from_numpy(
                np.stack([p[0] for p in pairs])).to(dev)
            self._depth_masks = torch.from_numpy(
                np.stack([p[1] for p in pairs])).to(dev)
        cams = [self.train_data.camera(i) for i in range(n_views)]

        def stacked(key):
            return torch.from_numpy(np.stack(
                [c[key] for c in cams]).astype(np.float32)).to(dev)

        self._views = stacked("world_to_camera")
        self._projs = stacked("full_proj_matrix")
        self._camposes = stacked("camera_center")
        # per-view intrinsics (multi-camera COLMAP rigs); host floats, as
        # the render takes them
        self._tanfx = [float(c["tan_fovx"]) for c in cams]
        self._tanfy = [float(c["tan_fovy"]) for c in cams]

    # ------------------------------------------------------------------
    def _shard_model(self, model: GaussianModel) -> GaussianModel:
        """This rank's slice of a whole model over 'model' (n_alive kept);
        the model itself without a mesh."""
        if self.mesh is None:
            return model
        return model.replace(**{
            f.name: shard_rows(getattr(model, f.name), self.mesh)
            for f in dataclasses.fields(model) if f.name != "n_alive"})

    def _gather(self, tensors: list) -> list:
        """The whole of each rank's row-sharded tensors (all ranks call)."""
        if self.mesh is None:
            return list(tensors)
        return collectives.all_gather_many(tensors, self.mesh.model)

    def full_model(self) -> GaussianModel:
        """The whole model; under a mesh every rank must call it."""
        if self.mesh is None:
            return self.model
        names = [f.name for f in dataclasses.fields(self.model)
                 if f.name != "n_alive"]
        full = self._gather([getattr(self.model, k) for k in names])
        return self.model.replace(**dict(zip(names, full)))

    def _barrier(self) -> None:
        if self.mesh is not None and torch.distributed.is_initialized():
            torch.distributed.barrier()

    # ------------------------------------------------------------------
    def _scene_extent(self) -> float:
        """Radius of the train cameras' bounding sphere, at least 1."""
        centers = np.stack([c["camera_center"]
                            for c in self.train_data.cameras])
        extent = float(np.max(np.linalg.norm(centers - centers.mean(axis=0),
                                             axis=1)))
        return max(extent * self.config.camera_extent_factor, 1.0)

    def _settings(self, iteration: int | None = None) -> RenderSettings:
        return train_settings(self.config, self.width, self.height,
                              self._pair_capacity, self._kept_capacity,
                              iteration, pair_cull=self.pair_cull)

    def densify_due(self, iteration: int) -> bool:
        """Whether a densify event follows the step of ``iteration``."""
        cfg = self.config
        return (cfg.densify_from_iter < iteration < cfg.densify_until_iter
                and iteration % cfg.densification_interval == 0)

    def _log(self, record: Dict[str, Any]) -> None:
        if not self.is_writer:
            return
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    # ------------------------------------------------------------------
    def _render_eval(self, settings: RenderSettings, model: GaussianModel,
                     view, proj, campos, tan_fovx=None, tan_fovy=None):
        """(image, inverse depth, RenderAux) of one view, no autograd."""
        p = activate_params(model.param_dict(), self.config.parameterization)
        bg = torch.tensor(self.config.background_color, dtype=torch.float32,
                          device=self.device)
        with torch.no_grad():
            return render_forward(
                settings, self.tan_fovx if tan_fovx is None else tan_fovx,
                self.tan_fovy if tan_fovy is None else tan_fovy,
                self.config.scale_modifier, p["positions"], p["scales"],
                p["rotations"], p["opacities"], p["shs"], view, proj, campos,
                bg, model.alive)

    def _render_full(self, model: GaussianModel, view, proj, campos,
                     tan_fovx=None, tan_fovy=None):
        """Full-frame render of the whole ``model`` on this rank, whose
        capacities regrow until no pair overflows: an eval camera can need
        more pairs than any train camera, and eval images and PSNR must not
        drop tiles.  Under a mesh the training capacities fit one band,
        about 1/n_model of a frame, so the eval ones start n_model times
        larger."""
        self._eval_pair_capacity = max(self._eval_pair_capacity,
                                       self._pair_capacity * self.n_model)
        self._eval_kept_capacity = max(self._eval_kept_capacity,
                                       self._kept_capacity * self.n_model)
        for _ in range(4):
            pair_cap = self._round_capacity(self._eval_pair_capacity)
            settings = dataclasses.replace(
                self._settings(), pair_capacity=pair_cap,
                kept_capacity=min(
                    self._round_capacity(self._eval_kept_capacity), pair_cap))
            image, depth, aux = self._render_eval(settings, model, view, proj,
                                                  campos, tan_fovx, tan_fovy)
            num_pairs, num_kept = (int(x) for x in torch.stack(
                [aux.num_pairs, aux.num_kept]).cpu())
            if (num_pairs <= settings.pair_capacity
                    and num_kept <= settings.kept_capacity):
                return image, depth, aux
            if num_pairs > settings.pair_capacity:
                # num_kept came from the truncated list: extrapolate the
                # cull rate to the true pair count (as the flush does)
                num_kept = min(num_pairs, -(-num_kept * num_pairs
                                            // settings.pair_capacity))
            self._eval_pair_capacity = max(self._eval_pair_capacity,
                                           num_pairs)
            self._eval_kept_capacity = max(self._eval_kept_capacity,
                                           num_kept)
        return image, depth, aux  # bounded retries: the last render

    # ------------------------------------------------------------------
    def _maybe_densify(self, pos_grads: torch.Tensor) -> None:
        """The densify event and the opacity reset due after the step of
        ``self.iteration``."""
        cfg = self.config
        it = self.iteration
        if self.densify_due(it):
            # under a mesh: gather, mutate on every rank alike, re-shard
            before = self.full_model()
            pos_grads = self._gather([pos_grads])[0]
            model, stats = densify_mod.densify_and_prune(
                before, pos_grads, float(self.scene_extent), cfg,
                self.generator)
            overflow = int(stats.overflow)
            if overflow > 0:
                # grow the capacity to a power of two (a multiple of
                # n_model) and redo the event
                new_cap = int(2 ** np.ceil(np.log2(
                    int(before.n_alive) + overflow + before.capacity)))
                new_cap = -(-new_cap // self.n_model) * self.n_model
                grown = grow_capacity(before, new_cap)
                pos_grads = torch.cat([pos_grads, pos_grads.new_zeros(
                    (new_cap - before.capacity, 3))])
                model, stats = densify_mod.densify_and_prune(
                    grown, pos_grads, float(self.scene_extent), cfg,
                    self.generator)
                self._log({"event": "capacity_grow", "iteration": it,
                           "capacity": new_cap, "overflow": overflow})
            if self.mesh is not None:
                self._check_replicas(it, model)
            self.model = self._shard_model(model)
            counts = [int(x) for x in torch.stack(
                [stats.changed.to(torch.int32), stats.n_cloned, stats.n_split,
                 stats.n_pruned, stats.n_alive]).cpu()]
            if counts[0]:
                # Q5: the reference zeroes the Adam state on a topology
                # change
                self.adam = init_adam_state(self.model.param_dict())
            self._log({"event": "densify", "iteration": it,
                       "cloned": counts[1], "split": counts[2],
                       "pruned": counts[3], "n_alive": counts[4]})
        if densify_mod.should_reset_opacity(cfg, it):
            self.model = densify_mod.reset_opacities(
                self.model, cfg.opacity_reset_value, cfg.parameterization)
            self._log({"event": "opacity_reset", "iteration": it})

    def _check_replicas(self, iteration: int, model: GaussianModel) -> None:
        """Raise unless every rank holds the same ``model`` (the ranks'
        densify events must agree, or their shards would not fit
        together)."""
        digest = _model_digest(model)
        self.densify_digests.append((iteration, digest))
        mine = torch.tensor([digest, -digest], dtype=torch.int64,
                            device=self.device)
        high, low = (int(x) for x in collectives.all_reduce(mine, None,
                                                            op="max"))
        if (high, -low) != (digest, digest):
            raise RuntimeError(f"the ranks' models differ after the densify "
                               f"event at {iteration}: digests from {-low} "
                               f"to {high}")

    def _step(self, settings: RenderSettings, rng: np.random.Generator,
              it: int):
        """One step: (loss, pos_grads, counts); draws the step's camera(s)
        from ``rng``.  Under a mesh, ``n_data`` cameras and the sharded
        step, else ``train_step``."""
        cfg = self.config
        if self.mesh is None:
            cam_idx = int(rng.integers(0, len(self.train_data)))
            target = self._target(cam_idx)
            td = self._depths[cam_idx] if self._depths is not None else None
            dm = (self._depth_masks[cam_idx]
                  if self._depth_masks is not None else None)
            (self.model, self.adam, loss, pos_grads, counts,
             _) = train_step(settings, cfg, self.model, self.adam,
                             self._views[cam_idx], self._projs[cam_idx],
                             self._camposes[cam_idx], self._tanfx[cam_idx],
                             self._tanfy[cam_idx], target, it,
                             target_depth=td, depth_mask=dm)
            return loss, pos_grads, counts
        from gstpu_torch.parallel.sharded import (sharded_loss_and_grads,
                                                  target_band)
        # the same draw on every rank; rank (d, m) renders camera idxs[d]
        # and keeps band m of its targets
        idxs = rng.integers(0, len(self.train_data), size=self.n_data)
        d, m = self.mesh.coords
        cam = int(idxs[d])

        def band(x):
            return None if x is None else target_band(x, settings,
                                                      self.n_model, m)

        params, alive = self.model.param_dict(), self.model.alive
        loss, grads, counts = sharded_loss_and_grads(
            settings, cfg, self.mesh, params, alive, self._views[cam],
            self._projs[cam], self._camposes[cam], self._tanfx[cam],
            self._tanfy[cam], band(self._target(cam)),
            band(self._depths[cam] if self._depths is not None else None),
            band(self._depth_masks[cam]
                 if self._depth_masks is not None else None))
        with tracing.span("adam"):
            params, self.adam = adam_step(params, grads, self.adam,
                                          schedule_lrs(cfg, it), it, cfg,
                                          alive=alive)
        self.model = self.model.replace(**params)
        return loss, grads["positions"], counts

    @contextlib.contextmanager
    def _timed_step(self):
        """Time one step without waiting for it: CUDA events on the card
        (read by ``step_ms``), the host clock on the CPU."""
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            yield
            self._step_times.append((time.perf_counter() - t0) * 1e3)
            return
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        yield
        end.record()
        self._step_times.append((start, end))

    def step_ms(self) -> list[float]:
        """Each step's time in ms, replays included; on the card the time
        on the device between the step's first and last work, read after
        a synchronize."""
        if self.device.type != "cuda":
            return list(self._step_times)
        torch.cuda.synchronize(self.device)
        return [a.elapsed_time(b) for a, b in self._step_times]

    def _target(self, idx: int) -> torch.Tensor:
        if self._preload:
            return self._targets[idx]
        return torch.from_numpy(self.train_data.image(idx)).to(self.device)

    # ------------------------------------------------------------------
    def train(self, num_iterations: Optional[int] = None,
              flush_interval: int = 25) -> None:
        """The training loop.

        Each step's loss and pair counts stay on the device and are fetched
        every ``flush_interval`` steps in one transfer; the step itself
        waits for nothing.  A pair-list overflow is thus seen up to
        ``flush_interval`` steps late.  Those steps rendered with dropped
        pairs, so the window is rolled back to the copy of the model and
        Adam state taken at its start (with the noise generator's and the
        camera order's states), the capacities grow, and the window runs
        again.  A flush comes before every densify event, so a window never
        spans a topology change.
        """
        cfg = self.config
        total = num_iterations or cfg.num_iterations
        rng = np.random.default_rng(cfg.seed)
        t_last = time.perf_counter()
        it_last = self.iteration
        pending: list[tuple[int, torch.Tensor, torch.Tensor]] = []
        snap = None
        replays = 0  # consecutive rollbacks of the same window

        def take_snap():
            nonlocal snap
            snap = (_clone_state(self.model, self.adam), self.iteration,
                    self.generator.get_state(), rng.bit_generator.state)

        def flush() -> bool:
            """Fetch the window's scalars; True if the window overflowed
            and was rolled back (the caller then replays it)."""
            nonlocal pending, snap, replays
            if not pending:
                return False
            self.flushes += 1
            fetched = torch.stack([
                torch.cat([loss.reshape(1).double(), counts.double()])
                for _, loss, counts in pending]).cpu().numpy()
            losses = [float(x) for x in fetched[:, 0]]
            num_pairs = fetched[:, 1].astype(np.int64)
            num_kept = fetched[:, 2].astype(np.int64)
            max_pairs, max_kept = int(num_pairs.max()), int(num_kept.max())
            steps = len(pending)
            tracing.COUNTERS.add("train.pairs", int(num_pairs.sum()))
            tracing.COUNTERS.add("train.pair_slots",
                                 steps * self._pair_capacity)
            tracing.COUNTERS.add("train.kept", int(num_kept.sum()))
            tracing.COUNTERS.add("train.kept_slots", steps * min(
                self._kept_capacity, self._pair_capacity))
            overflow_steps = int(np.sum((num_pairs > self._pair_capacity)
                                        | (num_kept > self._kept_capacity)))
            rollback = bool(overflow_steps) and snap is not None \
                and replays < 3

            def refit(cap, need):
                """Grow on overflow; shrink when over-provisioned 2.5x
                (binning, gathers and scatters scale with the capacity)."""
                if need > cap or (need and need * 2.5 <= cap):
                    return self._round_capacity(need * 1.5)
                return cap

            new_pair = refit(self._pair_capacity, max_pairs)
            kept_need = max_kept
            if max_pairs > self._pair_capacity:
                # num_kept came from the truncated pair list: extrapolate
                # the cull rate to the true pair count, so one rollback
                # fixes both capacities
                kept_need = min(max_pairs, -(-max_kept * max_pairs
                                             // self._pair_capacity))
            new_kept = refit(self._kept_capacity, kept_need)
            if (new_pair, new_kept) != (self._pair_capacity,
                                        self._kept_capacity):
                grew = (new_pair > self._pair_capacity
                        or new_kept > self._kept_capacity)
                self._pair_capacity = new_pair
                self._kept_capacity = new_kept
                self._log({"event": "pair_capacity_grow" if grew
                           else "pair_capacity_shrink",
                           "iteration": pending[-1][0],
                           "capacity": self._pair_capacity,
                           "kept_capacity": self._kept_capacity})
            if overflow_steps:
                self._log({"event": "pair_overflow",
                           "iteration": pending[-1][0],
                           "overflow_steps": overflow_steps,
                           "max_pairs": max_pairs, "max_kept": max_kept,
                           "capacity": self._pair_capacity,
                           "kept_capacity": self._kept_capacity,
                           "rolled_back": rollback})
            pending = []
            if rollback:
                tracing.COUNTERS.add("train.rollbacks")
                tracing.COUNTERS.add("train.replays", steps)
                # the replayed window takes a snapshot of its own
                ((self.model, self.adam), self.iteration, gen_state,
                 rng_state) = snap
                self.generator.set_state(gen_state)
                rng.bit_generator.state = rng_state
                replays += 1
                return True
            replays = 0
            self.losses.extend(losses)
            return False

        while self.iteration < total or pending:
            if self.iteration >= total:
                # the trailing window: after a rollback the loop goes on
                if flush():
                    it_last = min(it_last, self.iteration)
                continue
            it = self.iteration
            if not pending:
                take_snap()  # window start: the rollback point
            settings = self._settings(it)
            with self._timed_step():
                loss, pos_grads, counts = self._step(settings, rng, it)
            self.steps_run += 1
            pending.append((it, loss, counts))

            if len(pending) >= flush_interval or self.densify_due(it):
                if flush():  # overflow: the window was rolled back
                    it_last = min(it_last, self.iteration)
                    continue
            self._maybe_densify(pos_grads)
            self.iteration += 1

            if it and it % 50 == 0 and it > it_last:
                now = time.perf_counter()
                self._log({"iteration": it,
                           "loss": self.losses[-1] if self.losses else None,
                           "n_alive": int(self.model.n_alive),
                           "step_ms": (now - t_last) / (it - it_last) * 1e3})
                t_last, it_last = now, it
            if it % cfg.save_interval == 0 or it == total - 1:
                if flush():
                    it_last = min(it_last, self.iteration)
                    continue
                self.save_checkpoint(it)
                if self.val_data is not None and it > 0:
                    self.evaluate(it, max_views=(cfg.eval_views
                                                 if cfg.eval_views > 0
                                                 else None))
        # the end of training: the full val and test splits
        if self.val_data is not None:
            self.evaluate(self.iteration, data=self.val_data,
                          max_views=None, tag="eval_full")
        if self.test_data is not None:
            self.evaluate(self.iteration, data=self.test_data,
                          max_views=None, tag="test")
        self._log({"event": "done", "iteration": self.iteration})

    # ------------------------------------------------------------------
    def _camera_tensors(self, cam):
        return tuple(torch.from_numpy(np.asarray(cam[k], np.float32)).to(
            self.device) for k in ("world_to_camera", "full_proj_matrix",
                                   "camera_center"))

    def evaluate(self, iteration: int, max_views: int | None = 8,
                 data=None, tag: str = "eval") -> float:
        """Mean PSNR (and SSIM) over the first ``max_views`` views of the
        val split or of ``data`` (``None``: all of them); logged with the
        view count."""
        data = data if data is not None else self.val_data
        vals, ssims = [], []
        n_views = len(data) if max_views is None else min(max_views, len(data))
        model = self.full_model()
        if not self.is_writer:
            self._barrier()
            return float("nan")
        for idx in range(n_views):
            cam = data.camera(idx)
            img, _, _ = self._render_full(model,
                                          *self._camera_tensors(cam),
                                          cam["tan_fovx"], cam["tan_fovy"])
            target = torch.from_numpy(data.image(idx)).to(self.device)
            vals.append(float(psnr(img, target)))
            ssims.append(float(ssim(torch.clamp(img, 0.0, 1.0), target,
                                    clamp_sigma=True)))
        mean_psnr = float(np.mean(vals))
        self._log({"event": tag, "iteration": iteration, "psnr": mean_psnr,
                   "ssim": float(np.mean(ssims)), "views": len(vals)})
        self._barrier()
        return mean_psnr

    # ------------------------------------------------------------------
    def save_checkpoint(self, iteration: int,
                        save_images: bool = True) -> None:
        """The PLY (the reference's layout), ``cameras.json`` (once),
        ``loss.txt``, the debug images and the resumable state.  Under a
        mesh every rank gathers and rank 0 writes."""
        model = self.full_model()
        adam = self._full_adam()
        if not self.is_writer:
            self._barrier()
            return
        ckpt_dir = self.output_path / "point_cloud" / f"iteration_{iteration}"
        params_np = {k: v.cpu().numpy()
                     for k, v in model.param_dict().items()}
        save_ply(params_np, ckpt_dir / "point_cloud.ply",
                 int(model.n_alive),
                 parameterization=self.config.parameterization)
        cams_json = self.output_path / "cameras.json"
        if not cams_json.exists():  # the cameras do not change
            save_cameras_json(self.train_data.cameras, cams_json,
                              getattr(self.train_data, "image_paths", None))
        with open(self.output_path / "loss.txt", "w") as f:
            f.writelines(f"{loss}\n" for loss in self.losses)
        if save_images:
            self._save_debug_images(iteration, model)
        self._save_state(iteration, model, adam)
        self._barrier()

    def _full_adam(self) -> AdamState:
        """The whole Adam state; under a mesh every rank must call it."""
        if self.mesh is None:
            return self.adam
        keys = list(self.adam.m)
        full = self._gather([self.adam.m[k] for k in keys]
                            + [self.adam.v[k] for k in keys])
        return AdamState(m=dict(zip(keys, full[:len(keys)])),
                         v=dict(zip(keys, full[len(keys):])))

    def _save_debug_images(self, iteration: int,
                           model: GaussianModel) -> None:
        """The reference's debug read-outs: the render and target PNGs of
        train view 0, pair count, median radius, opacity spread and visible
        count into metrics.jsonl, a depth-coloured projection scatter and
        the loss plot.  Skipped without PIL (the plots without
        ``matplotlib``)."""
        try:
            import PIL  # noqa: F401
        except ImportError:
            return
        cam = self.train_data.camera(0)
        img, _, aux = self._render_full(model, *self._camera_tensors(cam),
                                        cam["tan_fovx"], cam["tan_fovy"])
        arr = np.clip(img.cpu().numpy(), 0.0, 1.0)
        imwrite(self.output_path / f"render_{iteration:06d}.png",
                (arr * 255).astype(np.uint8))
        target = np.clip(self.train_data.image(0), 0.0, 1.0)
        imwrite(self.output_path / f"target_{iteration:06d}.png",
                (target * 255).astype(np.uint8))

        radii = aux.radii.cpu().numpy()
        xy = aux.xy.cpu().numpy()
        alive = model.alive.cpu().numpy()
        opac = model.opacities.cpu().numpy()[alive]
        if self.config.parameterization == "activated":
            opac = 1.0 / (1.0 + np.exp(-opac))  # render-space alpha
        vis = (radii > 0) & alive
        w, h = self.width, self.height
        on_screen = vis & (xy[:, 0] >= 0) & (xy[:, 0] < w) \
            & (xy[:, 1] >= 0) & (xy[:, 1] < h) & np.isfinite(xy).all(axis=1)
        self._log({
            "event": "debug_stats", "iteration": iteration,
            "dup_pairs": int(aux.num_pairs),
            "median_radius": float(np.median(radii[vis])) if vis.any()
            else 0.0,
            "alpha_min": float(opac.min()) if opac.size else 0.0,
            "alpha_med": float(np.median(opac)) if opac.size else 0.0,
            "alpha_max": float(opac.max()) if opac.size else 0.0,
            "visible": int(on_screen.sum()), "n_alive": int(alive.sum()),
        })
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        if on_screen.any():
            view = np.asarray(cam["world_to_camera"], np.float32)
            pos = model.positions.cpu().numpy()
            z = pos @ view[:3, 2] + view[3, 2]
            fig, ax = plt.subplots(figsize=(6, 6))
            sc = ax.scatter(xy[on_screen, 0], xy[on_screen, 1], s=4,
                            c=z[on_screen], cmap="turbo", alpha=0.7)
            ax.set_xlim(0, w)
            ax.set_ylim(h, 0)
            ax.set_title(f"Projected Gaussians (iter {iteration}): "
                         f"{int(on_screen.sum())}/{int(alive.sum())}")
            fig.colorbar(sc, label="depth(z)")
            fig.tight_layout()
            fig.savefig(self.output_path / f"proj_{iteration:06d}.png",
                        dpi=120)
            plt.close(fig)
        if self.losses:
            fig, ax = plt.subplots(figsize=(8, 4))
            ax.plot(self.losses)
            ax.set_xlabel("iteration")
            ax.set_ylabel("loss")
            ax.set_yscale("log")
            fig.savefig(self.output_path / "loss_plot.png", dpi=80)
            plt.close(fig)

    def _state_path(self, iteration: int) -> Path:
        return self.output_path / "state" / f"{iteration}.pt"

    def _save_state(self, iteration: int, model: GaussianModel,
                    adam: AdamState) -> None:
        """The (whole) model, the Adam moments, the iteration, the noise
        generator's state and the losses, for ``restore``."""
        path = self._state_path(iteration)
        path.parent.mkdir(parents=True, exist_ok=True)
        fields = {f.name: getattr(model, f.name).cpu()
                  for f in dataclasses.fields(model)}
        torch.save({"model": fields,
                    "adam_m": {k: x.cpu() for k, x in adam.m.items()},
                    "adam_v": {k: x.cpu() for k, x in adam.v.items()},
                    "iteration": iteration,
                    "generator": self.generator.get_state(),
                    "losses": torch.tensor(self.losses,
                                           dtype=torch.float64)}, path)

    def restore(self, iteration: int) -> None:
        """Resume from the state saved at ``iteration``: training goes on
        at ``iteration + 1``.  Under a mesh every rank reads the state and
        keeps its shard."""
        state = torch.load(self._state_path(iteration), map_location="cpu",
                           weights_only=True)
        dev = self.device

        def shard(x):
            x = x.to(dev)
            return x if self.mesh is None or x.dim() == 0 \
                else shard_rows(x, self.mesh)

        self.model = GaussianModel(**{k: shard(x)
                                      for k, x in state["model"].items()})
        self.adam = AdamState(
            m={k: shard(x) for k, x in state["adam_m"].items()},
            v={k: shard(x) for k, x in state["adam_v"].items()})
        self.iteration = int(state["iteration"]) + 1
        self.generator.set_state(state["generator"])
        self.losses = state["losses"].tolist()
