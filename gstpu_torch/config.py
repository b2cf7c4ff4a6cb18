"""Configuration of the PyTorch port: render settings and training config.

Field-for-field copy of ``gstpu/config.py`` as plain frozen dataclasses.
``use_pallas`` and ``pallas_interpret`` are gone: where the tensors live
decides the compositing path (a CUDA tensor goes to the hand-written kernel
in ``ops/cuda_rasterize.py``, a CPU tensor to the plain PyTorch version in
``ops/rasterize.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Tile size of the rasterizer (16x16 pixels per tile).
TILE_X = 16
TILE_Y = 16
TILE_PIXELS = TILE_X * TILE_Y


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Settings of one render configuration.

    They fix the padded shapes of the pipeline (``pair_capacity``,
    ``kept_capacity``, the tile band), so the arrays compare one to one with
    the JAX package's.
    """

    width: int
    height: int
    sh_degree: int = 3
    # Capacity of the duplicated (tile, gaussian) pair list.  Pairs beyond it
    # are dropped; callers read RenderAux.num_pairs and re-render bigger.
    pair_capacity: int = 1 << 18
    # Gaussians per step of the plain chunked compositing walk.
    chunk: int = 32
    # Replicate the reference's inconsistent forward/backward EWA transforms
    # and cov3d decomposition in the backward (Q12, Q13; ops/preprocess_bwd).
    parity: bool = True
    # Replicate the reference's constant camera-translation bias in position
    # gradients (Q15; ops/preprocess_bwd.cov2d_backward).
    grad_bias_parity: bool = False
    # Shrink tile rects to each Gaussian's exact alpha >= 1/255 reach
    # (r_cut = sqrt(2 ln(255 op)) sigma_max; see ops/preprocess.py).  Leaves
    # the image unchanged to f32 reassociation but changes radii/n_contrib.
    tight_radius: bool = False
    # Rasterize only a band of `tile_rows` tile rows (None = the full grid).
    tile_rows: int | None = None
    # Stride between the band's tile rows: band row k is global tile row
    # row0 + k*row_stride (round-robin rows of the multi-device path).
    row_stride: int = 1
    # Mesh axis of the sharded multi-device path ("model"): each rank runs
    # the per-Gaussian preprocess and adjoint chain on its slice.  The
    # mesh passed to the render resolves the name to a process group.
    shard_axis: str | None = None
    # Exact per-tile pair culling: drop (tile, Gaussian) pairs whose maximum
    # alpha over the tile's pixel rect is provably < 1/255.  The image is
    # unchanged to f32 reassociation; n_contrib/num_kept bookkeeping changes.
    pair_cull: bool = False
    # Post-cull pair capacity (two-tier): expansion and sort run at
    # ``pair_capacity``, then the sorted list is sliced to ``kept_capacity``.
    # None = pair_capacity.  Callers watch RenderAux.num_kept.
    kept_capacity: int | None = None

    @property
    def live_capacity(self) -> int:
        """Size of the post-binning pair list (= kept_capacity under cull)."""
        return self.kept_capacity if self.kept_capacity is not None \
            else self.pair_capacity

    @property
    def grid_x(self) -> int:
        return (self.width + TILE_X - 1) // TILE_X

    @property
    def grid_y(self) -> int:
        return (self.height + TILE_Y - 1) // TILE_Y

    @property
    def num_tiles(self) -> int:
        return self.grid_x * self.grid_y

    @property
    def band_rows(self) -> int:
        return self.tile_rows if self.tile_rows is not None else self.grid_y

    @property
    def band_tiles(self) -> int:
        return self.grid_x * self.band_rows


@dataclasses.dataclass(frozen=True)
class GSConfig:
    """Training configuration (the reference's effective values).

    Copied field for field from ``gstpu/config.py``; the train step
    (``gstpu_torch/trainer.py``) and Adam read it.
    """

    # === training ===
    num_iterations: int = 7000
    num_points: int = 5000
    save_interval: int = 500

    # === learning-rate schedule ===
    use_lr_scheduler: bool = True
    lr_pos: float = 1e-2
    lr_scale: float = 5e-3
    lr_rot: float = 5e-3
    lr_sh: float = 2e-3
    lr_opac: float = 5e-3
    final_lr_factor: float = 0.01
    # Official 3DGS schedules only the position LR; the --activated recipe
    # turns the opacity decay off.
    schedule_opac: bool = True

    # === Adam ===
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8

    # === densification & pruning ===
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_grad_threshold: float = 2e-4
    cull_opacity_threshold: float = 0.005
    percent_dense: float = 0.01
    max_allowed_prune_ratio: float = 1.0
    densify_from_iter: int = 500
    densify_until_iter: int = 15000
    min_valid_points: int = 1000
    max_valid_points: int = 1_000_000
    camera_extent_factor: float = 1.0
    clone_noise_scale: float = 0.01
    split_scale_factor: float = 0.8
    split_n: int = 2
    opacity_reset_value: float = 0.01
    # None = reset opacities unconditionally (reference); set to
    # densify_until_iter for the official 3DGS gating.
    opacity_reset_until_iter: int | None = None
    # Official 3DGS split sampling (opt-in).
    official_split_sampling: bool = False
    # Q16 parity switch: replicate the reference's exclusive-scan sizing of
    # densify/prune outputs (drops the last element per event).
    q16_last_index: bool = False

    # === parameterization: "raw" (reference) or "activated" (official) ===
    parameterization: str = "raw"

    # === gaussian parameters ===
    initial_scale: float = 0.1
    scale_modifier: float = 1.0
    sh_degree: int = 3
    initial_opacity: float = 0.1
    initial_sh_dc: float = -0.007
    init_position_extent: float = 1.3
    # Render/train at 1/downscale of the capture resolution.
    downscale: int = 1
    # COLMAP captures: hold out every N-th image as the test split.
    eval_holdout: int = 8
    # Seed Gaussians from the SfM point cloud when the dataset has one.
    init_from_points: bool = True
    # Views per mid-training eval (<=0 = the full val split).
    eval_views: int = 8

    # === scene & rendering ===
    scene_scale: float = 1.0
    background_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    near: float = 0.01
    far: float = 100.0

    # === loss ===
    lambda_dssim: float = 0.0
    lambda_depth: float = 0.0
    depth_scale: float = 1.0

    # === SH warmup (0 = always full degree, the reference) ===
    sh_degree_interval: int = 0

    # === capacity management ===
    capacity_headroom: float = 1.5
    pair_capacity_per_gaussian: float = 24.0

    seed: int = 42

    def replace(self, **kw) -> "GSConfig":
        return dataclasses.replace(self, **kw)
