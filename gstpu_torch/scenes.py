"""Scenes shared by the port's tests and ``chip_smoke.py`` (NumPy only).

- ``span_edge_case``: the hand-built pair list of the JAX package's
  ``tests/test_pallas.py::test_pallas_forward_exact_span_boundaries``
  (seed 9): per-tile counts at the chunk and block edges, empty tiles, a
  2048-pair tile.
- ``early_exit_scene``: the high-opacity scene of
  ``tests/test_pallas.py::test_pallas_backward_early_exit_and_boundary_merge``
  (seed 7): most tiles saturate and exit early, and tile starts are not
  multiples of 128.  ``example_camera`` and ``random_scene`` are copies of
  the JAX package's ``tests/scenes.py``.
- ``preprocess_edge_case``: Gaussians at each edge of the preprocess (view
  depth 0, just behind and on the near plane, a 2D covariance with
  determinant 0, off the grid, tile rects that saturate, a negative SH
  colour) among ordinary ones.
- ``lego_params`` / ``lego_orbit``: the trained Lego point cloud in
  ``assets/lego_trained.ply`` seen from orbit cameras with Lego's field of
  view, so a render needs no dataset.  ``lego_close_view`` is a camera close
  enough that every 16x16 tile of an 800x800 image is occupied (at least 262
  Gaussians' rects per tile); the main-path orbit at radius 4 leaves about
  half of the tiles empty.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from gstpu_torch.config import RenderSettings
from gstpu_torch.utils.camera import (orbit_camera, projection_matrix,
                                     world_to_view)
from gstpu_torch.utils.ply import load_ply, render_space_params

REPO_ROOT = Path(__file__).resolve().parents[1]
LEGO_PLY = REPO_ROOT / "assets" / "lego_trained.ply"
GATE_NPZ = REPO_ROOT / "tests" / "golden" / "pallas_gate.npz"
LEGO_CAMERA_ANGLE_X = 0.6911112070083618
ORBIT_RADIUS = 4.0
ORBIT_HEIGHT = 1.5
CLOSE_VIEW = dict(theta=1.5 * math.pi, radius=1.2, height=1.2)

SPAN_COUNTS = (512, 1024, 0, 300, 127, 128, 129, 511, 513, 0, 640, 1,
               256, 384, 2048, 0)


def span_edge_case():
    """(settings, prep arrays, pairs arrays) keyed by field name."""
    rng = np.random.default_rng(9)
    width = height = 64                      # 4x4 tile grid
    settings = RenderSettings(width=width, height=height,
                              pair_capacity=1 << 13)
    n = 64
    # wide conics covering any tile, mixed opacities so some tiles saturate
    # (early exit) and some run out their span
    xy = rng.uniform(0, width, (n, 2)).astype(np.float32)
    conic = np.stack([np.full(n, 2e-4), np.zeros(n), np.full(n, 2e-4)],
                     -1).astype(np.float32)
    opac = rng.uniform(0.004, 0.4, n).astype(np.float32)
    depth = rng.uniform(1.0, 9.0, n).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    prep = dict(radii=np.full((n,), 50, np.int32), xy=xy, depth=depth,
                cov3d=np.zeros((n, 6), np.float32), rgb=rgb, conic=conic,
                opacity=opac, tiles_touched=np.zeros((n,), np.int32),
                rect=np.zeros((n, 4), np.int32),
                clamped=np.zeros((n, 3), np.float32),
                visible=np.ones((n,), bool))

    counts = np.asarray(SPAN_COUNTS, np.int32)
    k = settings.pair_capacity
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    total = int(np.sum(counts))
    gauss = rng.integers(0, n, total).astype(np.int32)
    tile = np.repeat(np.arange(settings.num_tiles, dtype=np.int32), counts)
    pairs = dict(
        gauss_id=np.concatenate([gauss, np.zeros(k - total, np.int32)]),
        tile_id=np.concatenate(
            [tile, np.full(k - total, settings.num_tiles, np.int32)]),
        tile_start=starts, tile_count=counts,
        num_pairs=np.int32(total), num_kept=np.int32(total),
        gm_pos=np.arange(k, dtype=np.int32),
        gauss_cum=np.zeros(n, np.int32))
    return settings, prep, pairs


# preprocess_edge_case's Gaussians at the edges, by their index
PREP_EDGES = {"depth_zero": 0, "behind_near": 1, "on_near": 2, "det_zero": 3,
              "off_grid": 4, "saturated_off_grid": 5,
              "saturated_off_grid_neg": 6, "saturated_rect": 7,
              "saturated_rect_inf": 8, "negative_colour": 9}


def preprocess_edge_case(n_ordinary: int = 54):
    """(arrays, camera) for ``preprocess``: the Gaussians of ``PREP_EDGES``
    followed by ``n_ordinary`` seeded ones, seen by a 160x160 camera at the
    origin that looks along +z (view the identity, so a Gaussian's view
    depth is its z), tan_fov 0.5 both ways (focal 160), 10 x 10 tiles.

    ``det_zero`` is a needle at depth 5 on the optical axis, 2,000 long
    along the image diagonal (scales (2000, 0, 0), the unnormalized
    quaternion (0, 0, 0.5, 0.5), whose rotation maps x to (0.5, 0.5, 0)):
    its screen covariance is [[v, v], [v, v]] with v = 1.024e9 exactly, so
    the 0.3 blur is lost and a*c - b*b is 0.  ``saturated_rect`` (scale
    1.85e8) has a finite radius over 2^30 tiles and ``saturated_rect_inf``
    (3e8) an infinite one: both cover the whole grid.  The saturated
    off-grid ones project to x = +-1.6e11 pixels."""
    rng = np.random.default_rng(17)
    k = len(PREP_EDGES)
    n = k + n_ordinary
    means = np.zeros((n, 3), np.float32)
    scales = np.full((n, 3), 0.05, np.float32)
    rotations = np.tile(np.float32([0.0, 0.0, 0.0, 1.0]), (n, 1))
    opacities = rng.uniform(0.05, 0.95, n).astype(np.float32)
    shs = rng.normal(0.0, 0.3, (n, 16, 3)).astype(np.float32)
    e = PREP_EDGES
    means[e["depth_zero"]] = (0.1, 0.1, 0.0)
    means[e["behind_near"], 2] = np.nextafter(np.float32(0.2), np.float32(0))
    means[e["on_near"], 2] = np.float32(0.2)
    means[e["det_zero"], 2] = 5.0
    scales[e["det_zero"]] = (2000.0, 0.0, 0.0)
    rotations[e["det_zero"]] = (0.0, 0.0, 0.5, 0.5)
    means[e["off_grid"]] = (50.0, 0.0, 5.0)
    means[e["saturated_off_grid"]] = (1e9, 0.0, 1.0)
    means[e["saturated_off_grid_neg"]] = (-1e9, 0.0, 1.0)
    for name, s in (("saturated_rect", 1.85e8), ("saturated_rect_inf", 3e8)):
        means[e[name], 2] = 5.0
        scales[e[name]] = (s, 1e-3, 1e-3)
    means[e["negative_colour"]] = (0.2, -0.1, 4.0)
    shs[e["negative_colour"], 0] = -5.0
    means[k:, :2] = rng.uniform(-2.0, 2.0, (n_ordinary, 2))
    means[k:, 2] = rng.uniform(1.0, 8.0, n_ordinary)
    scales[k:] = rng.uniform(0.01, 0.3, (n_ordinary, 3))
    q = rng.normal(0.0, 1.0, (n_ordinary, 4))
    rotations[k:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    fov = 2.0 * math.atan(0.5)
    camera = {"view": np.eye(4, dtype=np.float32),
              "proj": projection_matrix(fovx=fov, fovy=fov, znear=0.01,
                                        zfar=100.0).T.astype(np.float32),
              "campos": np.zeros(3, np.float32), "width": 160,
              "height": 160, "tan_fovx": 0.5, "tan_fovy": 0.5}
    arrays = dict(means=means, scales=scales, rotations=rotations,
                  opacities=opacities, shs=shs)
    return arrays, camera


def lego_params(subset: int | None = None, seed: int = 0):
    """Render-space parameters of the trained Lego checkpoint; ``subset``
    keeps that many Gaussians, drawn without replacement from ``seed``."""
    params = render_space_params(load_ply(LEGO_PLY))
    if subset is not None:
        n = params["positions"].shape[0]
        keep = np.sort(np.random.default_rng(seed).choice(n, subset,
                                                          replace=False))
        params = {k: v[keep] for k, v in params.items()}
    return params


def lego_orbit(theta: float, size: int):
    """Camera dict of ``utils.camera.orbit_camera`` at Lego's orbit."""
    return orbit_camera(theta, ORBIT_RADIUS, ORBIT_HEIGHT, size,
                        LEGO_CAMERA_ANGLE_X)


def lego_close_view(size: int):
    """Camera dict of the close Lego view (every tile occupied at 800x800)."""
    return orbit_camera(CLOSE_VIEW["theta"], CLOSE_VIEW["radius"],
                        CLOSE_VIEW["height"], size, LEGO_CAMERA_ANGLE_X)


def example_camera(width=128, height=128, fovx=45.0, fovy=45.0,
                   znear=0.01, zfar=100.0):
    """The reference smoke-test camera, scaled down.  Like the reference it
    passes fovx=45.0 *radians* to tan(fov/2)."""
    T = np.array([0, 0, 5], dtype=np.float32)
    R = np.array([[1, 0, 0], [0, 1, 0], [0, 0, -1]], dtype=np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = R
    w2c[:3, 3] = T
    w2c = w2c.T
    view = world_to_view(R=R, t=T)
    proj = projection_matrix(fovx=fovx, fovy=fovy, znear=znear, zfar=zfar).T
    full_proj = (w2c @ proj).astype(np.float32)
    campos = np.linalg.inv(w2c)[3, :3].astype(np.float32)
    return {"view": view.astype(np.float32), "proj": full_proj,
            "campos": campos, "tan_fovx": math.tan(fovx * 0.5),
            "tan_fovy": math.tan(fovy * 0.5), "width": width,
            "height": height}


def random_scene(rng: np.random.Generator, n=64, extent=3.0, z_center=-10.0,
                 opacity_range=(0.2, 0.9), scale_range=(0.1, 0.8)):
    """Random anisotropic Gaussians in front of the example camera:
    (positions, shs (n,16,3), scales, rotations, opacities)."""
    pts = np.empty((n, 3), np.float32)
    pts[:, 0] = rng.uniform(-extent, extent, n)
    pts[:, 1] = rng.uniform(-extent, extent, n)
    pts[:, 2] = rng.uniform(z_center - 2.0, z_center + 2.0, n)
    shs = rng.normal(0.0, 0.3, (n, 16, 3)).astype(np.float32)
    shs[:, 0] = rng.uniform(-0.5, 1.5, (n, 3))
    opacities = rng.uniform(*opacity_range, n).astype(np.float32)
    scales = rng.uniform(*scale_range, (n, 3)).astype(np.float32)
    q = rng.normal(0, 1, (n, 4)).astype(np.float32)
    rotations = q / np.linalg.norm(q, axis=1, keepdims=True)
    return pts, shs.astype(np.float32), scales, rotations, opacities


def early_exit_scene():
    """(settings, params, camera, dl_dpix (T,256,3), dl_ddepth (T,256), bg)
    of the high-opacity early-exit scene, 64x64, 120 Gaussians."""
    rng = np.random.default_rng(7)
    size = 64
    cam = example_camera(width=size, height=size)
    pts, shs, scales, rotations, opacities = random_scene(
        rng, n=120, opacity_range=(0.85, 1.0))
    settings = RenderSettings(width=size, height=size, pair_capacity=1 << 13)
    dl_dpix = rng.normal(0, 1, (settings.num_tiles, 256, 3)).astype(
        np.float32)
    dl_ddepth = rng.normal(0, 1, (settings.num_tiles, 256)).astype(np.float32)
    params = dict(positions=pts, scales=scales, rotations=rotations,
                  opacities=opacities, shs=shs)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    return settings, params, cam, dl_dpix, dl_ddepth, bg
