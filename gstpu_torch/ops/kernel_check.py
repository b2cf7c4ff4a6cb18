"""The kernel gate: K1 and K2 against the stored JAX outputs.

Port of ``gstpu/ops/pallas_check.py``.  The bench runs
``compiled_parity_check`` in the same process as its headline number, so a
kernel that builds but computes wrong cannot hide behind CPU tests.  The
stored gate is the JAX package's ``tests/golden/pallas_gate.npz``: its
``prep_*`` and ``pairs_*`` inputs (8,000 Gaussians, seed 3, 160x160, 16,015
pairs), cotangents, and the XLA path's forward outputs and per-Gaussian
gradients.  It is never rewritten here (``generate_golden`` stays the JAX
package's).

- ``gate_forward`` / ``gate_backward`` run the compositing (by default the
  kernel wrappers of ``ops/cuda_rasterize.py``; on CPU tensors those run the
  plain versions) on the stored inputs, the backward on the forward's own
  outputs, as ``pallas_check._run`` does.
- ``forward_errors`` and ``grad_errors`` measure outputs against a
  reference with the gate's flip-tolerant rules; ``chip_smoke.py`` uses them
  too.
- ``preprocess_backend_parity`` re-runs the port's preprocess of the gate
  scene on the device (through ``ops/cuda_preprocess.py``: the kernel on
  the card) and holds it against the stored CPU prep.
- ``compiled_parity_check`` is the whole gate, with the thresholds of
  ``pallas_check.py:130-131,160-188``.

``device=None`` means the CUDA card (and raises without it); pass
``device="cpu"`` for the plain versions.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from gstpu_torch import convert, scenes
from gstpu_torch.config import RenderSettings
from gstpu_torch.ops import cuda_preprocess, cuda_rasterize
from gstpu_torch.ops.binning import Pairs
from gstpu_torch.ops.preprocess import PreprocessOut

GOLDEN_PATH = scenes.GATE_NPZ

N = 8_000
SIZE = 160
PAIR_CAPACITY = 1 << 16
SEED = 3

# Forward: a boundary pixel (a contributor-count flip, or final T below
# BOUNDARY_T in either output) is exempt from the value limits, since pairs
# on the 1/255 and 1e-4 thresholds flip between summation orders.
MAX_FLIP_FRAC = 0.05
MAX_COLOR_ERR = 1e-5
MAX_DEPTH_ERR = 1e-4
BOUNDARY_T = 6e-4
# Gradients: error over each output's largest magnitude.
MAX_GRAD_REL = 1e-3
# Preprocess on the device against the stored CPU prep.
PREP_LIMITS = {"prep_xy_maxdiff_px": 0.05, "prep_depth_maxdiff": 1e-4,
               "prep_rgb_maxdiff": 1e-4, "prep_conic_relmax": 1e-3,
               "prep_tile_flip_frac": 0.01}

FWD_NAMES = ("color", "depth", "final_t", "n_contrib")
GRAD_NAMES = ("d_color", "d_mean2d", "d_conic", "d_opac", "d_invdepth")


class Gate(NamedTuple):
    settings: RenderSettings
    prep: PreprocessOut
    pairs: Pairs
    dl_dpix: torch.Tensor     # (T, 256, 3)
    ct_d: torch.Tensor        # (T, 256) inverse-depth cotangent
    bg: torch.Tensor          # (3,) zeros
    stored: dict              # the npz arrays


def _resolve(device) -> torch.device:
    from gstpu_torch.render import resolve_device
    return resolve_device(device)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def load_gate(device=None, golden_path: Path = GOLDEN_PATH) -> Gate:
    """The stored gate's inputs on ``device``."""
    device = _resolve(device)
    g = dict(np.load(golden_path))
    return Gate(
        settings=RenderSettings(width=SIZE, height=SIZE,
                                pair_capacity=PAIR_CAPACITY),
        prep=convert.prep_from_numpy(g, device),
        pairs=convert.pairs_from_numpy(g, device),
        dl_dpix=torch.tensor(g["dl_dpix"], device=device),
        ct_d=torch.tensor(g["ct_d"], device=device),
        bg=torch.zeros(3, dtype=torch.float32, device=device), stored=g)


def gate_forward(gate: Gate, composite_forward=None) -> dict:
    """{color, depth, final_t, n_contrib} tensors of the forward on the
    stored inputs (``cuda_rasterize.composite_forward`` by default)."""
    fn = composite_forward or cuda_rasterize.composite_forward
    return dict(zip(FWD_NAMES, fn(gate.prep, gate.pairs, gate.settings)))


def gate_backward(gate: Gate, fwd: dict, composite_backward=None) -> dict:
    """{d_color, ..., d_invdepth} tensors of the backward on the stored
    inputs and cotangents, from the forward outputs ``fwd``
    (``cuda_rasterize.composite_backward``, K2 and its epilogue, by
    default)."""
    fn = composite_backward or cuda_rasterize.composite_backward
    return dict(zip(GRAD_NAMES, fn(
        gate.prep, gate.pairs, gate.settings, fwd["color"], fwd["final_t"],
        gate.dl_dpix, gate.bg, depth_acc=fwd["depth"],
        dl_ddepth=gate.ct_d)))


def forward_errors(got, want) -> dict:
    """Forward outputs against a reference: flip fraction; the largest
    color, depth and final-T errors off boundary pixels; the largest color
    error over all pixels.  ``got`` and ``want`` are dicts keyed
    ``FWD_NAMES`` or tuples in that order, of tensors or arrays."""
    def named(x):
        x = x if isinstance(x, dict) else dict(zip(FWD_NAMES, x))
        return [_numpy(x[k]) for k in FWD_NAMES]

    gc, gd, gt, gn = named(got)
    wc, wd, wt, wn = named(want)
    flips = gn != wn
    boundary = flips | (gt < BOUNDARY_T) | (wt < BOUNDARY_T)
    return {
        "flip_frac": float(flips.mean()),
        "color_err": float(np.where(boundary[..., None], 0.0,
                                    np.abs(gc - wc)).max()),
        "depth_err": float(np.where(boundary, 0.0, np.abs(gd - wd)).max()),
        "final_t_err": float(np.where(boundary, 0.0, np.abs(gt - wt)).max()),
        "color_err_all_pixels": float(np.abs(gc - wc).max()),
    }


def grad_errors(got, want, tol: float = MAX_GRAD_REL) -> dict:
    """Per output, in float64: the largest error and the share of elements
    over ``tol``, both over the output's largest magnitude, and the largest
    absolute error.  Outputs are dicts by name, or tuples in the order of
    ``GRAD_NAMES``."""
    def named(x):
        return x if isinstance(x, dict) else dict(zip(GRAD_NAMES, x))

    got, want = named(got), named(want)
    res = {}
    for name in want:
        a = _numpy(got[name]).astype(np.float64)
        b = _numpy(want[name]).astype(np.float64)
        scale = max(float(np.abs(b).max()), 1e-12)
        err = np.abs(a - b) / scale
        res[name] = {"rel_max": float(err.max()),
                     "over_tol_frac": float((err > tol).mean()),
                     "abs_max": float(np.abs(a - b).max())}
    return res


def gate_inputs(device) -> tuple:
    """The arguments of ``preprocess`` for the gate scene (seed 3, 8,000
    Gaussians, 160x160, SH degree 3) on ``device``."""
    rng = np.random.default_rng(SEED)
    cam = scenes.example_camera(width=SIZE, height=SIZE)
    pts, shs, scales, rotations, opacities = scenes.random_scene(
        rng, n=N, extent=1.3, z_center=-8.0,
        opacity_range=(0.05, 0.95), scale_range=(0.01, 0.08))
    settings = RenderSettings(width=SIZE, height=SIZE,
                              pair_capacity=PAIR_CAPACITY)

    def t(x):
        return torch.tensor(np.asarray(x), device=device)

    return (t(pts), t(scales), t(rotations), t(opacities), t(shs),
            t(cam["view"]), t(cam["proj"]), t(cam["campos"]), SIZE, SIZE,
            cam["tan_fovx"], cam["tan_fovy"], settings.grid_x,
            settings.grid_y, 3)


def _scene(device) -> PreprocessOut:
    """The port's preprocess of the gate scene.  The rest of
    ``pallas_check._scene`` (binning, cotangents) only feeds the stored
    golden, which is the JAX package's."""
    return cuda_preprocess.preprocess(*gate_inputs(device))


def preprocess_backend_parity(golden_path: Path = GOLDEN_PATH,
                              device=None) -> dict:
    """The port's preprocess of the gate scene on ``device`` against the
    stored CPU prep: the largest xy (pixels), depth and rgb differences, the
    conic difference over the conic's largest magnitude, and the share of
    Gaussians whose tile count differs (ties may flip under float32
    reassociation); ``ok`` within ``PREP_LIMITS``."""
    g = np.load(golden_path)
    prep = _scene(_resolve(device))
    conic_scale = float(np.abs(g["prep_conic"]).max()) or 1.0
    res = {
        "prep_xy_maxdiff_px": float(np.abs(_numpy(prep.xy)
                                           - g["prep_xy"]).max()),
        "prep_depth_maxdiff": float(np.abs(_numpy(prep.depth)
                                           - g["prep_depth"]).max()),
        "prep_rgb_maxdiff": float(np.abs(_numpy(prep.rgb)
                                         - g["prep_rgb"]).max()),
        "prep_conic_relmax": float(np.abs(_numpy(prep.conic)
                                          - g["prep_conic"]).max()
                                   / conic_scale),
        "prep_tile_flip_frac": float((_numpy(prep.tiles_touched)
                                      != g["prep_tiles_touched"]).mean()),
    }
    res["ok"] = all(res[k] < limit for k, limit in PREP_LIMITS.items())
    return res


def compiled_parity_check(golden_path: Path = GOLDEN_PATH,
                          device=None) -> dict:
    """K1, then K2 with its epilogue, on the stored inputs against the
    stored outputs, and ``preprocess_backend_parity``; returns the
    differences and ``ok``."""
    device = _resolve(device)
    gate = load_gate(device, golden_path)
    fwd = gate_forward(gate)
    bwd = gate_backward(gate, fwd)
    f_err = forward_errors(fwd, {k: gate.stored[k] for k in FWD_NAMES})
    result = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "num_pairs": int(gate.pairs.num_pairs),
        "flip_frac": f_err["flip_frac"],
        "fwd_color_maxdiff": f_err["color_err"],
        "fwd_depth_maxdiff": f_err["depth_err"],
    }
    g_err = grad_errors(bwd, {k: gate.stored[f"g_{k}"] for k in GRAD_NAMES})
    for k in GRAD_NAMES:
        result[f"bwd_{k}_relmax"] = g_err[k]["rel_max"]
    grad_ok = all(e["rel_max"] < MAX_GRAD_REL for e in g_err.values())
    prep_res = preprocess_backend_parity(golden_path, device)
    prep_ok = prep_res.pop("ok")
    result.update(prep_res)
    result["prep_ok"] = prep_ok
    result["ok"] = bool(grad_ok and f_err["color_err"] < MAX_COLOR_ERR
                        and f_err["depth_err"] < MAX_DEPTH_ERR
                        and f_err["flip_frac"] < MAX_FLIP_FRAC and prep_ok)
    return result
