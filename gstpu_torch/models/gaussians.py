"""The Gaussian point cloud: a fixed-capacity masked set of parameters.

Port of ``gstpu/models/gaussians.py``.  Arrays keep a fixed ``capacity``
with an ``alive`` mask and an ``n_alive`` count; live Gaussians are compacted
at the front (indices [0, n_alive)), so densify's appends are cheap and the
render's pair list holds no dead entries.  Padded slots are culled by the
render like invisible Gaussians and left unchanged by Adam.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gstpu_torch.config import GSConfig

SH_C0 = 0.28209479177387814  # Y_00, as the preprocess evaluates it


@dataclasses.dataclass
class GaussianModel:
    """Parameters of N (= capacity) Gaussians; [0, n_alive) are live."""

    positions: torch.Tensor   # (C, 3) f32
    scales: torch.Tensor      # (C, 3) f32, raw (or logs when activated)
    rotations: torch.Tensor   # (C, 4) f32 quaternions (x, y, z, w)
    opacities: torch.Tensor   # (C,) f32, raw-clamped [0, 1] (or logits)
    shs: torch.Tensor         # (C, 16, 3) f32
    alive: torch.Tensor       # (C,) bool
    n_alive: torch.Tensor     # () int32

    @property
    def capacity(self) -> int:
        return self.positions.shape[0]

    def param_dict(self) -> dict[str, torch.Tensor]:
        return {"positions": self.positions, "scales": self.scales,
                "rotations": self.rotations, "opacities": self.opacities,
                "shs": self.shs}

    def replace(self, **kw) -> "GaussianModel":
        return dataclasses.replace(self, **kw)


def activate_params(params: dict[str, torch.Tensor],
                    parameterization: str) -> dict[str, torch.Tensor]:
    """Stored parameters to render-space parameters.

    "raw" (the reference): identity.  "activated" (official 3DGS): scales
    are stored as logs (exp) and opacities as logits (sigmoid); gradients
    flow through the activations to the stored values.
    """
    if parameterization == "raw":
        return params
    if parameterization != "activated":
        raise ValueError(f"unknown parameterization {parameterization!r}")
    return {**params, "scales": torch.exp(params["scales"]),
            "opacities": torch.sigmoid(params["opacities"])}


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def init_model(generator: torch.Generator, config: GSConfig,
               capacity: int | None = None, device=None) -> GaussianModel:
    """Random initialization of the reference recipe.

    - positions uniform in [-e, e]^3 (e = ``init_position_extent``),
      drawn from ``generator``;
    - isotropic scales ``initial_scale``;
    - identity rotations (0, 0, 0, 1) in the (x, y, z, w) convention;
    - opacity ``initial_opacity``, SH DC ``initial_sh_dc``, higher orders 0.

    ``torch.Generator`` and ``jax.random`` give different numbers from one
    seed: the distributions match, the draws do not.  The model goes to
    ``device`` (default: the CUDA card).
    """
    n = config.num_points
    if capacity is None:
        capacity = int(n * config.capacity_headroom)
    capacity = max(capacity, n)
    e = config.init_position_extent
    positions = (torch.rand((capacity, 3), generator=generator,
                            dtype=torch.float32) * (2.0 * e) - e)
    f32 = dict(dtype=torch.float32)
    init_scale, init_opac = config.initial_scale, config.initial_opacity
    if config.parameterization == "activated":
        init_scale = float(torch.log(torch.tensor(init_scale, **f32)))
        init_opac = float(inverse_sigmoid(torch.tensor(init_opac, **f32)))
    shs = torch.zeros((capacity, 16, 3), **f32)
    shs[:, 0, :] = config.initial_sh_dc
    model = GaussianModel(
        positions=positions,
        scales=torch.full((capacity, 3), init_scale, **f32),
        rotations=torch.tensor([0.0, 0.0, 0.0, 1.0], **f32).repeat(
            capacity, 1),
        opacities=torch.full((capacity,), init_opac, **f32),
        shs=shs, alive=torch.arange(capacity) < n,
        n_alive=torch.tensor(n, dtype=torch.int32))
    return _to(model, device)


def init_model_from_points(config: GSConfig, xyz, rgb,
                           capacity: int | None = None,
                           device=None) -> GaussianModel:
    """Initialization from a point cloud (official 3DGS recipe), on the
    host with NumPy and scipy:

    - positions at the points;
    - isotropic scales: the root of the mean squared distance to the 3
      nearest neighbours, floored at sqrt(1e-7);
    - SH DC from the point color, (rgb - 0.5) / C0;
    - identity rotations, opacity ``initial_opacity``.

    The model goes to ``device`` (default: the CUDA card).
    """
    from scipy.spatial import cKDTree

    xyz = np.asarray(xyz, np.float32)
    rgb = np.asarray(rgb, np.float32)
    n = xyz.shape[0]
    if capacity is None:
        capacity = int(n * config.capacity_headroom)
    capacity = max(capacity, n)

    # k=4: the point itself plus its 3 nearest neighbours
    dists, _ = cKDTree(xyz).query(xyz, k=min(4, n))
    dist2 = np.maximum((dists[:, 1:] ** 2).mean(axis=1)
                       if n > 1 else np.full(n, 1e-4), 1e-7)
    scale = np.sqrt(dist2).astype(np.float32)

    init_opac = config.initial_opacity
    scales_n = np.tile(scale[:, None], (1, 3))
    if config.parameterization == "activated":
        scales_n = np.log(scales_n)
        init_opac = float(np.log(init_opac / (1.0 - init_opac)))

    positions = np.zeros((capacity, 3), np.float32)
    positions[:n] = xyz
    scales = np.full((capacity, 3), scales_n[0, 0] if n else 0.0, np.float32)
    scales[:n] = scales_n
    shs = np.zeros((capacity, 16, 3), np.float32)
    shs[:n, 0, :] = (rgb - 0.5) / SH_C0
    rotations = np.tile(np.asarray([0.0, 0.0, 0.0, 1.0], np.float32),
                        (capacity, 1))
    opacities = np.full((capacity,), init_opac, np.float32)
    model = GaussianModel(
        positions=torch.from_numpy(positions),
        scales=torch.from_numpy(scales),
        rotations=torch.from_numpy(rotations),
        opacities=torch.from_numpy(opacities), shs=torch.from_numpy(shs),
        alive=torch.from_numpy(np.arange(capacity) < n),
        n_alive=torch.tensor(n, dtype=torch.int32))
    return _to(model, device)


def grow_capacity(model: GaussianModel, new_capacity: int) -> GaussianModel:
    """Pad every array with zeros (dead slots) to a larger capacity."""
    pad = new_capacity - model.capacity
    if pad < 0:
        raise ValueError(f"new capacity {new_capacity} is below the current "
                         f"{model.capacity}")

    def _pad(x):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    return GaussianModel(
        positions=_pad(model.positions), scales=_pad(model.scales),
        rotations=_pad(model.rotations), opacities=_pad(model.opacities),
        shs=_pad(model.shs), alive=_pad(model.alive), n_alive=model.n_alive)


def _to(model: GaussianModel, device) -> GaussianModel:
    # render imports convert, which imports this module
    from gstpu_torch.render import resolve_device

    device = resolve_device(device)
    return GaussianModel(**{f.name: getattr(model, f.name).to(device)
                            for f in dataclasses.fields(model)})
