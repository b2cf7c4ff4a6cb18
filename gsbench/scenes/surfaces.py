"""The scene ``surfaces``: a seeded scene of a configuration, made on the
device.  A scene module gives ``make_cloud(cfg, seed, device)`` (the stored
parameters), ``cameras(cfg)``, ``split(cfg)`` (train and held-out views)
and ``targets(cfg, seed, count, device)``; a configuration names its scene
(``"scene"``), and the drivers use only these four.

No trained cloud or photos of the published scenes are on the machines, so
the cloud, the cameras and the training targets are made here, from
``--seed``, in a few large calls on the device:

- positions: most Gaussians on surfaces around the centre (spheres of the
  object, fixed by the configuration's ``structure_seed``, and a ground
  disc), the rest on a distant background shell, placed from the seed;
- scales: flat along the surface, two tangent axes from the surface area
  per Gaussian times the configuration's ``scale_factor``, a thin normal
  axis; rotations carry the surface frame, spun about the normal;
- opacities and SH from seeded distributions (SH DC from a smooth colour
  field, higher orders small);
- cameras on an orbit at two heights, looking at the centre; every
  ``eval_holdout``-th view is held out for evaluation;
- targets: seeded smooth images, one per training view.

Parameters are stored as training stores them: log scales and opacity
logits.  Cameras use the row-vector convention (a point goes to view
space as ``[p, 1] @ view``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SH_C0 = 0.28209479177387814


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(v.norm(dim=-1, keepdim=True), min=1e-12)


def _quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (x, y, z, w) quaternions."""
    av, aw = a[:, :3], a[:, 3:]
    bv, bw = b[:, :3], b[:, 3:]
    return torch.cat([aw * bv + bw * av + torch.cross(av, bv, dim=-1),
                      aw * bw - (av * bv).sum(-1, keepdim=True)], -1)


def _frame_quat(normal: torch.Tensor, spin: torch.Tensor) -> torch.Tensor:
    """The rotation that takes the local z axis to ``normal``, after a spin
    of ``spin`` radians about z."""
    z = torch.zeros_like(normal)
    z[:, 2] = 1.0
    cos = (normal * z).sum(-1, keepdim=True)
    axis = torch.cross(z, normal, dim=-1)
    flip = cos[:, 0] < -0.999999        # normal along -z: turn about x
    axis[flip] = torch.tensor([1.0, 0.0, 0.0], device=normal.device)
    cos = torch.where(flip[:, None], torch.zeros_like(cos), 1.0 + cos)
    align = _unit(torch.cat([axis, cos], -1))
    half = 0.5 * spin[:, None]
    twist = torch.cat([torch.zeros_like(normal[:, :2]), torch.sin(half),
                       torch.cos(half)], -1)
    return _unit(_quat_mul(align, twist))


def _surfaces(cfg: dict, gen: torch.Generator, device):
    """(positions, normals, area per Gaussian) of every Gaussian.  The
    surfaces themselves (the spheres' centres and radii) come from the
    configuration's ``structure_seed``, so every run seed gives the scene
    the same shape and work; the run's seed places the Gaussians on it."""
    s = cfg["assumed"]["surfaces"]
    n = cfg["gaussians"]
    n_blob = int(round(n * s["object_share"]))
    n_ground = int(round(n * s["ground_share"]))
    n_shell = n - n_blob - n_ground

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    # spheres of the object, sized by their share of its area
    shape = torch.Generator(device=device)
    shape.manual_seed(s["structure_seed"])
    k = s["object_spheres"]
    lo, hi = s["sphere_radius"]
    radii = lo + (hi - lo) * torch.rand(k, generator=shape, device=device)
    centres = (_unit(torch.randn((k, 3), generator=shape, device=device))
               * s["object_radius"]
               * torch.rand((k, 1), generator=shape, device=device) ** (1 / 3))
    centres[:, 2] = centres[:, 2].abs() * 0.5 + s["ground_height"] + radii * 0.5
    area = 4 * math.pi * radii ** 2
    which = torch.multinomial(area / area.sum(), n_blob, replacement=True,
                              generator=gen)
    nb = _unit(randn(n_blob, 3))
    pb = centres[which] + nb * radii[which, None]
    per_blob = torch.bincount(which, minlength=k).clamp(min=1).to(area.dtype)
    ab = (area / per_blob)[which]

    # ground disc
    rg = s["ground_radius"] * torch.sqrt(rand(n_ground))
    th = 2 * math.pi * rand(n_ground)
    pg = torch.stack([rg * torch.cos(th), rg * torch.sin(th),
                      torch.full_like(rg, s["ground_height"])], -1)
    ng = torch.zeros_like(pg)
    ng[:, 2] = 1.0
    ag = torch.full_like(rg, math.pi * s["ground_radius"] ** 2 / max(n_ground, 1))

    # background shell, facing the centre
    ns = _unit(randn(n_shell, 3))
    ns[:, 2] = ns[:, 2].abs() * 0.8 - 0.2
    ns = _unit(ns)
    ps = ns * s["shell_radius"]
    ash = torch.full((n_shell,), 4 * math.pi * s["shell_radius"] ** 2 / max(n_shell, 1),
                     device=device)
    return (torch.cat([pb, pg, ps]), torch.cat([nb, ng, -ns]),
            torch.cat([ab, ag, ash]))


def make_cloud(cfg: dict, seed: int, device) -> dict:
    """The stored parameters of the configuration's cloud for ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    a = cfg["assumed"]
    pos, normal, area = _surfaces(cfg, gen, device)
    n = len(pos)
    sigma = a["scale_factor"] * torch.sqrt(area)
    scales = torch.stack([sigma, sigma, sigma * a["thin_axis"]], -1)
    spin = 2 * math.pi * torch.rand(n, generator=gen, device=device)
    rotations = _frame_quat(normal, spin)
    o = a["opacity"]
    opaque = torch.rand(n, generator=gen, device=device) < o["opaque_share"]
    u = torch.rand(n, generator=gen, device=device)
    alpha = torch.where(opaque, o["opaque"][0] + (o["opaque"][1] - o["opaque"][0]) * u,
                        o["faint"][0] + (o["faint"][1] - o["faint"][0]) * u)
    sh = a["sh"]
    phase = 2 * math.pi * torch.rand((1, 3), generator=gen, device=device)
    colour = 0.5 + sh["colour_amplitude"] * torch.sin(
        sh["colour_frequency"] * pos.sum(-1, keepdim=True) + phase)
    shs = sh["rest_std"] * torch.randn((n, 16, 3), generator=gen, device=device)
    shs[:, 0] = (colour - 0.5) / SH_C0
    return {"positions": pos.contiguous(), "scales": torch.log(scales),
            "rotations": rotations.contiguous(),
            "opacities": torch.log(alpha / (1.0 - alpha)),
            "shs": shs.contiguous()}


def _projection(tan_x: float, tan_y: float, near: float, far: float) -> np.ndarray:
    p = np.zeros((4, 4))
    p[0, 0] = 1.0 / tan_x
    p[1, 1] = 1.0 / tan_y
    p[3, 2] = 1.0
    p[2, 2] = far / (far - near)
    p[2, 3] = -(far * near) / (far - near)
    return p


def cameras(cfg: dict) -> list[dict]:
    """Every view of the orbit: ``view``, ``proj`` (4x4, row-vector
    convention), ``campos``, ``tan_fovx``, ``tan_fovy`` as NumPy float32."""
    a = cfg["assumed"]
    orbit = a["orbit"]
    w, h = cfg["width"], cfg["height"]
    tan_x = math.tan(math.radians(a["fov_x_deg"]) / 2)
    tan_y = tan_x * h / w
    proj = _projection(tan_x, tan_y, a["near"], a["far"])
    out = []
    for i in range(cfg["views"]):
        theta = 2 * math.pi * i / cfg["views"]
        height = orbit["heights"][i % len(orbit["heights"])]
        eye = np.array([orbit["radius"] * math.cos(theta),
                        orbit["radius"] * math.sin(theta), height])
        look = np.array(orbit["look_at"], dtype=np.float64)
        fwd = (look - eye) / np.linalg.norm(look - eye)        # camera +z
        right = np.cross(np.array([0.0, 0.0, -1.0]), fwd)       # camera +x
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)                             # camera +y
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
        view = np.linalg.inv(c2w).T
        out.append({"view": view.astype(np.float32),
                    "proj": (view @ proj.T).astype(np.float32),
                    "campos": eye.astype(np.float32),
                    "tan_fovx": tan_x, "tan_fovy": tan_y})
    return out


def split(cfg: dict) -> tuple[list[int], list[int]]:
    """(train views, held-out views): every ``eval_holdout``-th is held out."""
    k = cfg["eval_holdout"]
    views = range(cfg["views"])
    return [i for i in views if i % k], [i for i in views if i % k == 0]


def targets(cfg: dict, seed: int, count: int, device,
            chunk: int = 16) -> torch.Tensor:
    """(count, H, W, 3) seeded smooth images in [0.15, 0.85]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    h, w = cfg["height"], cfg["width"]
    coarse = torch.rand((count, 3, max(h // 32, 2), max(w // 32, 2)),
                        generator=gen, device=device)
    out = torch.empty((count, h, w, 3), device=device)
    for i in range(0, count, chunk):
        up = F.interpolate(coarse[i:i + chunk], size=(h, w), mode="bilinear",
                           align_corners=False)
        out[i:i + chunk] = 0.15 + 0.7 * up.permute(0, 2, 3, 1)
    return out
