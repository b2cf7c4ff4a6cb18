"""Render a turntable animation of a trained point cloud.

Port of ``scripts/render_turntable.py``:

    python -m gstpu_torch.render_turntable --ply out/point_cloud/iteration_6999/point_cloud.ply

``--frames`` views on a circle of ``--radius`` at ``--height`` around the
origin, ``--size`` pixels square with the horizontal field of view
``--fov`` (Lego's by default), written as a looping GIF through PIL.
``--device cpu`` runs the plain PyTorch path (default: the CUDA card).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gstpu_torch.config import RenderSettings
from gstpu_torch.ops.rasterize import render_forward
from gstpu_torch.render import resolve_device
from gstpu_torch.utils.camera import load_camera
from gstpu_torch.utils.ply import load_ply, render_space_params

FRAME_MS = 50


def look_at_c2w(eye: np.ndarray) -> np.ndarray:
    """OpenGL/Blender camera-to-world looking from ``eye`` at the origin
    (a copy of ``scripts/make_tiny_nerf.look_at_c2w``)."""
    fwd = -eye / np.linalg.norm(eye)           # the camera looks along -Z
    world_up = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, world_up)
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = up
    c2w[:3, 2] = -fwd
    c2w[:3, 3] = eye
    return c2w


def orbit_camera(theta: float, radius: float, height: float, width: int,
                 size: int, camera_angle_x: float):
    """The camera dict of the orbit view at angle ``theta``."""
    eye = np.array([radius * np.cos(theta), radius * np.sin(theta), height])
    c2w = look_at_c2w(eye)
    focal = 0.5 * width / np.tan(0.5 * camera_angle_x)
    return load_camera({"camera_id": 0, "camera_to_world": c2w,
                        "width": width, "height": size, "focal": focal})


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Render a turntable GIF")
    ap.add_argument("--ply", required=True)
    ap.add_argument("--out", default="turntable.gif")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--size", type=int, default=400)
    ap.add_argument("--radius", type=float, default=4.0)
    ap.add_argument("--height", type=float, default=1.5)
    ap.add_argument("--fov", type=float, default=0.6911112070083618)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path)")
    return ap.parse_args(argv)


def render_frames(args: argparse.Namespace) -> list:
    """The turntable's (size, size, 3) uint8 frames."""
    device = resolve_device(args.device)
    params = render_space_params(load_ply(args.ply))
    n = params["positions"].shape[0]
    settings = RenderSettings(width=args.size, height=args.size,
                              pair_capacity=1 << 20)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    arrs = (t(params["positions"]), t(params["scales"]),
            t(params["rotations"]), t(params["opacities"]),
            t(params["shs"]).reshape(n, 16, 3))
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    cam0 = orbit_camera(0.0, args.radius, args.height, args.size, args.size,
                        args.fov)
    frames = []
    for i in range(args.frames):
        cam = orbit_camera(2 * np.pi * i / args.frames, args.radius,
                           args.height, args.size, args.size, args.fov)
        with torch.no_grad():
            img, _, _ = render_forward(
                settings, cam0["tan_fovx"], cam0["tan_fovy"], 1.0, *arrs,
                t(cam["world_to_camera"]), t(cam["full_proj_matrix"]),
                t(cam["camera_center"]), bg)
        img = torch.clamp(img, 0.0, 1.0)
        frames.append((img.cpu().numpy() * 255).astype(np.uint8))
    return frames


def main(argv=None) -> list:
    """Render the turntable and write the GIF; returns the frames."""
    from PIL import Image

    args = parse_args(argv)
    frames = render_frames(args)
    images = [Image.fromarray(f) for f in frames]
    images[0].save(args.out, save_all=True, append_images=images[1:],
                   loop=0, duration=FRAME_MS)
    print(f"wrote {args.frames}-frame turntable to {args.out}")
    return frames


if __name__ == "__main__":
    main()
