"""Cameras and projection matrices (NumPy).

Port of ``gstpu/utils/camera.py`` without flax.  The reference camera
semantics are kept exactly:

- OpenGL/Blender camera-to-world axes are flipped to COLMAP convention via
  ``c2w[:3, 1:3] *= -1``;
- view and projection matrices are stored transposed (row-vector
  convention): points transform as ``p_view = [p, 1] @ view``;
- ``full_proj = world_to_camera_T @ proj_T``;
- the projection matrix is the z_sign=+1, z in [0, 1] OpenGL-style matrix.

``load_camera_from_json``, ``save_cameras_json`` and ``load_nerf_cameras``
read a transforms-style JSON, write the official 3DGS viewer's
``cameras.json`` and parse a NeRF-synthetic split.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, List, Tuple

import numpy as np

from gstpu_torch.utils.image import imread


@dataclasses.dataclass
class Camera:
    """One camera, ready to feed the renderer.

    ``view`` and ``proj`` are the transposed (row-vector convention)
    world-to-camera and full projection matrices.
    """

    view: Any          # (4, 4) f32, transposed world-to-camera
    proj: Any          # (4, 4) f32, transposed full projection (w2c @ P^T)
    campos: Any        # (3,) f32 camera center in world space
    tan_fovx: float = 0.5
    tan_fovy: float = 0.5
    width: int = 256
    height: int = 256


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray | None = None,
                  scale: float = 1.0) -> np.ndarray:
    """World-to-view matrix from rotation and translation (stores ``R.T`` in
    the rotation block, as the reference does)."""
    if translate is None:
        translate = np.zeros(3)
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = np.asarray(t)
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    cam_center = (c2w[:3, 3] + translate) * scale
    c2w[:3, 3] = cam_center
    return np.linalg.inv(c2w).astype(np.float32)


def projection_matrix(fovx: float, fovy: float, znear: float,
                      zfar: float) -> np.ndarray:
    """OpenGL-style projection with z_sign=+1 and z mapped to [0, 1]."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4))
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def load_camera(camera_info: Dict[str, Any],
                znear: float = 0.01, zfar: float = 100.0) -> Dict[str, Any]:
    """Load one camera from a NeRF-style dict.

    Returns a dict with the keys the training loop consumes
    (``world_to_camera``, ``full_proj_matrix``, ``camera_center``,
    ``tan_fovx/y``, ``width``, ``height``) plus a ready ``Camera``.
    """
    c2w = np.asarray(camera_info["camera_to_world"], dtype=np.float64).copy()
    # OpenGL/Blender (Y up, Z back) -> COLMAP (Y down, Z forward).
    c2w[:3, 1:3] *= -1
    w2c = np.linalg.inv(c2w).astype(np.float32)
    R = w2c[:3, :3]
    T = w2c[:3, 3]
    w2c[3, 3] = 1.0
    w2c_T = w2c.T.copy()

    width = camera_info["width"]
    height = camera_info["height"]
    focal = camera_info["focal"]
    fovx = 2 * np.arctan(width / (2 * focal))
    fovy = 2 * np.arctan(height / (2 * focal))

    proj_T = projection_matrix(fovx=fovx, fovy=fovy, znear=znear, zfar=zfar).T
    full_proj = (w2c_T @ proj_T).astype(np.float32)
    tan_fovx = float(np.tan(fovx * 0.5))
    tan_fovy = float(np.tan(fovy * 0.5))
    camera_center = np.linalg.inv(w2c_T)[3, :3].astype(np.float32)

    cam = Camera(
        view=w2c_T.astype(np.float32),
        proj=full_proj,
        campos=camera_center,
        tan_fovx=tan_fovx,
        tan_fovy=tan_fovy,
        width=int(width),
        height=int(height),
    )
    return {
        "R": R,
        "T": T,
        "camera_center": camera_center,
        "world_to_camera": w2c_T.astype(np.float32),
        "full_proj_matrix": full_proj,
        "tan_fovx": tan_fovx,
        "tan_fovy": tan_fovy,
        "width": int(width),
        "height": int(height),
        "camera": cam,
        # parsed but unapplied, as in the reference: the rasterizer is
        # pinhole-only
        "camera_type": camera_info.get("camera_type", "perspective"),
        "distortion_params": camera_info.get("distortion_params",
                                             [0.0, 0.0, 0.0, 0.0]),
    }


def look_at_c2w(eye: np.ndarray) -> np.ndarray:
    """OpenGL/Blender camera-to-world looking from ``eye`` at the origin."""
    fwd = -eye / np.linalg.norm(eye)           # camera looks along -Z
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


def orbit_camera(theta: float, radius: float, height: float, size: int,
                 camera_angle_x: float) -> Dict[str, Any]:
    """Square ``size`` x ``size`` camera on a circle of ``radius`` at
    ``height`` above the origin, looking at it, with horizontal field of
    view ``camera_angle_x`` (Lego's is 0.6911112070083618)."""
    eye = np.array([radius * np.cos(theta), radius * np.sin(theta), height])
    c2w = look_at_c2w(eye)
    focal = 0.5 * size / np.tan(0.5 * camera_angle_x)
    return load_camera({"camera_id": 0, "camera_to_world": c2w,
                        "width": size, "height": size, "focal": focal})


def load_camera_from_json(json_path: str, camera_id: int = 0,
                          znear: float = 0.01, zfar: float = 100.0):
    """Load one camera from a transforms-style JSON file (frame
    ``camera_id``; width and height from ``w``/``width`` and
    ``h``/``height``, else 800)."""
    with open(json_path) as f:
        transforms = json.load(f)
    frame = transforms["frames"][camera_id]
    width = transforms.get("w") or transforms.get("width") or 800
    height = transforms.get("h") or transforms.get("height") or 800
    focal = 0.5 * width / np.tan(0.5 * transforms["camera_angle_x"])
    info = {"camera_id": camera_id,
            "camera_to_world": frame["transform_matrix"],
            "width": width, "height": height, "focal": focal,
            "camera_type": frame.get("camera_type", "perspective"),
            "distortion_params": frame.get("distortion_params",
                                           [0.0, 0.0, 0.0, 0.0])}
    return load_camera(info, znear=znear, zfar=zfar)


def save_cameras_json(cameras: List[Dict[str, Any]], path,
                      image_names: List[str] | None = None) -> None:
    """Write the official 3DGS viewer ``cameras.json``: one entry per
    camera with id, img_name, width, height, position, rotation (the
    camera-to-world 3x3), fx and fy."""
    entries = []
    for i, cam in enumerate(cameras):
        R_w2c = np.asarray(cam["R"], np.float64)
        name = image_names[i] if image_names else f"{i:05d}"
        entries.append({
            "id": i,
            "img_name": os.path.splitext(os.path.basename(name))[0],
            "width": int(cam["width"]),
            "height": int(cam["height"]),
            "position": [float(x) for x in cam["camera_center"]],
            "rotation": [[float(x) for x in row] for row in R_w2c.T],
            "fx": float(cam["width"] / (2.0 * cam["tan_fovx"])),
            "fy": float(cam["height"] / (2.0 * cam["tan_fovy"])),
        })
    with open(path, "w") as f:
        json.dump(entries, f)


def load_nerf_cameras(dataset_path: str, split: str,
                      downscale: int = 1) -> Tuple[List[Dict[str, Any]],
                                                   List[str]]:
    """Parse ``transforms_{split}.json`` of a NeRF-synthetic dataset:
    (cameras, image paths).  The image size is read from the first frame;
    ``downscale`` divides it (official 3DGS ``-r``) and the pixel focal with
    it, so the field of view is unchanged."""
    transforms_path = os.path.join(dataset_path, f"transforms_{split}.json")
    with open(transforms_path) as f:
        transforms = json.load(f)

    first = transforms["frames"][0]
    img = imread(os.path.join(dataset_path, first["file_path"] + ".png"))
    height, width = img.shape[0] // downscale, img.shape[1] // downscale
    focal = 0.5 * width / np.tan(0.5 * transforms["camera_angle_x"])

    cameras, image_paths = [], []
    for i, frame in enumerate(transforms["frames"]):
        cameras.append(load_camera({
            "camera_id": i, "camera_to_world": frame["transform_matrix"],
            "width": width, "height": height, "focal": focal}))
        image_paths.append(os.path.join(dataset_path,
                                        frame["file_path"] + ".png"))
    return cameras, image_paths
