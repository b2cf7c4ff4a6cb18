"""COLMAP (SfM) captures: the sparse reconstruction and its images.

Port of ``gstpu/data/colmap.py`` (NumPy).  It parses the standard COLMAP
binary and text models (``sparse/0/{cameras,images,points3D}.bin|txt``)
and gives the interface of ``NerfSyntheticDataset``, plus ``points3d()``
for ``models.gaussians.init_model_from_points``.

Conventions: COLMAP stores the world-to-camera rotation as a (w, x, y, z)
quaternion and a translation, already the renderer's camera convention, so
no axis flip is applied.  Distortion parameters are parsed and not applied
(the rasterizer is pinhole-only).

The train/test split is the official 3DGS eval protocol: every
``holdout``-th image (sorted by name) is test, the rest train;
``holdout=0`` puts everything in train.
"""

from __future__ import annotations

import os
import struct
from typing import Dict

import numpy as np

from gstpu_torch.data.nerf import resize_u8
from gstpu_torch.utils.camera import projection_matrix
from gstpu_torch.utils.image import imread

# COLMAP camera models: id -> (name, num_params, (fx_i, fy_i, cx_i, cy_i))
# fx_i == fy_i for single-focal models.
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3, (0, 0, 1, 2)),
    1: ("PINHOLE", 4, (0, 1, 2, 3)),
    2: ("SIMPLE_RADIAL", 4, (0, 0, 1, 2)),
    3: ("RADIAL", 5, (0, 0, 1, 2)),
    4: ("OPENCV", 8, (0, 1, 2, 3)),
    5: ("OPENCV_FISHEYE", 8, (0, 1, 2, 3)),
    6: ("FULL_OPENCV", 12, (0, 1, 2, 3)),
    7: ("FOV", 5, (0, 1, 2, 3)),
    8: ("SIMPLE_RADIAL_FISHEYE", 4, (0, 0, 1, 2)),
    9: ("RADIAL_FISHEYE", 5, (0, 0, 1, 2)),
    10: ("THIN_PRISM_FISHEYE", 12, (0, 1, 2, 3)),
}
_MODEL_BY_NAME = {name: (mid, n, idx)
                  for mid, (name, n, idx) in _CAMERA_MODELS.items()}


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> Dict[int, dict]:
    """cameras.bin -> {camera_id: {model, width, height, params}}."""
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params, _ = _CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            out[cam_id] = {"model": name, "width": int(w), "height": int(h),
                           "params": params}
    return out


def read_images_binary(path: str) -> Dict[int, dict]:
    """images.bin -> {image_id: {qvec, tvec, camera_id, name}} (2D points
    skipped — only the poses matter here)."""
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            (image_id,) = _read(f, "<i")
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            (camera_id,) = _read(f, "<i")
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            (n_pts,) = _read(f, "<Q")
            f.seek(n_pts * 24, os.SEEK_CUR)  # 2x f64 xy + i64 point3D_id
            out[image_id] = {"qvec": qvec, "tvec": tvec,
                             "camera_id": camera_id,
                             "name": name.decode("utf-8")}
    return out


def read_points3d_binary(path: str):
    """points3D.bin -> (xyz (P,3) f32, rgb (P,3) f32 in [0,1])."""
    xyz, rgb = [], []
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            data = _read(f, "<Q3d3Bd")
            xyz.append(data[1:4])
            rgb.append(data[4:7])
            (track_len,) = _read(f, "<Q")
            f.seek(track_len * 8, os.SEEK_CUR)  # 2x i32 per track element
    return (np.asarray(xyz, np.float32).reshape(-1, 3),
            np.asarray(rgb, np.float32).reshape(-1, 3) / 255.0)


def read_cameras_text(path: str) -> Dict[int, dict]:
    out = {}
    for line in open(path):
        if line.startswith("#") or not line.strip():
            continue
        parts = line.split()
        mid, n_params, _ = _MODEL_BY_NAME[parts[1]]
        out[int(parts[0])] = {
            "model": parts[1], "width": int(parts[2]),
            "height": int(parts[3]),
            "params": np.array([float(x) for x in parts[4:4 + n_params]])}
    return out


def read_images_text(path: str) -> Dict[int, dict]:
    out = {}
    # Every image record is a pose line followed by a 2D-points line.  The
    # points line is EMPTY for images without triangulated tracks, so the
    # pairing must be stateful — filtering blanks then striding by two would
    # shift every later record by one line.
    expect_pose = True
    for ln in open(path):
        if ln.startswith("#"):
            continue
        if not expect_pose:          # 2D-points line (may be blank)
            expect_pose = True
            continue
        if not ln.strip():           # stray blank between records
            continue
        p = ln.split()
        out[int(p[0])] = {"qvec": np.array([float(x) for x in p[1:5]]),
                          "tvec": np.array([float(x) for x in p[5:8]]),
                          "camera_id": int(p[8]), "name": p[9]}
        expect_pose = False
    return out


def read_points3d_text(path: str):
    xyz, rgb = [], []
    for ln in open(path):
        if ln.startswith("#") or not ln.strip():
            continue
        p = ln.split()
        xyz.append([float(x) for x in p[1:4]])
        rgb.append([float(x) for x in p[4:7]])
    return (np.asarray(xyz, np.float32).reshape(-1, 3),
            np.asarray(rgb, np.float32).reshape(-1, 3) / 255.0)


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> 3x3 world-to-camera rotation."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _camera_record(R: np.ndarray, t: np.ndarray, width: int, height: int,
                   fx: float, fy: float,
                   znear: float = 0.01, zfar: float = 100.0) -> dict:
    """Build the renderer-facing camera dict (same keys as
    utils/camera.load_camera) from a COLMAP world-to-camera pose."""
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = t
    w2c_T = w2c.T.astype(np.float32).copy()
    fovx = 2.0 * np.arctan(width / (2.0 * fx))
    fovy = 2.0 * np.arctan(height / (2.0 * fy))
    proj_T = projection_matrix(fovx=fovx, fovy=fovy,
                               znear=znear, zfar=zfar).T
    camera_center = (-R.T @ t).astype(np.float32)
    return {
        "R": w2c[:3, :3].astype(np.float32),
        "T": w2c[:3, 3].astype(np.float32),
        "camera_center": camera_center,
        "world_to_camera": w2c_T,
        "full_proj_matrix": (w2c_T @ proj_T).astype(np.float32),
        "tan_fovx": float(np.tan(fovx * 0.5)),
        "tan_fovy": float(np.tan(fovy * 0.5)),
        "width": int(width), "height": int(height),
        "camera_type": "perspective",
        "distortion_params": [0.0, 0.0, 0.0, 0.0],
    }


def _find_sparse_dir(root: str) -> str:
    for cand in ("sparse/0", "sparse"):
        d = os.path.join(root, cand)
        if (os.path.isfile(os.path.join(d, "cameras.bin"))
                or os.path.isfile(os.path.join(d, "cameras.txt"))):
            return d
    raise FileNotFoundError(
        f"no COLMAP model under {root}/sparse[/0] "
        "(cameras.bin or cameras.txt)")


def is_colmap_dataset(root: str) -> bool:
    try:
        _find_sparse_dir(root)
        return True
    except FileNotFoundError:
        return False


class ColmapDataset:
    """COLMAP capture with the ``NerfSyntheticDataset`` interface.

    ``split``: "train" keeps all but every ``holdout``-th image (sorted by
    file name, official 3DGS eval protocol); "test"/"val" keep the holdout
    images.  ``holdout=0`` disables the split (train gets everything and
    test/val raise FileNotFoundError like a missing NeRF split).
    """

    def __init__(self, dataset_path: str, split: str = "train",
                 cache_images: bool = True, white_background: bool = False,
                 holdout: int = 8, downscale: int = 1):
        self.dataset_path = dataset_path
        self.split = split
        self.white_background = white_background
        self.downscale = int(downscale)
        sparse = _find_sparse_dir(dataset_path)
        if os.path.isfile(os.path.join(sparse, "cameras.bin")):
            cams = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
            imgs = read_images_binary(os.path.join(sparse, "images.bin"))
            self._points_path = os.path.join(sparse, "points3D.bin")
        else:
            cams = read_cameras_text(os.path.join(sparse, "cameras.txt"))
            imgs = read_images_text(os.path.join(sparse, "images.txt"))
            self._points_path = os.path.join(sparse, "points3D.txt")

        img_dir = os.path.join(dataset_path, "images")
        if not os.path.isdir(img_dir):
            img_dir = dataset_path
        ordered = sorted(imgs.values(), key=lambda e: e["name"])
        if holdout > 0:
            is_test = [i % holdout == 0 for i in range(len(ordered))]
            keep = [e for e, t in zip(ordered, is_test)
                    if t == (split in ("test", "val"))]
        else:
            if split in ("test", "val"):
                raise FileNotFoundError(
                    f"holdout=0: no {split} split in COLMAP dataset")
            keep = ordered

        self.cameras, self.image_paths = [], []
        sizes = set()
        d = self.downscale
        for entry in keep:
            cam = cams[entry["camera_id"]]
            _, _, (fxi, fyi, _, _) = _MODEL_BY_NAME[cam["model"]]
            R = qvec_to_rotmat(entry["qvec"])
            # downscale divides pixel dimensions AND pixel focals together
            # (field of view unchanged — official 3DGS -r semantics)
            self.cameras.append(_camera_record(
                R, entry["tvec"], cam["width"] // d, cam["height"] // d,
                fx=cam["params"][fxi] / d, fy=cam["params"][fyi] / d))
            self.image_paths.append(os.path.join(img_dir, entry["name"]))
            sizes.add((cam["width"] // d, cam["height"] // d))
        if len(sizes) > 1:
            raise ValueError(
                f"mixed image sizes in COLMAP model: {sorted(sizes)} — "
                "the trainer renders at one fixed resolution")
        # mixed focal lengths are fine: each camera record carries its own
        # tan_fov, which the trainer passes per view
        self._cache: Dict[int, np.ndarray] = {}
        self._cache_enabled = cache_images

    # --- NerfSyntheticDataset interface ---

    def __len__(self) -> int:
        return len(self.cameras)

    @property
    def width(self) -> int:
        return self.cameras[0]["width"]

    @property
    def height(self) -> int:
        return self.cameras[0]["height"]

    def image(self, idx: int) -> np.ndarray:
        """(H, W, 3) float32 in [0, 1]."""
        if self._cache_enabled and idx in self._cache:
            u8 = self._cache[idx]
        else:
            u8 = imread(self.image_paths[idx])
            if u8.ndim == 2:
                u8 = np.stack([u8] * 3, -1)
            u8 = resize_u8(u8, self.width, self.height)
            if self._cache_enabled:
                self._cache[idx] = u8
        img = u8.astype(np.float32) / 255.0
        if img.shape[-1] == 4:
            if self.white_background:
                rgb, a = img[..., :3], img[..., 3:]
                img = rgb * a + (1.0 - a)
            else:
                img = img[..., :3]
        return img

    def camera(self, idx: int):
        return self.cameras[idx]

    def points3d(self):
        """SfM point cloud: (xyz (P,3) f32, rgb (P,3) f32 in [0,1])."""
        if self._points_path.endswith(".bin"):
            return read_points3d_binary(self._points_path)
        return read_points3d_text(self._points_path)

    @property
    def has_depth(self) -> bool:
        return False

    def depth_path(self, idx: int):
        return None

    def depth(self, idx: int):
        raise FileNotFoundError("COLMAP datasets carry no depth targets")
