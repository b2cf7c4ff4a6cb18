"""NeRF-synthetic dataset (``transforms_{split}.json`` and PNG frames).

Port of ``gstpu/data/nerf.py``, with the reference loader's semantics:

- image size read from the first frame, focal from ``camera_angle_x``;
- images scaled to [0, 1] and the alpha channel *dropped*, with no
  background compositing (Q10, the reference on its black-background
  default); ``white_background=True`` composites over white instead;
- frames decoded once and cached as uint8, turned into float32 on demand;
- ``downscale`` renders at 1/N of the capture size (PIL bilinear, as the
  official 3DGS ``-r``);
- ``depth()`` reads the ``*_depth_*.png`` companion of a frame.

Frames are read with ``utils.image.imread`` and resized with PIL, which is
imported where it is used, so the module imports without it.  Arrays are
NumPy; the caller moves them to a device.
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import numpy as np

from gstpu_torch.utils.camera import load_nerf_cameras
from gstpu_torch.utils.image import imread


def resize_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Resize a (H, W[, C]) uint8 image with PIL's bilinear filter, one
    channel at a time."""
    if img.shape[0] == height and img.shape[1] == width:
        return img
    from PIL import Image

    if img.ndim == 2:
        return np.asarray(Image.fromarray(img).resize(
            (width, height), Image.BILINEAR))
    chans = [np.asarray(Image.fromarray(img[..., c]).resize(
        (width, height), Image.BILINEAR)) for c in range(img.shape[-1])]
    return np.stack(chans, axis=-1)


class NerfSyntheticDataset:
    def __init__(self, dataset_path: str, split: str = "train",
                 cache_images: bool = True,
                 white_background: bool = False, downscale: int = 1):
        self.dataset_path = dataset_path
        self.split = split
        self.white_background = white_background
        self.downscale = int(downscale)
        self.cameras, self.image_paths = load_nerf_cameras(
            dataset_path, split, downscale=self.downscale)
        self._cache: Dict[int, np.ndarray] = {}
        self._cache_enabled = cache_images

    def __len__(self) -> int:
        return len(self.cameras)

    @property
    def width(self) -> int:
        return self.cameras[0]["width"]

    @property
    def height(self) -> int:
        return self.cameras[0]["height"]

    def _load_u8(self, idx: int) -> np.ndarray:
        img = imread(self.image_paths[idx])
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        return resize_u8(img, self.width, self.height)

    def image(self, idx: int) -> np.ndarray:
        """(H, W, 3) float32 in [0, 1]."""
        if self._cache_enabled and idx in self._cache:
            u8 = self._cache[idx]
        else:
            u8 = self._load_u8(idx)
            if self._cache_enabled:
                self._cache[idx] = u8
        img = u8.astype(np.float32) / 255.0
        if img.shape[-1] == 4:
            if self.white_background:
                rgb, a = img[..., :3], img[..., 3:]
                img = rgb * a + (1.0 - a)
            else:
                img = img[..., :3]      # the reference drops alpha
        return img

    def camera(self, idx: int):
        return self.cameras[idx]

    def depth_path(self, idx: int) -> str | None:
        """The first ``<frame>_depth_*.png`` beside frame ``idx``, if any."""
        base, _ = os.path.splitext(self.image_paths[idx])
        hits = sorted(glob.glob(f"{base}_depth_*.png"))
        return hits[0] if hits else None

    @property
    def has_depth(self) -> bool:
        return len(self) > 0 and self.depth_path(0) is not None

    def depth(self, idx: int):
        """(target inverse depth (H, W) f32 in [0, 1], mask (H, W) f32).

        The PNGs are normalized inverse-depth pictures (larger is closer, 0
        is background); callers scale by ``depth_scale`` onto the rendered
        inverse-depth channel.  The mask marks pixels with geometry.
        """
        path = self.depth_path(idx)
        if path is None:
            raise FileNotFoundError(
                f"no *_depth_*.png next to {self.image_paths[idx]}")
        img = imread(path)
        if img.ndim == 3:
            img = img[..., 0]
        img = resize_u8(img, self.width, self.height)
        d = img.astype(np.float32) / 255.0
        return d, (d > 0).astype(np.float32)
