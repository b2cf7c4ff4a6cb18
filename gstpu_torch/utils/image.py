"""Image files through PIL.

``imread`` is what the port's loaders call: PIL's decoding as an array,
with a palette image expanded to its palette's mode, which is what
``imageio`` (the JAX package's reader, itself on PIL) returns.  PIL is
imported where it is used, so the package imports without it.
"""

from __future__ import annotations

import numpy as np


def imread(path) -> np.ndarray:
    """An image file (PNG, JPEG, ...) as an array: (H, W) or (H, W, C)."""
    from PIL import Image

    with Image.open(path) as img:
        if img.mode == "P":
            img = img.convert(img.palette.mode)
        return np.asarray(img)


def imwrite(path, img: np.ndarray) -> None:
    """Write a (H, W[, C]) uint8 array; the format follows the suffix."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(img)).save(path)
