"""The port's image reader (``gstpu_torch/utils/image.py``, PIL) against
``imageio``, the JAX package's reader (CPU): the same arrays for every PNG
colour type the loaders meet, a 16-bit grey PNG and a JPEG, and a round
trip of ``imwrite``."""

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from gstpu_torch.utils.image import imread, imwrite


def _image(kind: str) -> np.ndarray:
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:37, 0:53]
    smooth = (np.stack([xx * 4, yy * 6, xx + yy], -1) % 256).astype(np.uint8)
    noisy = rng.integers(0, 256, (37, 53, 4), dtype=np.uint8)
    return {"rgb": smooth, "rgba": noisy, "grey": smooth[..., 0].copy(),
            "grey_alpha": noisy[..., :2].copy(),
            "grey16": (xx * 1200 + yy * 7).astype(np.uint16)}[kind]


@pytest.mark.parametrize("kind", ["rgb", "rgba", "grey", "grey_alpha",
                                  "grey16"])
def test_imread_matches_imageio_png(tmp_path, kind):
    img = _image(kind)
    path = tmp_path / f"{kind}.png"
    imageio.imwrite(path, img)
    got, want = imread(path), np.asarray(imageio.imread(path))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("alpha", [False, True])
def test_imread_matches_imageio_palette(tmp_path, alpha):
    img = Image.fromarray(_image("rgb")).quantize(16)
    if alpha:
        img.info["transparency"] = 3
    path = tmp_path / "palette.png"
    img.save(path)
    got, want = imread(path), np.asarray(imageio.imread(path))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_imread_matches_imageio_jpeg(tmp_path):
    path = tmp_path / "view.jpg"
    imageio.imwrite(path, _image("rgb"))
    got, want = imread(path), np.asarray(imageio.imread(path))
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["rgb", "rgba", "grey"])
def test_imwrite_round_trip(tmp_path, kind):
    img = _image(kind)
    path = tmp_path / f"{kind}.png"
    imwrite(path, img)
    np.testing.assert_array_equal(np.asarray(imageio.imread(path)), img)
