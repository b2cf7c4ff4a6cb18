"""The port's NeRF loader and camera JSON I/O against gstpu's (CPU).

On the dataset that ``scripts/make_tiny_nerf.py`` writes (64x64, 4 train
and 2 val frames with ``*_depth_*.png`` companions), with one train frame
rewritten with a varying alpha so that ``white_background`` composites
something: cameras field for field, images, depths and masks equal to
gstpu's at ``downscale`` 1 and 2, with and without ``white_background``;
``load_camera_from_json`` and ``save_cameras_json`` equal to gstpu's, and
the saved pose giving back the loaded camera.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from gstpu.data import nerf as jax_nerf
from gstpu.utils import camera as jax_camera
from gstpu_torch.data import nerf
from gstpu_torch.utils import camera
from scripts.make_tiny_nerf import make_dataset

CAMERA_KEYS = ("R", "T", "camera_center", "world_to_camera",
               "full_proj_matrix", "tan_fovx", "tan_fovy", "width", "height",
               "camera_type", "distortion_params")
CAMERA_FIELDS = ("view", "proj", "campos", "tan_fovx", "tan_fovy", "width",
                 "height")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    import imageio.v2 as imageio

    root = tmp_path_factory.mktemp("tiny_nerf")
    make_dataset(root)
    path = root / "train" / "r_1.png"
    img = imageio.imread(path)
    yy, xx = np.mgrid[0:img.shape[0], 0:img.shape[1]]
    img[..., 3] = ((xx + 2 * yy) * 255 // (3 * img.shape[0])).astype(np.uint8)
    imageio.imwrite(path, img)
    return str(root)


def _assert_camera_equal(got, want):
    for k in CAMERA_KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    for k in CAMERA_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got["camera"], k)),
                                      np.asarray(getattr(want["camera"], k)),
                                      err_msg=k)


@pytest.mark.parametrize("split,downscale", [("train", 1), ("val", 2)])
def test_nerf_cameras_match_gstpu(tiny, split, downscale):
    got, got_paths = camera.load_nerf_cameras(tiny, split, downscale)
    want, want_paths = jax_camera.load_nerf_cameras(tiny, split, downscale)
    assert got_paths == want_paths and len(got) == len(want) > 1
    for a, b in zip(got, want):
        _assert_camera_equal(a, b)
    assert got[0]["width"] == 64 // downscale


@pytest.mark.parametrize("downscale,white", [(1, False), (1, True),
                                             (2, False), (2, True)])
def test_nerf_dataset_matches_gstpu(tiny, downscale, white):
    got = nerf.NerfSyntheticDataset(tiny, "train", white_background=white,
                                    downscale=downscale)
    want = jax_nerf.NerfSyntheticDataset(tiny, "train",
                                         white_background=white,
                                         downscale=downscale)
    assert len(got) == len(want) == 4
    assert (got.width, got.height) == (want.width, want.height) \
        == (64 // downscale, 64 // downscale)
    assert got.has_depth and want.has_depth
    for i in range(len(got)):
        _assert_camera_equal(got.camera(i), want.camera(i))
        img = got.image(i)
        assert img.dtype == np.float32 and img.shape == (got.height,
                                                         got.width, 3)
        np.testing.assert_array_equal(img, want.image(i))
        np.testing.assert_array_equal(got.image(i), img)      # from the cache
        assert got.depth_path(i) == want.depth_path(i)
        for a, b in zip(got.depth(i), want.depth(i)):
            np.testing.assert_array_equal(a, b)
    plain = nerf.NerfSyntheticDataset(tiny, "train", downscale=downscale)
    differs = not np.array_equal(plain.image(1), got.image(1))
    assert differs == white            # frame 1 has a varying alpha


def test_resize_u8_matches_gstpu():
    rng = np.random.default_rng(5)
    for shape in ((20, 30), (20, 30, 4)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(nerf.resize_u8(img, 13, 7),
                                      jax_nerf.resize_u8(img, 13, 7))
        assert nerf.resize_u8(img, 30, 20) is img


def test_camera_json_round_trip(tiny, tmp_path):
    path = f"{tiny}/transforms_train.json"
    n = len(json.loads(Path(path).read_text())["frames"])
    cams = []
    for i in range(n):
        cam = camera.load_camera_from_json(path, i)
        _assert_camera_equal(cam, jax_camera.load_camera_from_json(path, i))
        cams.append(cam)
    names = [f"./train/r_{i}.png" for i in range(n)]
    camera.save_cameras_json(cams, tmp_path / "port.json", names)
    jax_camera.save_cameras_json(cams, tmp_path / "ref.json", names)
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    for cam, entry in zip(cams, json.loads(
            (tmp_path / "port.json").read_text())):
        c2w_rot = np.asarray(entry["rotation"])
        position = np.asarray(entry["position"])
        assert entry["img_name"] == f"r_{entry['id']}"
        np.testing.assert_allclose(c2w_rot.T, cam["R"], atol=1e-6)
        np.testing.assert_allclose(position, cam["camera_center"], atol=1e-6)
        np.testing.assert_allclose(-c2w_rot.T @ position, cam["T"],
                                   atol=1e-5)
        assert entry["fx"] == pytest.approx(
            cam["width"] / (2.0 * cam["tan_fovx"]))
