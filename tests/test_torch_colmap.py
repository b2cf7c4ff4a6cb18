"""The port's COLMAP loader against gstpu's (CPU).

The captures are ``tests/test_colmap.py``'s synthetic models (one PINHOLE
camera, a ring of poses, coloured points, in the binary or text format; the
mixed-focal rig; fisheye camera models).  Cameras, image paths, images,
points and splits must equal gstpu's.
"""

import os
import struct

import numpy as np
import pytest

from gstpu.data import colmap as jax_colmap
from gstpu_torch.data import colmap
from tests.test_colmap import (FX, FY, H, N_IMAGES, W, _make_mixed_focal_rig,
                               _write_model)


def _assert_cameras_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)


def _assert_datasets_equal(got, want, images=True):
    assert len(got) == len(want)
    assert (got.width, got.height) == (want.width, want.height)
    _assert_cameras_equal(got.cameras, want.cameras)
    assert got.image_paths == want.image_paths
    for a, b in zip(got.points3d(), want.points3d()):
        np.testing.assert_array_equal(a, b)
    if images:
        for i in range(len(want)):
            np.testing.assert_array_equal(got.image(i), want.image(i))


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("split", ["train", "test", "val"])
def test_dataset_matches_gstpu(tmp_path, binary, split):
    _write_model(tmp_path, binary=binary)
    assert colmap.is_colmap_dataset(str(tmp_path))
    got = colmap.ColmapDataset(str(tmp_path), split)
    want = jax_colmap.ColmapDataset(str(tmp_path), split)
    _assert_datasets_equal(got, want)
    assert len(got) == (N_IMAGES - 2 if split == "train" else 2)


def test_text_readers_match_gstpu(tmp_path):
    _write_model(tmp_path, binary=False)
    sparse = str(tmp_path / "sparse" / "0")
    for name, reader in (("cameras.txt", "read_cameras_text"),
                         ("images.txt", "read_images_text")):
        got = getattr(colmap, reader)(os.path.join(sparse, name))
        want = getattr(jax_colmap, reader)(os.path.join(sparse, name))
        assert got.keys() == want.keys()
        for k in want:
            for field in want[k]:
                np.testing.assert_array_equal(got[k][field], want[k][field])
    for a, b in zip(colmap.read_points3d_text(os.path.join(sparse,
                                                           "points3D.txt")),
                    jax_colmap.read_points3d_text(os.path.join(
                        sparse, "points3D.txt"))):
        np.testing.assert_array_equal(a, b)


def test_mixed_focal_rig_matches_gstpu(tmp_path):
    _write_model(tmp_path, binary=True)
    _make_mixed_focal_rig(tmp_path)
    got = colmap.ColmapDataset(str(tmp_path), "train", holdout=0)
    want = jax_colmap.ColmapDataset(str(tmp_path), "train", holdout=0)
    _assert_datasets_equal(got, want, images=False)
    assert got.camera(1)["tan_fovx"] == pytest.approx(W / (2 * FX * 2))
    assert got.camera(0)["tan_fovx"] == pytest.approx(W / (2 * FX))


def test_fisheye_models_match_gstpu(tmp_path):
    path = tmp_path / "cameras.bin"
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 8, W, H))  # SIMPLE_RADIAL_FISHEYE
        f.write(struct.pack("<4d", FX, W / 2, H / 2, 0.01))
        f.write(struct.pack("<iiQQ", 2, 7, W, H))  # FOV
        f.write(struct.pack("<5d", FX, FY, W / 2, H / 2, 0.9))
    got = colmap.read_cameras_binary(str(path))
    want = jax_colmap.read_cameras_binary(str(path))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k]["model"] == want[k]["model"]
        assert (got[k]["width"], got[k]["height"]) == (W, H)
        np.testing.assert_array_equal(got[k]["params"], want[k]["params"])
    assert got[1]["model"] == "SIMPLE_RADIAL_FISHEYE"
    assert got[2]["model"] == "FOV"


def test_holdout_zero_matches_gstpu(tmp_path):
    _write_model(tmp_path, binary=True)
    got = colmap.ColmapDataset(str(tmp_path), "train", holdout=0)
    want = jax_colmap.ColmapDataset(str(tmp_path), "train", holdout=0)
    _assert_datasets_equal(got, want, images=False)
    assert len(got) == N_IMAGES
    for split in ("test", "val"):
        with pytest.raises(FileNotFoundError):
            colmap.ColmapDataset(str(tmp_path), split, holdout=0)


def test_downscale_matches_gstpu(tmp_path):
    _write_model(tmp_path, binary=True)
    got = colmap.ColmapDataset(str(tmp_path), "train", downscale=2)
    want = jax_colmap.ColmapDataset(str(tmp_path), "train", downscale=2)
    _assert_datasets_equal(got, want)
    assert got.image(0).shape == (H // 2, W // 2, 3)


def test_qvec_and_camera_record_match_gstpu():
    rng = np.random.default_rng(0)
    for _ in range(8):
        q = rng.normal(size=4)
        np.testing.assert_array_equal(colmap.qvec_to_rotmat(q),
                                      jax_colmap.qvec_to_rotmat(q))
        R, t = colmap.qvec_to_rotmat(q), rng.normal(size=3)
        fx, fy = rng.uniform(50, 200, 2)
        _assert_cameras_equal(
            [colmap._camera_record(R, t, 64, 48, fx, fy)],
            [jax_colmap._camera_record(R, t, 64, 48, fx, fy)])


def test_not_a_colmap_dataset(tmp_path):
    assert not colmap.is_colmap_dataset(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        colmap._find_sparse_dir(str(tmp_path))
