"""The port's CLIs on the CPU against the JAX package's entry points.

- ``python -m gstpu_torch.render``: the example scene (arrays equal to the
  repo's ``render.py``), its image against ``gstpu.render.render_gaussians``
  with the tolerances of ``tests/test_torch_render.py``, the PNG written.
- ``python -m gstpu_torch.eval_model``: its JSON line against
  ``scripts/eval_model.py --no-pallas`` on ``make_tiny_nerf``'s dataset and
  a seeded PLY, PSNR and SSIM within 1e-4 (both print four decimals); a
  first pair capacity far too small gives the same line (every view
  re-rendered, none scored on dropped tiles); ``--save-renders``.
- ``python -m gstpu_torch.render_turntable``: its frames against the JAX
  script's (its ``orbit_camera`` and gstpu's render), at most one 8-bit
  step apart; the GIF's frame count.
"""

import io
import json
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpu.config import RenderSettings as JaxSettings
from gstpu.ops.rasterize import render as jax_render
from gstpu.render import render_gaussians as jax_render_gaussians
from gstpu_torch import eval_model, render_turntable
from gstpu_torch import render as render_cli
from gstpu_torch.utils.ply import save_ply
from scripts.make_tiny_nerf import make_dataset

EXAMPLE_SIZE = 96


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: small ops, and the suite runs several modules
    at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny_nerf")
    make_dataset(path, size=32, n_train=2, n_val=3)
    return path


@pytest.fixture(scope="module")
def ply_path(tmp_path_factory):
    """A seeded cloud of 150 Gaussians around the origin (raw scheme)."""
    rng = np.random.default_rng(11)
    n = 150
    shs = rng.normal(0.0, 0.2, (n, 16, 3)).astype(np.float32)
    shs[:, 0] = rng.uniform(-0.5, 1.5, (n, 3))
    q = rng.normal(size=(n, 4)).astype(np.float32)
    params = {"positions": rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32),
              "scales": rng.uniform(0.03, 0.15, (n, 3)).astype(np.float32),
              "rotations": q / np.linalg.norm(q, axis=1, keepdims=True),
              "opacities": rng.uniform(0.2, 0.9, n).astype(np.float32),
              "shs": shs}
    path = tmp_path_factory.mktemp("ply") / "cloud.ply"
    save_ply(params, path, n, parameterization="raw")
    return path


def test_example_scene_equals_the_repos_render_py():
    from render import setup_example_scene as jax_scene

    got = render_cli.setup_example_scene(EXAMPLE_SIZE, EXAMPLE_SIZE)
    want = jax_scene(EXAMPLE_SIZE, EXAMPLE_SIZE)
    for a, b in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(a, b)
    for k, v in want[5].items():
        np.testing.assert_array_equal(np.asarray(got[5][k]), np.asarray(v))


def test_example_render_matches_gstpu(tmp_path, monkeypatch):
    # the CLI's 1800x1800 takes ~20 s on the CPU; the scene scales with it
    monkeypatch.setattr(render_cli, "EXAMPLE_SIZE", EXAMPLE_SIZE)
    out = tmp_path / "example.png"
    img8 = render_cli.main(["--device", "cpu", "--out", str(out)])
    assert out.is_file() and img8.shape == (EXAMPLE_SIZE, EXAMPLE_SIZE, 3)
    image, depth, aux = render_cli.render_example(EXAMPLE_SIZE, "cpu")
    pts, shs, scales, rotations, opacities, cam = \
        render_cli.setup_example_scene(EXAMPLE_SIZE, EXAMPLE_SIZE)
    want, want_depth, _ = jax_render_gaussians(
        background=np.zeros(3, np.float32), means3D=pts, opacity=opacities,
        scales=scales, rotations=rotations, viewmatrix=cam["view_matrix"],
        projmatrix=cam["full_proj_matrix"], tan_fovx=cam["tan_fovx"],
        tan_fovy=cam["tan_fovy"], image_height=EXAMPLE_SIZE,
        image_width=EXAMPLE_SIZE, sh=shs, degree=3,
        campos=cam["camera_center"])
    assert float(np.asarray(want).max()) > 0.1    # the splats are in view
    np.testing.assert_allclose(image.numpy(), np.asarray(want), atol=5e-5)
    np.testing.assert_allclose(depth.numpy(), np.asarray(want_depth),
                               atol=5e-5)
    np.testing.assert_array_equal(
        img8, (np.clip(image.numpy(), 0, 1) * 255).astype(np.uint8))


def _jax_eval_line(monkeypatch, ply, dataset, *flags) -> dict:
    from scripts import eval_model as jax_eval

    monkeypatch.setattr(sys, "argv", ["eval_model", "--ply", str(ply),
                                      "--dataset", str(dataset),
                                      "--no-pallas", *flags])
    buf = io.StringIO()
    with redirect_stdout(buf):
        jax_eval.main()
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _port_eval_line(ply, dataset, *flags) -> dict:
    buf = io.StringIO()
    with redirect_stdout(buf):
        got = eval_model.main(["--ply", str(ply), "--dataset", str(dataset),
                               "--device", "cpu", *flags])
    assert json.loads(buf.getvalue().strip().splitlines()[-1]) == got
    return got


def _assert_lines_agree(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in ("psnr", "ssim", "psnr_per_view_min"):
        # both round to four decimals
        assert abs(got[k] - want[k]) <= 1e-4 + 1e-9, (k, got[k], want[k])
    for k in ("ply", "split", "views", "n_gaussians", "resolution"):
        assert got[k] == want[k], k


def test_eval_model_matches_gstpu_script(monkeypatch, ply_path,
                                         tiny_dataset):
    want = _jax_eval_line(monkeypatch, ply_path, tiny_dataset, "--split",
                          "val")
    got = _port_eval_line(ply_path, tiny_dataset, "--split", "val")
    assert got["views"] == 3 and np.isfinite(got["psnr"])
    _assert_lines_agree(got, want)


def test_eval_model_regrows_and_saves_renders(monkeypatch, ply_path,
                                              tiny_dataset, tmp_path):
    full = _port_eval_line(ply_path, tiny_dataset, "--split", "val",
                           "--max-views", "2")
    renders = []
    real = eval_model.render_forward

    def recorded(settings, *args, **kwargs):
        out = real(settings, *args, **kwargs)
        renders.append((settings.pair_capacity, int(out[2].num_pairs)))
        return out

    monkeypatch.setattr(eval_model, "FIRST_PAIR_CAPACITY", 64)
    monkeypatch.setattr(eval_model, "render_forward", recorded)
    out = tmp_path / "renders"
    small = _port_eval_line(ply_path, tiny_dataset, "--split", "val",
                            "--max-views", "2", "--save-renders", str(out))
    assert small == full
    assert renders[0][0] == 64 and renders[0][1] > 64     # overflowed
    assert renders[1][0] == eval_model.regrown_capacity(renders[0][1])
    assert sorted(p.name for p in out.iterdir()) == ["00000.png",
                                                      "00001.png"]


def _jax_turntable_frames(ply, frames: int, size: int) -> list:
    """The frames of ``scripts/render_turntable.py``'s loop."""
    from scripts.render_turntable import orbit_camera

    from gstpu.utils.ply import load_ply, render_space_params

    params = render_space_params(load_ply(str(ply)))
    n = params["positions"].shape[0]
    settings = JaxSettings(width=size, height=size, pair_capacity=1 << 20)
    j = jnp.asarray
    arrs = (j(params["positions"]), j(params["scales"]),
            j(params["rotations"]), j(params["opacities"]),
            j(params["shs"].reshape(n, 16, 3)))
    fov = 0.6911112070083618
    cam0 = orbit_camera(0.0, 4.0, 1.5, size, size, fov)

    @jax.jit
    def fn(view, proj, campos):
        img, _, _ = jax_render(settings, cam0["tan_fovx"], cam0["tan_fovy"],
                               1.0, *arrs, view, proj, campos,
                               jnp.zeros(3, jnp.float32), None, jnp.int32(0))
        return jnp.clip(img, 0.0, 1.0)

    out = []
    for i in range(frames):
        cam = orbit_camera(2 * np.pi * i / frames, 4.0, 1.5, size, size, fov)
        img = fn(j(cam["world_to_camera"]), j(cam["full_proj_matrix"]),
                 j(cam["camera_center"]))
        out.append((np.asarray(img) * 255).astype(np.uint8))
    return out


def test_turntable_matches_gstpu_script(ply_path, tmp_path):
    from PIL import Image

    gif = tmp_path / "t.gif"
    frames = render_turntable.main(["--ply", str(ply_path), "--out", str(gif),
                                    "--frames", "3", "--size", "40",
                                    "--device", "cpu"])
    want = _jax_turntable_frames(ply_path, 3, 40)
    assert len(frames) == 3
    for got, ref in zip(frames, want):
        assert got.shape == (40, 40, 3) and got.max() > 0
        diff = np.abs(got.astype(int) - ref.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    with Image.open(gif) as im:
        assert im.n_frames == 3
