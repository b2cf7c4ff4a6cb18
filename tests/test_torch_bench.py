"""The port's bench, bench suite and kernel gate against gstpu's (CPU).

- ``bench.fit_capacities`` equal to the arithmetic of ``bench.py:113-136``
  done with gstpu's ``preprocess`` and ``_render_fwd`` on the same scene
  (2,000 Gaussians of the headline's recipe at 64x64); the headline
  iteration's loss within 1e-5 relative and its five gradients within 1e-4
  of each gradient's largest magnitude (the limit of
  ``tests/test_torch_grad.py``) of ``jax.value_and_grad`` of the same loss.
- ``kernel_check.preprocess_backend_parity(device="cpu")`` with gstpu's
  fields, ``ok``, and differences within gstpu's limits and the
  preprocess tests' (xy 1e-4 px, depth and rgb 1e-5, conic 1e-5 of its
  max); ``compiled_parity_check(device="cpu")`` (the plain versions)
  passes, and fails when the forward or the backward is off.
- The trained-scene companion and the bench suite's workloads run on the
  CPU at a small size; the entry points raise without CUDA.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import scenes as jax_scenes

from gstpu.config import RenderSettings as JaxSettings
from gstpu.ops import pallas_check
from gstpu.ops.losses import l1_loss as jax_l1
from gstpu.ops.preprocess import preprocess as jax_preprocess
from gstpu.ops.rasterize import _render_fwd as jax_render_fwd
from gstpu.ops.rasterize import render as jax_render
from gstpu_torch import bench, bench_suite, convert, scenes, sol_model
from gstpu_torch.data.nerf import NerfSyntheticDataset
from gstpu_torch.ops import cuda_rasterize, kernel_check
from gstpu_torch.utils import ply, tracing
from scripts.make_tiny_nerf import make_dataset

N, SIZE = 2000, 64


@pytest.fixture(scope="module")
def headline():
    return bench.headline("cpu", n=N, width=SIZE, height=SIZE)


def _jax_scene():
    """The same scene as ``bench.bench_scene``, drawn for gstpu."""
    rng = np.random.default_rng(0)
    cam = jax_scenes.example_camera(width=SIZE, height=SIZE)
    pts, shs, scales, rotations, opacities = jax_scenes.random_scene(
        rng, n=N, extent=1.3, z_center=-10.0,
        opacity_range=(0.05, 0.9), scale_range=(0.01, 0.05))
    target = rng.uniform(0, 1, (SIZE, SIZE, 3)).astype(np.float32)
    j = jnp.asarray
    args = (j(pts), j(scales), j(rotations), j(opacities), j(shs))
    cam_args = (j(cam["view"]), j(cam["proj"]), j(cam["campos"]),
                jnp.zeros(3, jnp.float32))
    return cam, args, cam_args, j(target)


def test_fit_capacities_matches_the_jax_bench(headline):
    work, _ = headline
    cam, args, cam_args, _ = _jax_scene()
    # bench.py:113-136, at this size
    probe = JaxSettings(width=SIZE, height=SIZE, tight_radius=True)
    pr = jax.jit(lambda *a: jax_preprocess(
        *a, SIZE, SIZE, cam["tan_fovx"], cam["tan_fovy"], probe.grid_x,
        probe.grid_y, 3, tight_radius=True))(*args, *cam_args[:3])
    live = int(np.asarray(pr.tiles_touched).sum())
    pair_capacity = -(-int(live * 1.05) // 8192) * 8192
    probe_cull = dataclasses.replace(probe, pair_capacity=pair_capacity,
                                     pair_cull=True)
    (_, _, probe_aux), _ = jax.jit(
        lambda *a: jax_render_fwd(probe_cull, cam["tan_fovx"],
                                  cam["tan_fovy"], 1.0, *a, *cam_args, None,
                                  jnp.int32(0)))(*args)
    kept = int(probe_aux.num_kept)
    kept_capacity = -(-int(kept * 1.05) // 8192) * 8192

    assert bench.fit_capacities(work.params, work.view) == (
        pair_capacity, kept_capacity, live, kept)
    assert (work.live_pairs, work.kept_pairs) == (live, kept)
    s = work.settings
    assert (s.pair_capacity, s.kept_capacity) == (pair_capacity, kept_capacity)
    assert s.pair_cull and s.tight_radius and 0 < kept < live


def test_headline_iteration_matches_jax_value_and_grad(headline):
    work, _ = headline
    cam, args, cam_args, target = _jax_scene()
    for got, want in zip(work.params, args):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(work.target.numpy(), np.asarray(target))
    s = work.settings
    settings = JaxSettings(width=SIZE, height=SIZE,
                           pair_capacity=s.pair_capacity,
                           kept_capacity=s.kept_capacity, pair_cull=True,
                           tight_radius=True)

    def loss_fn(*p):
        img, _, _ = jax_render(settings, cam["tan_fovx"], cam["tan_fovy"],
                               1.0, *p, *cam_args, None, jnp.int32(0))
        return jax_l1(img, target)

    want_loss, want_grads = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2, 3, 4)))(*args)
    before = dict(tracing.COUNTERS)
    loss, grads, aux = bench.fwd_bwd(work)
    assert tracing.COUNTERS == before           # plain on the CPU
    assert int(aux.num_kept) == work.kept_pairs <= s.kept_capacity
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for name, got, want in zip(convert.PARAM_KEYS, grads, want_grads):
        want = np.asarray(want, np.float64)
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got.numpy() / scale, want / scale,
                                   atol=1e-4, err_msg=name)


def test_preprocess_backend_parity_matches_gstpu():
    got = kernel_check.preprocess_backend_parity(device="cpu")
    want = pallas_check.preprocess_backend_parity()
    assert set(got) == set(want)
    assert got["ok"] and want["ok"]
    for k, limit in kernel_check.PREP_LIMITS.items():
        assert got[k] < limit and want[k] < limit, k
    assert got["prep_xy_maxdiff_px"] < 1e-4
    assert got["prep_depth_maxdiff"] < 1e-5
    assert got["prep_rgb_maxdiff"] < 1e-5
    assert got["prep_conic_relmax"] < 1e-5
    assert got["prep_tile_flip_frac"] < 0.01


# the fields of pallas_check.compiled_parity_check, ``device`` in place of
# ``backend``
GATE_FIELDS = {
    "device", "num_pairs", "flip_frac", "fwd_color_maxdiff",
    "fwd_depth_maxdiff", "bwd_d_color_relmax", "bwd_d_mean2d_relmax",
    "bwd_d_conic_relmax", "bwd_d_opac_relmax", "bwd_d_invdepth_relmax",
    "prep_xy_maxdiff_px", "prep_depth_maxdiff", "prep_rgb_maxdiff",
    "prep_conic_relmax", "prep_tile_flip_frac", "prep_ok", "ok"}


@pytest.fixture
def one_thread():
    """One intra-op thread: the plain walk is hundreds of small ops, which
    several test processes sharing the CPU slow down by orders of magnitude
    when each runs them on every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_compiled_parity_check_passes_with_the_plain_versions(one_thread):
    res = kernel_check.compiled_parity_check(device="cpu")
    assert set(res) == GATE_FIELDS
    assert res["ok"] and res["prep_ok"] and res["device"] == "cpu"
    assert res["num_pairs"] == 16015 and res["flip_frac"] == 0.0
    assert res["fwd_color_maxdiff"] < kernel_check.MAX_COLOR_ERR
    for k in kernel_check.GRAD_NAMES:
        assert res[f"bwd_{k}_relmax"] < kernel_check.MAX_GRAD_REL


@pytest.mark.parametrize("wrong", ["forward", "backward"])
def test_compiled_parity_check_fails_on_a_wrong_output(monkeypatch, wrong):
    """Stand-ins return the stored outputs, one of them off: color by 1e-4,
    or dL/dopacity by 1e-2 of its largest magnitude."""
    g = kernel_check.load_gate("cpu").stored

    def t(k):
        return torch.tensor(g[k])

    def forward(*a, **k):
        off = 1e-4 if wrong == "forward" else 0.0
        return t("color") + off, t("depth"), t("final_t"), t("n_contrib")

    def backward(*a, **k):
        grads = [t(f"g_{name}") for name in kernel_check.GRAD_NAMES]
        if wrong == "backward":
            grads[3] = grads[3] + 1e-2 * grads[3].abs().max()
        return tuple(grads)

    monkeypatch.setattr(cuda_rasterize, "composite_forward", forward)
    monkeypatch.setattr(cuda_rasterize, "composite_backward", backward)
    res = kernel_check.compiled_parity_check(device="cpu")
    assert not res["ok"] and res["prep_ok"]
    if wrong == "forward":
        assert res["fwd_color_maxdiff"] > kernel_check.MAX_COLOR_ERR
        assert res["bwd_d_opac_relmax"] == 0.0
    else:
        assert res["fwd_color_maxdiff"] == 0.0
        assert res["bwd_d_opac_relmax"] > kernel_check.MAX_GRAD_REL


@pytest.fixture(scope="module")
def small_ply(tmp_path_factory):
    """2,000 Gaussians of the trained Lego, stored as the checkpoint is."""
    params = ply.load_ply(scenes.LEGO_PLY)
    keep = np.sort(np.random.default_rng(0).choice(
        params["positions"].shape[0], 2000, replace=False))
    path = tmp_path_factory.mktemp("ply") / "lego_2000.ply"
    ply.save_ply({k: v[keep] for k, v in params.items()}, path, 2000,
                 parameterization=ply.detect_parameterization(params))
    return path


def test_trained_scene_camera_rule(small_ply, tmp_path):
    make_dataset(tmp_path, size=32)
    work, name = bench.trained_scene("cpu", small_ply, str(tmp_path))
    data = NerfSyntheticDataset(str(tmp_path), "train")
    cam = data.camera(0)
    assert work.params[0].shape[0] == 2000
    assert name.endswith("train camera 0")
    np.testing.assert_array_equal(work.target.numpy(), data.image(0))
    np.testing.assert_array_equal(work.view.view.numpy(),
                                  cam["world_to_camera"])
    assert (work.view.width, work.view.height) == (32, 32)

    rng = np.random.default_rng(1)
    work2, name2 = bench.trained_scene("cpu", small_ply, None, rng,
                                       size=32)
    np.testing.assert_array_equal(
        work2.target.numpy(), np.random.default_rng(1).uniform(
            0, 1, (32, 32, 3)).astype(np.float32))
    np.testing.assert_array_equal(work2.view.proj.numpy(),
                                  scenes.lego_orbit(0.0, 32)["full_proj_matrix"])
    assert "lego_orbit" in name2
    for w in (work, work2):
        s = w.settings
        assert s.pair_capacity % 8192 == 0 and s.kept_capacity % 8192 == 0
        assert w.live_pairs * 1.05 <= s.pair_capacity
        loss, grads, aux = bench.fwd_bwd(w)
        assert int(aux.num_pairs) <= s.pair_capacity
        assert np.isfinite(float(loss))
        assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_bench_suite_workloads_on_the_cpu(small_ply):
    loads = bench_suite.workloads("cpu", small_ply, n=300, width=32,
                                  height=32)
    assert [m for m, _, _ in loads] == [
        "render_only_ms_per_frame", "rasterize_fwd_bwd_ms_per_frame",
        "train_step_ms", "trained_scene_render_ms",
        "trained_scene_fwd_bwd_ms"]
    image, _, aux = loads[0][1]()
    assert image.shape == (32, 32, 3) and int(aux.num_pairs) > 0
    loss, grads, _ = loads[1][1]()
    model, _, loss2, _, counts, it = loads[2][1]()
    assert it == 1 and float(loss2) == float(loss)
    assert int(counts[0]) <= bench_suite.PAIR_CAPACITY
    assert loads[3][2]["n_gaussians"] == 2000
    assert loads[3][2]["pair_capacity"] == bench_suite.TRAINED_PAIR_CAPACITY
    image, _, _ = loads[3][1]()
    assert bool(torch.isfinite(image).all()) and float(image.max()) > 0


def test_entry_points_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    for call in (lambda: bench.main([]), lambda: bench_suite.main([]),
                 lambda: sol_model.main([]),
                 lambda: kernel_check.compiled_parity_check()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
