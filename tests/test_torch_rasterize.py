"""Forward compositing of the PyTorch port against gstpu's (CPU).

The port's plain ``composite_forward`` is the CPU form of the CUDA kernel
``csrc/rasterize_fwd.cu``.  It is held against gstpu's XLA compositing and
gstpu's Pallas kernel in interpret mode on the same inputs, with the
thresholds of ``tests/test_pallas.py``: contributor flips < 0.02 and color,
depth and final T within 2e-6 off boundary pixels (a flip, or final T below
6e-4).  Keep-threshold pairs legitimately flip between contraction orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import scenes

from gstpu.config import RenderSettings as JaxSettings
from gstpu.ops import pallas_rasterize
from gstpu.ops import rasterize as R
from gstpu.ops.binning import Pairs as JaxPairs
from gstpu.ops.binning import build_pairs
from gstpu.ops.preprocess import PreprocessOut as JaxPrep
from gstpu.ops.preprocess import preprocess
from gstpu_torch import convert
from gstpu_torch import scenes as torch_scenes
from gstpu_torch.config import RenderSettings
from gstpu_torch.ops import cuda_rasterize
from gstpu_torch.ops import rasterize as TR
from gstpu_torch.utils import tracing


def _small_scene(seed, opac, n=80, size=64):
    """The scene of tests/test_pallas.py::_setup, as NumPy dicts."""
    rng = np.random.default_rng(seed)
    cam = scenes.example_camera(width=size, height=size)
    pts, shs, scales, rotations, opacities = scenes.random_scene(
        rng, n=n, opacity_range=opac)
    j = jnp.asarray
    s = JaxSettings(width=size, height=size, pair_capacity=1 << 13)
    prep = preprocess(j(pts), j(scales), j(rotations), j(opacities), j(shs),
                      j(cam["view"]), j(cam["proj"]), j(cam["campos"]),
                      size, size, cam["tan_fovx"], cam["tan_fovy"],
                      s.grid_x, s.grid_y, 3)
    pairs = build_pairs(prep.tiles_touched, prep.rect, prep.depth,
                        s.grid_x, s.num_tiles, s.pair_capacity)
    return (RenderSettings(width=size, height=size, pair_capacity=1 << 13),
            {k: np.asarray(v) for k, v in prep._asdict().items()},
            {k: np.asarray(v) for k, v in pairs._asdict().items()})


def _jax_outputs(settings, prep_np, pairs_np):
    s = JaxSettings(width=settings.width, height=settings.height,
                    pair_capacity=settings.pair_capacity)
    prep = JaxPrep(**{k: jnp.asarray(v) for k, v in prep_np.items()})
    pairs = JaxPairs(**{k: jnp.asarray(v) for k, v in pairs_np.items()})
    xla = R.composite_forward(prep, pairs, s)
    pallas = pallas_rasterize.composite_forward(prep, pairs, s, interpret=True)
    return ([np.asarray(x) for x in xla], [np.asarray(x) for x in pallas])


def _plain(settings, prep_np, pairs_np):
    prep = convert.prep_from_numpy(prep_np, "cpu", prefix="")
    pairs = convert.pairs_from_numpy(pairs_np, "cpu", prefix="")
    return [x.numpy() for x in TR.composite_forward(prep, pairs, settings)]


def _assert_close(got, want, max_flips=0.02, color_tol=2e-6, depth_tol=2e-6,
                  t_tol=2e-6):
    c1, d1, t1, n1 = got
    c2, d2, t2, n2 = want
    assert n1.dtype == np.int32 and c1.shape == c2.shape
    flips = n1 != n2
    assert flips.mean() < max_flips, flips.mean()
    boundary = flips | (t1 < 6e-4) | (t2 < 6e-4)
    assert np.all((np.abs(c1 - c2) <= color_tol) | boundary[:, :, None])
    np.testing.assert_allclose(d1[~boundary], d2[~boundary], atol=depth_tol)
    np.testing.assert_allclose(t1[~boundary], t2[~boundary], atol=t_tol)


@pytest.mark.parametrize("case", ["seed0", "seed1_opaque", "span_edges"])
def test_plain_matches_gstpu_xla_and_pallas(case):
    if case == "span_edges":
        settings, prep_np, pairs_np = torch_scenes.span_edge_case()
    else:
        seed, opac = (0, (0.2, 0.9)) if case == "seed0" else (1, (0.7, 1.0))
        settings, prep_np, pairs_np = _small_scene(seed, opac)
    got = _plain(settings, prep_np, pairs_np)
    xla, pallas = _jax_outputs(settings, prep_np, pairs_np)
    _assert_close(got, xla)
    _assert_close(got, pallas)
    assert (got[3] > 0).any() and (got[2] < 1.0).any()


def test_plain_matches_stored_gate():
    """The stored gate (8000 Gaussians, 160x160) with the compiled gate's
    thresholds (gstpu/ops/pallas_check.py:160-188)."""
    g = np.load(torch_scenes.GATE_NPZ)
    settings = RenderSettings(width=160, height=160, pair_capacity=1 << 16)
    got = [x.numpy() for x in TR.composite_forward(
        convert.prep_from_numpy(g, "cpu"), convert.pairs_from_numpy(g, "cpu"),
        settings)]
    want = (g["color"], g["depth"], g["final_t"], g["n_contrib"])
    _assert_close(got, want, max_flips=0.05, color_tol=1e-5, depth_tol=1e-4,
                  t_tol=1e-5)


def test_kernel_wrapper_runs_plain_version_on_cpu():
    settings, prep_np, pairs_np = torch_scenes.span_edge_case()
    prep = convert.prep_from_numpy(prep_np, "cpu", prefix="")
    pairs = convert.pairs_from_numpy(pairs_np, "cpu", prefix="")
    before = dict(tracing.COUNTERS)
    got = cuda_rasterize.composite_forward(prep, pairs, settings)
    want = TR.composite_forward(prep, pairs, settings)
    assert tracing.COUNTERS == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_tile_layout_round_trip_matches_gstpu():
    rng = np.random.default_rng(0)
    for s in (RenderSettings(width=50, height=37),
              RenderSettings(width=48, height=64, tile_rows=2, row_stride=2)):
        js = JaxSettings(width=s.width, height=s.height, tile_rows=s.tile_rows,
                         row_stride=s.row_stride)
        tiled = rng.normal(size=(s.band_tiles, 256, 3)).astype(np.float32)
        img = TR.tiles_to_image(torch.as_tensor(tiled), s)
        np.testing.assert_array_equal(
            img.numpy(), np.asarray(R.tiles_to_image(jnp.asarray(tiled), js)))
        back = TR.image_to_tiles(img, s)
        np.testing.assert_array_equal(
            back.numpy(),
            np.asarray(R.image_to_tiles(jnp.asarray(img.numpy()), js)))


def test_band_pixel_coords_match_gstpu():
    s = RenderSettings(width=64, height=96, tile_rows=3, row_stride=2)
    js = JaxSettings(width=64, height=96, tile_rows=3, row_stride=2)
    got = TR._tile_pixel_coords(s, row0=1)
    want = R._tile_pixel_coords(js, row0=1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
