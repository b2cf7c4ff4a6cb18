"""The preprocess entry ``ops/cuda_preprocess.py::preprocess`` on the CPU.

For CPU tensors the entry runs the plain version, ``ops/preprocess.py::
preprocess``, with every argument it takes (each SH degree, the tight
radius, an alive mask, a scale modifier), returns its ``PreprocessOut`` bit
for bit and counts no launch; on the gate its prep is the stored JAX prep
within the kernel gate's limits.  The edge scene that the card tests hold
the kernel to has each of its edges.  The entry launches nothing for a
device without kernels.  The kernel itself runs in
``tests/test_torch_cuda.py`` on a card, against the plain version.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from gstpu_torch import scenes
from gstpu_torch.ops import cuda_preprocess, kernel_check, math3d
from gstpu_torch.ops.preprocess import preprocess
from gstpu_torch.utils import tracing


def _gate(sh_degree=3):
    return kernel_check.gate_inputs("cpu")[:-1] + (sh_degree,)


def _edges():
    arrays, cam = scenes.preprocess_edge_case()
    t = torch.as_tensor
    return (t(arrays["means"]), t(arrays["scales"]), t(arrays["rotations"]),
            t(arrays["opacities"]), t(arrays["shs"]), t(cam["view"]),
            t(cam["proj"]), t(cam["campos"]), cam["width"], cam["height"],
            cam["tan_fovx"], cam["tan_fovy"], 10, 10, 3)


def _case(case):
    """(args, kwargs) of preprocess for ``case``: the gate at an SH degree,
    with the tight radius, an alive mask or a scale modifier, or the edge
    scene."""
    if case == "edges":
        return _edges(), {}
    if case.startswith("degree"):
        return _gate(int(case[-1])), {}
    kw = {"tight_radius": dict(tight_radius=True),
          "scale_modifier": dict(scale_modifier=0.7),
          "alive": dict(alive=torch.as_tensor(
              np.random.default_rng(5).uniform(size=kernel_check.N) < 0.7))
          }[case]
    return _gate(), kw


@pytest.mark.parametrize("case", ["degree0", "degree1", "degree2",
                                  "degree3", "tight_radius", "alive",
                                  "scale_modifier", "edges"])
def test_entry_runs_the_plain_version_on_the_cpu(case):
    args, kw = _case(case)
    before = dict(tracing.COUNTERS)
    got = cuda_preprocess.preprocess(*args, **kw)
    assert tracing.COUNTERS == before
    assert chip_smoke.prep_equal(got, preprocess(*args, **kw)) == []
    if "alive" in kw:
        assert not bool(got.visible[~kw["alive"]].any())


def test_entry_matches_the_stored_gate_prep():
    """The gate's prep through the entry is the stored JAX prep, within
    the kernel gate's limits (``kernel_check.PREP_LIMITS``)."""
    res = kernel_check.preprocess_backend_parity(device="cpu")
    assert res["ok"], res
    assert res["prep_tile_flip_frac"] == 0.0


def test_the_edge_scene_has_its_edges():
    args, _ = _case("edges")
    out = preprocess(*args)
    e = scenes.PREP_EDGES
    vis = out.visible
    for name in ("depth_zero", "behind_near", "det_zero", "off_grid",
                 "saturated_off_grid", "saturated_off_grid_neg"):
        assert not bool(vis[e[name]]), name
    for name in ("on_near", "saturated_rect", "saturated_rect_inf",
                 "negative_colour"):
        assert bool(vis[e[name]]), name
    # culled at the near plane: nothing written, cov3d included
    assert not bool(out.cov3d[e["behind_near"]].any())
    # at depth 0 the EWA terms overflow: NaN conic times the mask stays NaN
    assert bool(torch.isnan(out.conic[e["depth_zero"]]).all())
    # the needle: a*c - b*b is exactly 0 and its cov3d is still written
    means, scales, rotations = args[:3]
    cov3d = math3d.compute_cov3d(scales, 1.0, rotations)
    cov2d = math3d.compute_cov2d(means, cov3d, args[5], 0.5, 0.5, 160.0,
                                 160.0)
    i = e["det_zero"]
    a, b, c = cov2d[i, 0] + 0.3, cov2d[i, 1], cov2d[i, 2] + 0.3
    assert float(a * c - b * b) == 0.0
    assert bool(out.cov3d[i].any())
    # rects past 2^30 tiles clamp to the grid, or to nothing off it
    for name in ("saturated_rect", "saturated_rect_inf"):
        assert int(out.radii[e[name]]) == 2**30
        assert out.rect[e[name]].tolist() == [0, 0, 10, 10]
    xs = math3d.ndc2pix(math3d.transform_points(means, args[6])[:, 0]
                        / math3d.transform_points(means, args[6])[:, 3],
                        160.0)
    for name in ("saturated_off_grid", "saturated_off_grid_neg"):
        assert abs(float(xs[e[name]])) > 16 * 2.0**30
    assert out.clamped[e["negative_colour"]].tolist() == [1.0, 1.0, 1.0]
    assert out.rgb[e["negative_colour"]].tolist() == [0.0, 0.0, 0.0]


def test_entry_launches_nothing_without_kernels_for_the_device():
    args, kw = _case("alive")

    def meta(x):
        return x.to("meta") if torch.is_tensor(x) else x

    before = dict(tracing.COUNTERS)
    with pytest.raises(ValueError, match="no preprocess kernel"):
        cuda_preprocess.preprocess(*map(meta, args),
                                   **{k: meta(v) for k, v in kw.items()})
    # the kernel's path takes no CPU tensor: it raises, never falls back
    with pytest.raises(ValueError, match="no preprocess kernel"):
        cuda_preprocess._preprocess_cuda(*args, **kw)
    assert tracing.COUNTERS == before
