"""Gradients of the PyTorch port's render against gstpu's (CPU).

- Each function of ``gstpu_torch/ops/preprocess_bwd.py`` against its gstpu
  counterpart on the same inputs, with ``parity`` on and off and with the
  Q15 ``translation_bias``: within 2e-5 of each output's largest magnitude
  (the same formulas, rounded in another order; autograd against
  ``jax.vjp`` where ``parity`` is off).
- The autograd ``render`` against ``jax.vjp`` of gstpu's custom-VJP
  ``render``, with image and depth cotangents: within 1e-4 of the largest
  magnitude (the port's and gstpu's compositing sum in different orders,
  and keep-threshold pairs can flip between them).
- The autograd ``render`` against the gradients that the reference's own
  kernels produced (``tests/golden/*.npz``), by ``tests/test_golden.py``'s
  ``_assert_close`` with its tolerances: 2e-4 of the largest magnitude, and
  on the high-opacity ``random_s1_64`` up to 30% of the elements within
  5e-3 (the reference reconstructs T by reverse division, the port runs a
  forward-order prefix).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import scenes
from tests.test_golden import CASES, _assert_close, _load

from gstpu.config import RenderSettings as JaxSettings
from gstpu.ops import preprocess_bwd as JB
from gstpu.ops.preprocess import preprocess as jax_preprocess
from gstpu.ops.rasterize import render as jax_render
from gstpu_torch.config import RenderSettings
from gstpu_torch.ops import preprocess_bwd as TB
from gstpu_torch.ops.rasterize import render

RENDER_KEYS = ("positions", "scales", "rotations", "opacities", "shs")


def _inputs(seed=0, n=64, size=64):
    """A random scene, its preprocess (gstpu) and random cotangents."""
    rng = np.random.default_rng(seed)
    cam = scenes.example_camera(width=size, height=size)
    pts, shs, scales, rotations, opacities = scenes.random_scene(rng, n=n)
    j = jnp.asarray
    prep = jax_preprocess(j(pts), j(scales), j(rotations), j(opacities),
                          j(shs), j(cam["view"]), j(cam["proj"]),
                          j(cam["campos"]), size, size, cam["tan_fovx"],
                          cam["tan_fovy"], 4, 4, 3)
    assert int((prep.radii > 0).sum()) > n // 2
    return dict(
        rng=rng, cam=cam, pts=pts, shs=shs, scales=scales,
        rotations=rotations, radii=np.asarray(prep.radii),
        cov3d=np.asarray(prep.cov3d), clamped=np.asarray(prep.clamped),
        focal_x=size / (2.0 * cam["tan_fovx"]),
        focal_y=size / (2.0 * cam["tan_fovy"]),
        d3=rng.normal(size=(n, 3)).astype(np.float32),
        d2=rng.normal(size=(n, 2)).astype(np.float32),
        d6=rng.normal(size=(n, 6)).astype(np.float32))


def _close(got, want, rel=2e-5):
    for a, b in zip(got, want):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        scale = max(float(np.abs(b).max()), 1e-8)
        np.testing.assert_allclose(a / scale, b / scale, atol=rel)


def _t(x):
    return torch.tensor(np.asarray(x))


def test_dnormvdv_matches_gstpu():
    rng = np.random.default_rng(1)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    v[0] = 0.0                                   # the sum2 < 1e-10 guard
    dv = rng.normal(size=(50, 3)).astype(np.float32)
    _close([TB.dnormvdv(_t(v), _t(dv)).numpy()],
           [JB.dnormvdv(jnp.asarray(v), jnp.asarray(dv))])


@pytest.mark.parametrize("parity,bias", [(True, False), (True, True),
                                         (False, False)])
def test_cov2d_backward_matches_gstpu(parity, bias):
    x = _inputs()
    cam = x["cam"]
    args = (x["pts"], x["cov3d"], x["radii"], x["focal_x"], x["focal_y"],
            cam["tan_fovx"], cam["tan_fovy"], cam["view"], x["d3"])
    got = TB.cov2d_backward(*(_t(a) if isinstance(a, np.ndarray) else a
                              for a in args), parity=parity,
                            translation_bias=bias)
    want = JB.cov2d_backward(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                               else a for a in args), parity=parity,
                             translation_bias=bias)
    _close([g.numpy() for g in got], want)


def test_projection_backward_matches_gstpu():
    x = _inputs()
    got = TB.projection_backward(_t(x["pts"]), _t(x["radii"]),
                                 _t(x["cam"]["proj"]), _t(x["d2"]))
    want = JB.projection_backward(jnp.asarray(x["pts"]),
                                  jnp.asarray(x["radii"]),
                                  jnp.asarray(x["cam"]["proj"]),
                                  jnp.asarray(x["d2"]))
    _close([got.numpy()], [want])


@pytest.mark.parametrize("degree", [0, 1, 3])
def test_sh_backward_matches_gstpu(degree):
    x = _inputs()
    args = (x["pts"], x["shs"], x["radii"], x["cam"]["campos"], x["clamped"],
            x["d3"])
    got = TB.sh_backward(*map(_t, args), degree)
    want = JB.sh_backward(*map(jnp.asarray, args), degree)
    _close([g.numpy() for g in got], want)


@pytest.mark.parametrize("parity", [True, False])
def test_cov3d_backward_matches_gstpu(parity):
    x = _inputs()
    got = TB.cov3d_backward(_t(x["scales"]), _t(x["rotations"]),
                            _t(x["radii"]), 0.8, _t(x["d6"]), parity=parity)
    want = JB.cov3d_backward(jnp.asarray(x["scales"]),
                             jnp.asarray(x["rotations"]),
                             jnp.asarray(x["radii"]), 0.8,
                             jnp.asarray(x["d6"]), parity=parity)
    _close([g.numpy() for g in got], want)


@pytest.mark.parametrize("parity,bias,cull", [(True, False, False),
                                              (True, True, False),
                                              (False, False, False),
                                              (True, False, True)])
def test_render_grads_match_gstpu_vjp(parity, bias, cull):
    rng = np.random.default_rng(3)
    size = 48
    cam = scenes.example_camera(width=size, height=size)
    pts, shs, scales, rotations, opacities = scenes.random_scene(rng, n=40)
    ct = rng.normal(0, 1, (size, size, 3)).astype(np.float32)
    ct_d = rng.normal(0, 1, (size, size)).astype(np.float32)
    bg = np.asarray([0.2, 0.1, 0.4], np.float32)
    kw = dict(width=size, height=size, pair_capacity=1 << 12, parity=parity,
              grad_bias_parity=bias)
    if cull:
        kw.update(tight_radius=True, pair_cull=True, kept_capacity=1 << 11)
    primals = (pts, scales, rotations, opacities, shs)
    camera = (cam["view"], cam["proj"], cam["campos"], bg)

    def f(*p):
        img, depth, _ = jax_render(JaxSettings(**kw), cam["tan_fovx"],
                                   cam["tan_fovy"], 1.0, *p,
                                   *map(jnp.asarray, camera), None,
                                   jnp.int32(0))
        return img, depth

    (j_img, j_depth), vjp = jax.vjp(jax.jit(f), *map(jnp.asarray, primals))
    want = vjp((jnp.asarray(ct), jnp.asarray(ct_d)))

    tp = [torch.tensor(x, requires_grad=True) for x in primals]
    img, depth, _ = render(RenderSettings(**kw), cam["tan_fovx"],
                           cam["tan_fovy"], 1.0, *tp, *map(_t, camera))
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(j_img),
                               atol=5e-5)
    got = torch.autograd.grad((img * _t(ct)).sum() + (depth * _t(ct_d)).sum(),
                              tp)
    _close([g.numpy() for g in got], want, rel=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_render_grads_match_reference_golden(case):
    g = _load(case)
    settings = RenderSettings(width=int(g["width"]), height=int(g["height"]),
                              pair_capacity=1 << 14, parity=True,
                              grad_bias_parity=True)
    tp = [torch.tensor(g[k], requires_grad=True)
          for k in ("pts", "scales", "rotations", "opacities", "shs")]
    img, _, _ = render(settings, float(g["tan_fovx"]), float(g["tan_fovy"]),
                       1.0, *tp, _t(g["view"]), _t(g["proj"]),
                       _t(g["campos"]), _t(g["bg"]))
    dmean, dscale, drot, dopac, dsh = torch.autograd.grad(
        (img * _t(g["dl_dpix"])).sum(), tp)
    kw = (dict(atol=2e-4, outlier_frac=0.30, outlier_cap=5e-3)
          if case == "random_s1_64" else dict(atol=2e-4))
    check = partial(_assert_close, **kw)
    check(dmean.numpy(), g["d_mean3d"], "d_mean3d")
    check(dscale.numpy(), g["d_scale"], "d_scale")
    check(drot.numpy(), g["d_rot"], "d_rot")
    check(dopac.numpy(), g["d_opacity"], "d_opacity")
    check(dsh.numpy(), g["d_shs"].reshape(dsh.shape), "d_shs")


def test_render_returns_no_grad_for_camera_and_mask():
    rng = np.random.default_rng(0)
    cam = scenes.example_camera(width=32, height=32)
    pts, shs, scales, rotations, opacities = scenes.random_scene(rng, n=8)
    tp = [torch.tensor(x, requires_grad=True)
          for x in (pts, scales, rotations, opacities, shs)]
    view = torch.tensor(cam["view"], requires_grad=True)
    alive = torch.ones(8, dtype=torch.bool)
    img, depth, aux = render(RenderSettings(width=32, height=32),
                             cam["tan_fovx"], cam["tan_fovy"], 1.0, *tp, view,
                             _t(cam["proj"]), _t(cam["campos"]),
                             torch.zeros(3), alive)
    assert not aux.final_t.requires_grad and not aux.xy.requires_grad
    grads = torch.autograd.grad(img.sum() + depth.sum(), tp + [view],
                                allow_unused=True)
    assert grads[-1] is None
    assert all(torch.isfinite(x).all() for x in grads[:-1])
