"""Losses, learning-rate schedule, Adam and the model of the PyTorch port
against gstpu's (CPU).

Tolerances, each for its reason:

- losses: values within 1e-6 relative and gradients within 1e-5 of their
  largest magnitude (float32 reductions and convolutions summed in another
  order);
- ``schedule_lrs``: equal to the float32 value (the same float32 pow);
- ``adam_step`` fed identical gradients: parameters and moments within
  1e-6 absolute (an update is about lr * m / sqrt(v), float32 on both
  sides; a different last bit of sqrt or pow moves it by far less).
  Gradients and Adam are compared apart, never post-step parameters from
  gradients of their own: at iteration 0 the update is about lr * sign(g),
  so a gradient near 0 that differs in its last bit moves a parameter by
  2 * lr;
- model initialization from points: exact (the same NumPy and scipy code).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpu.config import GSConfig as JaxConfig
from gstpu.models import gaussians as JG
from gstpu.ops import losses as JL
from gstpu import optim as JO
from gstpu.scheduler import LRScheduler as JaxLRScheduler
from gstpu_torch import convert
from gstpu_torch.config import GSConfig
from gstpu_torch.models import gaussians as TG
from gstpu_torch.ops import losses as TL
from gstpu_torch import optim as TO
from gstpu_torch.scheduler import LRScheduler

KEYS = ("positions", "scales", "rotations", "opacities", "shs")


def _images(seed=0, h=40, w=56):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    a[:6] = b[:6] = 0.7    # a flat band: variances that round below zero
    return a, b


def _grad_close(got, want, rel=1e-5):
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(want) / scale, atol=rel)


@pytest.mark.parametrize("name,kw", [
    ("l1", {}), ("ssim", {}), ("ssim", {"clamp_sigma": True}),
    ("combined", {"lambda_dssim": 0.2}), ("combined", {"lambda_dssim": 0.0}),
    ("psnr", {})])
def test_image_losses_and_gradients_match_gstpu(name, kw):
    a, b = _images()
    fn_t = {"l1": TL.l1_loss, "ssim": TL.ssim, "combined": TL.combined_loss,
            "psnr": TL.psnr}[name]
    fn_j = {"l1": JL.l1_loss, "ssim": JL.ssim, "combined": JL.combined_loss,
            "psnr": JL.psnr}[name]
    ta = torch.tensor(a, requires_grad=True)
    val = fn_t(ta, torch.tensor(b), **kw)
    (grad,) = torch.autograd.grad(val, ta)
    j_val, j_grad = jax.value_and_grad(
        lambda x: fn_j(x, jnp.asarray(b), **kw))(jnp.asarray(a))
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-6)
    _grad_close(grad.numpy(), np.asarray(j_grad))


@pytest.mark.parametrize("clamp_sigma", [False, True])
def test_ssim_of_an_image_with_itself_is_one(clamp_sigma):
    a, b = _images(1)
    ta, tb = torch.tensor(a), torch.tensor(b)
    assert float(TL.ssim(ta, ta, clamp_sigma)) == pytest.approx(1.0, abs=1e-6)
    assert float(TL.ssim(ta, tb, clamp_sigma)) < 0.9


def test_l1_pixel_gradients_and_depth_loss_match_gstpu():
    a, b = _images(2)
    np.testing.assert_array_equal(
        TL.l1_pixel_gradients(torch.tensor(a), torch.tensor(b), 0.2).numpy(),
        np.asarray(JL.l1_pixel_gradients(jnp.asarray(a), jnp.asarray(b),
                                         0.2)))
    rng = np.random.default_rng(3)
    mask = (rng.uniform(size=a.shape[:2]) > 0.4).astype(np.float32)
    da = torch.tensor(a[..., 0], requires_grad=True)
    val = TL.depth_loss(da, torch.tensor(b[..., 1]), torch.tensor(mask))
    (grad,) = torch.autograd.grad(val, da)
    j_val, j_grad = jax.value_and_grad(lambda x: JL.depth_loss(
        x, jnp.asarray(b[..., 1]), jnp.asarray(mask)))(jnp.asarray(a[..., 0]))
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-6)
    _grad_close(grad.numpy(), np.asarray(j_grad))


@pytest.mark.parametrize("kw", [{}, {"use_lr_scheduler": False},
                                {"schedule_opac": False, "lr_opac": 0.05},
                                {"num_iterations": 1}])
def test_schedule_lrs_matches_gstpu(kw):
    for it in (0, 1, 17, 3500, 6999, 9000):
        got = TO.schedule_lrs(GSConfig(**kw), it)
        want = JO.schedule_lrs(JaxConfig(**kw), jnp.int32(it))
        for g, w in zip(got, want):
            assert g == float(np.float32(w)), (it, got, want)


def test_lr_scheduler_class_matches_gstpu():
    for lr, f in ((1e-2, 0.01), (5e-3, 0.1)):
        ours, ref = LRScheduler(lr, f), JaxLRScheduler(lr, f)
        assert ours.final_lr == ref.final_lr
        for it in (0, 10, 6999, 8000):
            assert ours.get_lr(it, 7000) == ref.get_lr(it, 7000)
        assert ours.get_lr(3, 1) == ref.get_lr(3, 1)


def _state(seed, parameterization, n=50, cap=64):
    rng = np.random.default_rng(seed)

    def arr(*shape, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, (cap,) + shape).astype(np.float32)

    params = dict(positions=arr(3), scales=arr(3, lo=0.0, hi=0.05),
                  rotations=arr(4), opacities=arr(lo=0.0, hi=1.0),
                  shs=arr(16, 3))
    if parameterization == "activated":
        params["scales"] = arr(3, lo=-6, hi=-2)
        params["opacities"] = arr(lo=-3, hi=3)
    grads = {k: rng.normal(0, 1e-3, v.shape).astype(np.float32)
             for k, v in params.items()}
    if parameterization == "raw":                 # pushed below the clamp
        params["scales"][1] = 0.002
        grads["scales"][1] = 1.0
    m = {k: rng.normal(0, 1e-4, v.shape).astype(np.float32)
         for k, v in params.items()}
    v = {k: rng.uniform(0, 1e-6, x.shape).astype(np.float32)
         for k, x in params.items()}
    for x in (params, grads, m, v):               # the zero-length guard
        x["rotations"][0] = 0.0
    alive = np.arange(cap) < n
    return params, grads, m, v, alive


@pytest.mark.parametrize("parameterization", ["raw", "activated"])
@pytest.mark.parametrize("iteration", [0, 1, 250])
def test_adam_step_on_identical_gradients_matches_gstpu(parameterization,
                                                        iteration):
    params, grads, m, v, alive = _state(iteration, parameterization)
    cfg_kw = dict(parameterization=parameterization)
    t_params = {k: torch.tensor(x) for k, x in params.items()}
    new_p, new_s = TO.adam_step(
        t_params, {k: torch.tensor(x) for k, x in grads.items()},
        convert.adam_from_numpy(m, v, "cpu"),
        TO.schedule_lrs(GSConfig(**cfg_kw), iteration), iteration,
        GSConfig(**cfg_kw), alive=torch.tensor(alive))
    jcfg = JaxConfig(**cfg_kw)
    j = jax.tree_util.tree_map(jnp.asarray, (params, grads, m, v))
    want_p, want_s = JO.adam_step(j[0], j[1], JO.AdamState(m=j[2], v=j[3]),
                                  JO.schedule_lrs(jcfg, jnp.int32(iteration)),
                                  jnp.int32(iteration), jcfg,
                                  alive=jnp.asarray(alive))
    got_m, got_v = convert.adam_to_numpy(new_s)
    for k in KEYS:
        np.testing.assert_allclose(new_p[k].numpy(), np.asarray(want_p[k]),
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got_m[k], np.asarray(want_s.m[k]),
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got_v[k], np.asarray(want_s.v[k]),
                                   atol=1e-6, err_msg=k)
        # dead slots keep their parameters and moments
        np.testing.assert_array_equal(new_p[k].numpy()[~alive],
                                      params[k][~alive])
        np.testing.assert_array_equal(got_m[k][~alive], m[k][~alive])
    assert torch.equal(t_params["positions"], torch.tensor(params["positions"]))
    if parameterization == "raw":
        assert float(new_p["scales"][1].min()) == pytest.approx(0.001)
    np.testing.assert_array_equal(new_p["rotations"][0].numpy(), 0.0)


def test_activate_params_and_inverse_sigmoid_match_gstpu():
    params, _, _, _, _ = _state(5, "activated")
    t = {k: torch.tensor(x, requires_grad=True) for k, x in params.items()}
    for mode in ("raw", "activated"):
        got = TG.activate_params(t, mode)
        want = JG.activate_params(params, mode)
        for k in KEYS:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(want[k]), rtol=1e-6)
    x = np.asarray([0.01, 0.5, 0.99], np.float32)
    np.testing.assert_allclose(TG.inverse_sigmoid(torch.tensor(x)).numpy(),
                               np.asarray(JG.inverse_sigmoid(jnp.asarray(x))),
                               rtol=1e-6)
    with pytest.raises(ValueError):
        TG.activate_params(t, "log")


@pytest.mark.parametrize("parameterization", ["raw", "activated"])
def test_init_model_from_points_matches_gstpu(parameterization):
    rng = np.random.default_rng(4)
    xyz = rng.normal(size=(300, 3)).astype(np.float32)
    rgb = rng.uniform(size=(300, 3)).astype(np.float32)
    cfg_kw = dict(parameterization=parameterization)
    got = convert.model_to_numpy(TG.init_model_from_points(
        GSConfig(**cfg_kw), xyz, rgb, device="cpu"))
    want = JG.init_model_from_points(JaxConfig(**cfg_kw), xyz, rgb)
    assert got["positions"].shape[0] == int(300 * 1.5)
    for k in KEYS + ("alive",):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)))
    assert int(got["n_alive"]) == int(want.n_alive) == 300


@pytest.mark.parametrize("parameterization", ["raw", "activated"])
def test_init_model_matches_gstpu_but_for_the_random_positions(
        parameterization):
    cfg_kw = dict(num_points=200, parameterization=parameterization)
    got = TG.init_model(torch.Generator().manual_seed(0), GSConfig(**cfg_kw),
                        device="cpu")
    want = JG.init_model(jax.random.PRNGKey(0), JaxConfig(**cfg_kw))
    assert got.capacity == want.capacity == 300
    for k in ("scales", "rotations", "opacities", "shs", "alive"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    e = GSConfig().init_position_extent
    assert float(got.positions.abs().max()) <= e
    assert got.positions.std() > 0.5 * e / np.sqrt(3)


def test_grow_capacity_and_model_round_trip():
    params, _, _, _, alive = _state(6, "raw")
    arrays = {**params, "alive": alive}
    model = convert.model_from_numpy(arrays, "cpu")
    assert int(model.n_alive) == int(alive.sum())
    grown = TG.grow_capacity(model, 80)
    want = JG.grow_capacity(JG.GaussianModel(
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        n_alive=jnp.int32(alive.sum())), 80)
    back = convert.model_to_numpy(grown)
    for k in KEYS + ("alive",):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(want, k)))
    assert int(back["n_alive"]) == int(want.n_alive)
    with pytest.raises(ValueError):
        TG.grow_capacity(grown, 10)
    m, v = convert.adam_to_numpy(TO.init_adam_state(grown.param_dict()))
    assert all(not x.any() for x in list(m.values()) + list(v.values()))
