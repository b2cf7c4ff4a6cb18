"""One training step of the PyTorch port against gstpu's step body (CPU).

The JAX reference is the body of ``gstpu/trainer.py::Trainer._train_step``
composed from gstpu functions (``use_pallas=False``): activate, render,
``combined_loss`` (+ ``lambda_depth * depth_loss``), ``value_and_grad``,
``schedule_lrs``, ``adam_step``.  Both packages start from the same model
and moments (``gstpu_torch.convert``), with capacity padding whose dead
slots hold copies of live Gaussians, so a dead slot that leaked into the
render or the update would show.

Tolerances, each for its reason:

- loss: 1e-6 relative (the same image to float32 rounding, reduced in
  another order);
- gradients per group: 1e-4 of the group's largest magnitude (the
  compositing sums in another order; keep-threshold pairs may flip);
- Adam on identical gradients: 1e-6 absolute.  Post-step parameters are
  not compared from each package's own gradients: at iteration 0 Adam
  moves by about lr * sign(g), so a near-zero gradient that differs in its
  last bit moves a parameter by 2 * lr;
- a 5-step loss curve, each package with its own gradients: 1e-5
  relative (measured: within 4e-7; a sign flip of a near-zero gradient
  moves a parameter that barely affects the loss).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import scenes

from gstpu.config import GSConfig as JaxConfig
from gstpu.config import RenderSettings as JaxSettings
from gstpu.models.gaussians import GaussianModel as JaxModel
from gstpu.models.gaussians import activate_params as jax_activate
from gstpu.ops.losses import combined_loss as jax_combined_loss
from gstpu.ops.losses import depth_loss as jax_depth_loss
from gstpu.ops.rasterize import render as jax_render
from gstpu.optim import adam_step as jax_adam_step
from gstpu.optim import init_adam_state as jax_init_adam
from gstpu.optim import schedule_lrs as jax_schedule_lrs
from gstpu.trainer import Trainer
from gstpu_torch import convert
from gstpu_torch.config import GSConfig, RenderSettings
from gstpu_torch.optim import adam_step, init_adam_state, schedule_lrs
from gstpu_torch.ops.rasterize import render
from gstpu_torch.trainer import (loss_and_grads, round_capacity,
                                 train_settings, train_step)

SIZE = 64
N_LIVE = 300
CAPACITY = 360
KEYS = ("positions", "scales", "rotations", "opacities", "shs")
SETTINGS = dict(width=SIZE, height=SIZE, pair_capacity=1 << 14,
                kept_capacity=1 << 13, tight_radius=True, pair_cull=True)
CASES = {"raw": dict(),
         "activated_ssim": dict(parameterization="activated",
                                lambda_dssim=0.2),
         "raw_depth": dict(lambda_depth=0.5)}


def _scene(config_kw):
    """(model arrays, camera, target image, depth target, depth mask)."""
    rng = np.random.default_rng(5)
    cam = scenes.example_camera(width=SIZE, height=SIZE)
    pts, shs, scales, rots, opac = scenes.random_scene(
        rng, n=N_LIVE, opacity_range=(0.1, 0.9), scale_range=(0.05, 0.4))
    params = dict(positions=pts, scales=scales, rotations=rots,
                  opacities=opac, shs=shs)
    target = rng.uniform(0, 1, (SIZE, SIZE, 3)).astype(np.float32)
    # the depth target: the port's render of the scene, before a shift
    with torch.no_grad():
        _, depth, _ = render(RenderSettings(**SETTINGS), cam["tan_fovx"],
                             cam["tan_fovy"], 1.0,
                             *(torch.tensor(params[k]) for k in KEYS),
                             *(torch.tensor(cam[k])
                               for k in ("view", "proj", "campos")),
                             torch.zeros(3))
    mask = (rng.uniform(size=(SIZE, SIZE)) > 0.3).astype(np.float32)
    params["positions"] = params["positions"] + np.float32(0.05)
    if config_kw.get("parameterization") == "activated":
        params["scales"] = np.log(params["scales"])
        params["opacities"] = np.log(opac / (1.0 - opac))
    # dead slots: copies of live Gaussians, masked out by `alive`
    arrays = {k: np.concatenate([v, v[:CAPACITY - N_LIVE]])
              for k, v in params.items()}
    arrays["alive"] = np.arange(CAPACITY) < N_LIVE
    return arrays, cam, target, depth.numpy(), mask


def _jax_step(jcfg, model, adam, cam, target, iteration, td, dm):
    """The body of gstpu's Trainer._train_step, use_pallas=False."""
    js = JaxSettings(**SETTINGS)
    j = jnp.asarray
    params = model.param_dict()

    def loss_fn(p):
        p = jax_activate(p, jcfg.parameterization)
        image, depth, aux = jax_render(
            js, cam["tan_fovx"], cam["tan_fovy"], jcfg.scale_modifier,
            p["positions"], p["scales"], p["rotations"], p["opacities"],
            p["shs"], j(cam["view"]), j(cam["proj"]), j(cam["campos"]),
            j(jcfg.background_color, jnp.float32), model.alive, jnp.int32(0))
        loss = jax_combined_loss(image, target, jcfg.lambda_dssim)
        if td is not None:
            loss = loss + jcfg.lambda_depth * jax_depth_loss(
                depth, jcfg.depth_scale * td, dm)
        return loss, aux

    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    new_p, new_adam = jax_adam_step(params, grads, adam,
                                    jax_schedule_lrs(jcfg, iteration),
                                    iteration, jcfg, alive=model.alive)
    counts = jnp.stack([aux.num_pairs, aux.num_kept])
    return model.replace(**new_p), new_adam, loss, grads, counts


def _both(case):
    cfg_kw = CASES[case]
    arrays, cam, target, depth, mask = _scene(cfg_kw)
    with_depth = cfg_kw.get("lambda_depth", 0.0) > 0.0
    jmodel = JaxModel(**{k: jnp.asarray(v) for k, v in arrays.items()},
                      n_alive=jnp.int32(N_LIVE))
    torch_args = dict(
        camera=tuple(torch.tensor(cam[k]) for k in ("view", "proj",
                                                    "campos")),
        target=torch.tensor(target),
        depth=(torch.tensor(depth), torch.tensor(mask)) if with_depth
        else (None, None))
    jax_args = (cam, jnp.asarray(target),
                jnp.asarray(depth) if with_depth else None,
                jnp.asarray(mask) if with_depth else None)
    return (GSConfig(**cfg_kw), JaxConfig(**cfg_kw), arrays, jmodel, cam,
            torch_args, jax_args)


def _rel_close(got, want, rel, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got / scale, want / scale, atol=rel,
                               err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_gstpu_step_body(case):
    cfg, jcfg, arrays, jmodel, cam, targs, jargs = _both(case)
    model = convert.model_from_numpy(arrays, "cpu")
    adam = init_adam_state(model.param_dict())
    settings = RenderSettings(**SETTINGS)
    step = jax.jit(_jax_step, static_argnums=(0,))
    j_model, j_adam, j_loss, j_grads, j_counts = step(
        jcfg, jmodel, jax_init_adam(jmodel.param_dict()), jargs[0], jargs[1],
        jnp.int32(0), jargs[2], jargs[3])
    tanx, tany = cam["tan_fovx"], cam["tan_fovy"]
    td, dm = targs["depth"]

    loss, grads, aux = loss_and_grads(settings, cfg, model, *targs["camera"],
                                      tanx, tany, targs["target"],
                                      target_depth=td, depth_mask=dm)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)
    for k in KEYS:
        _rel_close(grads[k].numpy(), j_grads[k], 1e-4, k)
        assert not grads[k][N_LIVE:].any(), k      # dead slots: no gradient
    assert [int(aux.num_pairs), int(aux.num_kept)] == j_counts.tolist()

    # Adam fed the JAX gradients gives the JAX step's parameters
    new_p, new_adam = adam_step(
        model.param_dict(), {k: torch.tensor(np.asarray(j_grads[k]))
                             for k in KEYS}, adam, schedule_lrs(cfg, 0), 0,
        cfg, alive=model.alive)
    for k in KEYS:
        np.testing.assert_allclose(new_p[k].numpy(),
                                   np.asarray(getattr(j_model, k)), atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(new_adam.v[k].numpy(),
                                   np.asarray(j_adam.v[k]), atol=1e-6)
        np.testing.assert_array_equal(new_p[k][N_LIVE:].numpy(),
                                      arrays[k][N_LIVE:])

    # train_step is loss_and_grads then adam_step, and returns as JAX does
    s_model, s_adam, s_loss, s_gpos, s_counts, it = train_step(
        settings, cfg, model, adam, *targs["camera"], tanx, tany,
        targs["target"], 0, target_depth=td, depth_mask=dm)
    want_p, _ = adam_step(model.param_dict(), grads, adam,
                          schedule_lrs(cfg, 0), 0, cfg, alive=model.alive)
    assert it == 1 and float(s_loss) == float(loss)
    assert torch.equal(s_gpos, grads["positions"])
    assert s_counts.tolist() == j_counts.tolist()
    for k in KEYS:
        assert torch.equal(getattr(s_model, k), want_p[k]), k
    assert torch.equal(s_model.alive, model.alive)


def test_five_step_loss_curve_matches_gstpu():
    cfg, jcfg, arrays, jmodel, cam, targs, jargs = _both("raw")
    model = convert.model_from_numpy(arrays, "cpu")
    adam = init_adam_state(model.param_dict())
    settings = RenderSettings(**SETTINGS)
    step = jax.jit(_jax_step, static_argnums=(0,))
    j_adam = jax_init_adam(jmodel.param_dict())
    losses, j_losses = [], []
    it = 0
    for i in range(5):
        model, adam, loss, _, _, it = train_step(
            settings, cfg, model, adam, *targs["camera"], cam["tan_fovx"],
            cam["tan_fovy"], targs["target"], it)
        jmodel, j_adam, j_loss, _, _ = step(jcfg, jmodel, j_adam, jargs[0],
                                            jargs[1], jnp.int32(i), None,
                                            None)
        losses.append(float(loss))
        j_losses.append(float(j_loss))
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    assert losses[-1] < losses[0]


def test_round_capacity_and_train_settings_match_gstpu():
    for pairs in (0, 1, 16384, 32767, 32768, 32769, 193579 * 24.0):
        assert round_capacity(pairs) == Trainer._round_capacity(pairs)
    assert round_capacity(193579 * 24.0) == 4_653_056
    s = train_settings(GSConfig(), 800, 800, 4_653_056, 5_000_000)
    assert (s.tight_radius, s.pair_cull, s.sh_degree) == (True, True, 3)
    assert s.kept_capacity == s.pair_capacity == 4_653_056
    warm = GSConfig(sh_degree_interval=1000)
    assert train_settings(warm, 64, 64, 1 << 14, 1 << 14, 2500).sh_degree == 2
    assert train_settings(warm, 64, 64, 1 << 14, 1 << 14).sh_degree == 3
    assert not train_settings(GSConfig(), 64, 64, 1 << 14, 1 << 14,
                              pair_cull=False).pair_cull
