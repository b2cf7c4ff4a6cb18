"""Densification of the PyTorch port against gstpu's (CPU).

Both packages' noise hooks are pinned to the index-keyed hash of
``scripts/compare_ref_training.py`` (clone noise by source index, split
jitter by target index), so an event draws the same numbers in both.  On
the same model and gradients the two must then give equal masks, counts and
``DensifyStats``, and float arrays within 1e-6 (the same float32
arithmetic).  ``official_split_sampling`` draws its normals inline with no
hook, so there only the counts, the child scales and the removals are
compared.  Every call must leave the port's input model unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpu import densify as jax_densify
from gstpu.config import GSConfig as JaxConfig
from gstpu.models.gaussians import GaussianModel as JaxModel
from gstpu.models.gaussians import grow_capacity as jax_grow_capacity
from gstpu.models.gaussians import init_model as jax_init_model
from gstpu_torch import convert, densify
from gstpu_torch.config import GSConfig
from gstpu_torch.models.gaussians import grow_capacity

FLOAT_TOL = 1e-6
EXTENT = 10.0
STAT_FIELDS = densify.DensifyStats._fields
MODEL_FIELDS = ("positions", "scales", "rotations", "opacities", "shs",
                "alive", "n_alive")


def _jax_clone_noise(key, n, scale):
    seeds = (jnp.arange(n, dtype=jnp.int32)[:, None] * 3
             + jnp.arange(3, dtype=jnp.int32)[None, :])
    return ((seeds % 1024).astype(jnp.float32) / 1024.0) * scale


def _jax_split_jitter(key, target_idx, scale):
    seeds = (target_idx[:, None].astype(jnp.int32) * 3
             + jnp.arange(3, dtype=jnp.int32)[None, :])
    return ((seeds % 1024).astype(jnp.float32) / 1024.0 * 2.0 - 1.0) * scale


def _clone_noise(generator, n, scale):
    seeds = (torch.arange(n, dtype=torch.int32)[:, None] * 3
             + torch.arange(3, dtype=torch.int32)[None, :])
    return ((seeds % 1024).to(torch.float32) / 1024.0) * scale


def _split_jitter(generator, target_idx, scale):
    seeds = (target_idx[:, None].to(torch.int32) * 3
             + torch.arange(3, dtype=torch.int32)[None, :])
    return ((seeds % 1024).to(torch.float32) / 1024.0 * 2.0 - 1.0) * scale


def pin_noise(monkeypatch) -> None:
    """Pin both packages' densify noise hooks to the index-keyed hash."""
    monkeypatch.setattr(jax_densify, "clone_position_noise", _jax_clone_noise)
    monkeypatch.setattr(jax_densify, "split_position_jitter",
                        _jax_split_jitter)
    monkeypatch.setattr(densify, "clone_position_noise", _clone_noise)
    monkeypatch.setattr(densify, "split_position_jitter", _split_jitter)


@pytest.fixture(autouse=True)
def pinned_noise(monkeypatch):
    pin_noise(monkeypatch)


def _configs(**kw):
    return JaxConfig(**kw), GSConfig(**kw)


def _arrays(model) -> dict:
    return {k: np.asarray(getattr(model, k)) for k in MODEL_FIELDS}


def _pair(arrays: dict):
    """(gstpu model, port model) from the same arrays."""
    jm = JaxModel(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jm, convert.model_from_numpy(arrays, "cpu")


def _tiny(n=8, capacity=32, **changes):
    """``tests/test_densify.py``'s model (init_model at PRNGKey(0)) with
    fields replaced; both packages' copies."""
    cfg = JaxConfig(num_points=n)
    arrays = _arrays(jax_init_model(jax.random.PRNGKey(0), cfg,
                                    capacity=capacity))
    arrays.update({k: np.asarray(v, arrays[k].dtype)
                   for k, v in changes.items()})
    return _pair(arrays)


def _port_arrays(model) -> dict:
    return {k: getattr(model, k).clone() for k in MODEL_FIELDS}


def _assert_unchanged(model, before: dict) -> None:
    for k, v in before.items():
        assert torch.equal(getattr(model, k), v), f"input {k} was modified"


def _assert_models_equal(got, want, float_tol=FLOAT_TOL) -> None:
    for k in MODEL_FIELDS:
        g, w = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=float_tol,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _densify_both(jm, pm, grads, jcfg, cfg):
    """Run one event in both packages; check the port's input is unchanged
    and its stats equal gstpu's.  Returns (gstpu, port) (model, stats)."""
    before = _port_arrays(pm)
    jnew, jstats = jax_densify.densify_and_prune(
        jm, jnp.asarray(grads), EXTENT, jcfg, jax.random.PRNGKey(1))
    new, stats = densify.densify_and_prune(
        pm, torch.from_numpy(np.asarray(grads, np.float32)), EXTENT, cfg,
        torch.Generator().manual_seed(1))
    _assert_unchanged(pm, before)
    for f in STAT_FIELDS:
        assert getattr(stats, f).shape == ()
        assert int(getattr(stats, f)) == int(getattr(jstats, f)), f
    return (jnew, jstats), (new, stats)


def _event(jm, pm, grads, **cfg):
    """One event in both packages, with the models compared."""
    jcfg, pcfg = _configs(num_points=8, **cfg)
    (jnew, _), (new, stats) = _densify_both(jm, pm, grads, jcfg, pcfg)
    _assert_models_equal(new, jnew)
    return new, stats


def test_clone_small_high_grad():
    jm, pm = _tiny(scales=np.full((32, 3), 0.001))
    grads = np.zeros((32, 3), np.float32)
    grads[0] = 1.0
    new, stats = _event(jm, pm, grads, min_valid_points=1)
    assert int(stats.n_cloned) == 1 and int(stats.n_split) == 0
    assert int(new.n_alive) == 9
    d = (new.positions[8] - pm.positions[0]).abs()
    assert bool((d <= 0.01).all())


def test_split_large_high_grad_removes_original():
    scales = np.full((32, 3), 0.001, np.float32)
    scales[2] = 0.5
    jm, pm = _tiny(scales=scales)
    grads = np.zeros((32, 3), np.float32)
    grads[2] = 1.0
    new, stats = _event(jm, pm, grads, min_valid_points=1)
    assert int(stats.n_split) == 2 and int(new.n_alive) == 9
    scl = new.scales[:9].numpy()
    children = np.where(np.isclose(scl.max(-1), 0.4))[0]
    assert len(children) == 2
    pos = new.positions[:9].numpy()
    assert np.all(np.abs(pos[children] - pm.positions[2].numpy()) <= 0.011)


def test_prune_low_opacity_with_guards():
    opac = np.full(32, 0.5, np.float32)
    opac[3] = 0.001
    jm, pm = _tiny(opacities=opac)
    new, stats = _event(jm, pm, np.zeros((32, 3), np.float32),
                        min_valid_points=1)
    assert int(stats.n_pruned) == 1 and int(new.n_alive) == 7
    assert bool(stats.changed)


def test_prune_guard_min_valid_points():
    jm, pm = _tiny(opacities=np.full(32, 0.001))
    new, stats = _event(jm, pm, np.zeros((32, 3), np.float32))
    assert int(stats.n_pruned) == 0 and int(new.n_alive) == 8


@pytest.mark.parametrize("parameterization", ["raw", "activated"])
def test_official_split_sampling(parameterization):
    """Children sampled from the parent's Gaussian: the same counts, child
    scales (0.5 / 1.6 in render space) and removals as gstpu; the sampled
    positions differ (inline normals), so only their spread is checked."""
    scales = np.full((32, 3), 0.001, np.float32)
    scales[2] = 0.5
    opac = np.asarray(_tiny()[0].opacities)
    if parameterization == "activated":
        scales, opac = np.log(scales), np.zeros(32, np.float32)
    jm, pm = _tiny(scales=scales, opacities=opac)
    grads = np.zeros((32, 3), np.float32)
    grads[2] = 1.0
    jcfg, cfg = _configs(num_points=8, min_valid_points=1,
                         official_split_sampling=True,
                         parameterization=parameterization)
    (jnew, _), (new, stats) = _densify_both(jm, pm, grads, jcfg, cfg)
    assert int(stats.n_split) == 2 and int(new.n_alive) == 9
    np.testing.assert_array_equal(new.alive.numpy(), np.asarray(jnew.alive))
    np.testing.assert_allclose(new.scales.numpy(), np.asarray(jnew.scales),
                               rtol=0, atol=FLOAT_TOL)
    real = new.scales[:9].numpy()
    if parameterization == "activated":
        real = np.exp(real)
    children = np.where(np.isclose(real.max(-1), 0.5 / 1.6))[0]
    assert len(children) == 2
    # the parent (index 2) is gone: the survivors keep their order
    keep = [i for i in range(8) if i != 2]
    np.testing.assert_array_equal(new.positions[:7].numpy(),
                                  pm.positions[keep].numpy())
    d = np.abs(new.positions[children].numpy() - pm.positions[2].numpy())
    assert d.max() > 0.05  # N(0, 0.5) draws, not the +-0.011 jitter


def test_q16_last_index_quirk_semantics():
    scales = np.full((32, 3), 0.001, np.float32)
    grads = np.zeros((32, 3), np.float32)
    grads[7] = 1.0
    # 1. the last element clone-masked: no clone; the engaged prune drops
    # the final survivor
    new, stats = _event(*_tiny(scales=scales), grads, min_valid_points=1,
                        q16_last_index=True)
    assert int(stats.n_cloned) == 0
    assert int(stats.n_pruned) == 1 and int(new.n_alive) == 7

    # 2. elements 2 and 7 split-masked
    grads2 = np.zeros((32, 3), np.float32)
    grads2[2] = grads2[7] = 1.0
    big = scales.copy()
    big[2] = big[7] = 0.5
    new, stats = _event(*_tiny(scales=big), grads2, min_valid_points=1,
                        q16_last_index=True)
    assert int(stats.n_split) == 1 and int(new.n_alive) == 6

    # 3. only the last element split-masked: the split block is skipped
    last_big = np.where(np.arange(32)[:, None] == 7, 0.5, 0.001)
    new, stats = _event(*_tiny(scales=last_big), grads, min_valid_points=1,
                        q16_last_index=True)
    assert int(stats.n_split) == 0 and int(new.n_alive) == 7

    # 4. the default config: exact counts
    new, stats = _event(*_tiny(scales=last_big), grads, min_valid_points=1)
    assert int(stats.n_split) == 2 and int(new.n_alive) == 9
    assert int(stats.n_pruned) == 0


def test_capacity_overflow_reported():
    jm, pm = _tiny(n=8, capacity=9, scales=np.full((9, 3), 0.001))
    new, stats = _event(jm, pm, np.ones((9, 3), np.float32),
                        min_valid_points=1)
    assert int(stats.overflow) > 0
    assert int(new.n_alive) <= 9


def test_compact_preserves_order_and_values():
    alive = np.zeros(16, bool)
    alive[[1, 3, 6]] = True
    jm, pm = _tiny(n=8, capacity=16, alive=alive)
    before = _port_arrays(pm)
    c = densify.compact(pm)
    _assert_unchanged(pm, before)
    _assert_models_equal(c, jax_densify.compact(jm), float_tol=0.0)
    assert int(c.n_alive) == 3
    np.testing.assert_array_equal(c.positions[:3].numpy(),
                                  pm.positions[[1, 3, 6]].numpy())
    assert bool(c.alive[:3].all()) and not bool(c.alive[3:].any())


@pytest.mark.parametrize("parameterization", ["raw", "activated"])
def test_opacity_reset_all_alive(parameterization):
    opac = np.linspace(-3.0, 3.0, 32) if parameterization == "activated" \
        else np.linspace(0.0, 1.0, 32)
    jm, pm = _tiny(opacities=opac)
    before = _port_arrays(pm)
    new = densify.reset_opacities(pm, 0.01, parameterization)
    _assert_unchanged(pm, before)
    want = jax_densify.reset_opacities(jm, 0.01, parameterization)
    np.testing.assert_allclose(new.opacities.numpy(),
                               np.asarray(want.opacities), rtol=0,
                               atol=FLOAT_TOL)
    # dead slots untouched
    np.testing.assert_array_equal(new.opacities[8:].numpy(), opac[8:]
                                  .astype(np.float32))
    if parameterization == "raw":
        assert np.allclose(new.opacities[:8].numpy(), 0.01)


def test_opacity_reset_trigger():
    configs = [dict(), dict(background_color=(1.0, 1.0, 1.0)),
               dict(opacity_reset_until_iter=15000),
               dict(parameterization="activated"),
               dict(opacity_reset_interval=7, densify_from_iter=3,
                    background_color=(1.0, 1.0, 1.0))]
    iters = [0, 3, 7, 14, 500, 3000, 6000, 12000, 15000, 18000, 27000]
    for kw in configs:
        jcfg, cfg = _configs(**kw)
        for it in iters:
            assert densify.should_reset_opacity(cfg, it) \
                == jax_densify.should_reset_opacity(jcfg, it), (kw, it)
    cfg = GSConfig()
    assert densify.should_reset_opacity(cfg, 3000)
    assert not densify.should_reset_opacity(cfg, 500)
    assert densify.should_reset_opacity(
        cfg.replace(background_color=(1.0, 1.0, 1.0)), 500)
    assert not densify.should_reset_opacity(
        cfg.replace(opacity_reset_until_iter=15000), 15000)


def test_grow_capacity_preserves_state():
    jm, pm = _tiny(n=8, capacity=16)
    g = grow_capacity(pm, 64)
    assert g.capacity == 64 and int(g.n_alive) == 8
    _assert_models_equal(g, jax_grow_capacity(jm, 64), float_tol=0.0)
    assert not bool(g.alive[16:].any())


def _random_arrays(rng, n, capacity, activated):
    """A model of ``n`` live Gaussians in ``capacity`` slots: a third of
    them large (split candidates at EXTENT), a tenth of them transparent
    (prune candidates), dead slots holding garbage."""
    pos = rng.uniform(-1, 1, (capacity, 3)).astype(np.float32)
    scales = rng.uniform(0.001, 0.05, (capacity, 3)).astype(np.float32)
    big = rng.random(capacity) < 0.33
    scales[big] = rng.uniform(0.2, 0.6, (int(big.sum()), 3))
    q = rng.normal(size=(capacity, 4)).astype(np.float32)
    rot = q / np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.05, 0.9, capacity).astype(np.float32)
    opac[rng.random(capacity) < 0.1] = 0.001
    shs = rng.normal(size=(capacity, 16, 3)).astype(np.float32)
    if activated:
        scales = np.log(scales)
        opac = np.log(opac / (1.0 - opac))
    alive = np.arange(capacity) < n
    return dict(positions=pos, scales=scales, rotations=rot,
                opacities=opac.astype(np.float32), shs=shs, alive=alive,
                n_alive=np.int32(n))


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("q16", [False, True])
@pytest.mark.parametrize("parameterization", ["raw", "activated"])
def test_random_model_matches_gstpu(parameterization, q16, overflow):
    """A random model through one event: equal masks, counts and stats;
    floats within 1e-6; the last live element split-masked, so the Q16
    branches engage."""
    rng = np.random.default_rng(
        [("raw", "activated").index(parameterization), q16, overflow])
    n, capacity = 200, 600
    arrays = _random_arrays(rng, n, capacity, parameterization == "activated")
    grads = rng.normal(0, 1e-4, (capacity, 3)).astype(np.float32)
    grads[n - 1] = 1.0
    arrays["scales"][n - 1] = (np.log(0.5) if parameterization == "activated"
                               else 0.5)
    if overflow:
        # room for every clone and three split children
        real = arrays["scales"][:n]
        real = np.exp(real) if parameterization == "activated" else real
        small = real.max(-1) <= 0.01 * EXTENT
        high = np.linalg.norm(grads[:n], axis=-1) >= 2e-4
        capacity = n + int(np.sum(small & high)) + 3
        arrays = {k: v[:capacity] if np.ndim(v) else v
                  for k, v in arrays.items()}
        grads = grads[:capacity]
    jm, pm = _pair(arrays)
    jcfg, cfg = _configs(num_points=n, min_valid_points=1,
                         parameterization=parameterization, q16_last_index=q16)
    (jnew, _), (new, stats) = _densify_both(jm, pm, grads, jcfg, cfg)
    _assert_models_equal(new, jnew)
    assert int(stats.n_cloned) > 0 and int(stats.n_split) > 0
    assert int(stats.n_pruned) > 0
    assert (int(stats.overflow) > 0) == overflow
