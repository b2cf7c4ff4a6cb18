"""One sharded step of the port against gstpu's (CPU).

The port's step (``gstpu_torch.parallel.make_sharded_train_step``) runs on
a 2x2 gloo group of spawned processes; gstpu's
(``gstpu.parallel.make_sharded_train_step``) on a 2x2 mesh of the virtual
CPU devices that ``tests/conftest.py`` forces; both at 32x32 from the same
40 Gaussians, two cameras' targets, L1 + 0.2 DSSIM (so the halo exchange
runs).  Tolerances of ``tests/test_sharded.py``'s DSSIM case: loss within
1e-5, position gradients within 2e-5 of their scale; the pair counts
equal.  The
stepped parameters are not compared across packages: at iteration 0 Adam
moves each by about lr * sign(g), so a near-zero gradient that differs in
its last bit moves it by 2 lr (``tests/test_torch_train_step.py``).

Then ``losses.ssim_map_chunks`` against gstpu's on halo-extended chunks,
within 1e-5: a per-pixel quotient of window sums that the two packages'
convolutions add in different orders (the SSIM tests of
``tests/test_torch_losses_optim.py`` allow 1e-5 of the scale too).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpu.ops.losses import ssim_map_chunks as jax_ssim_map_chunks
from gstpu.optim import init_adam_state as jax_init_adam
from gstpu.parallel import make_mesh as jax_make_mesh
from gstpu.parallel import make_sharded_train_step as jax_sharded_step
from gstpu.parallel.sharded import pad_targets_to_grid as jax_pad
from gstpu.config import GSConfig as JaxConfig
from gstpu.config import RenderSettings as JaxSettings
from gstpu_torch.ops.losses import ssim_map_chunks
from tests.test_torch_parallel import _vs_gstpu_step, run_ranks, \
    vs_gstpu_inputs


def test_sharded_step_matches_gstpu_sharded_step(tmp_path):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) JAX devices")
    cam, params, targets, config, settings = vs_gstpu_inputs()
    mesh = jax_make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    jsettings = JaxSettings(width=settings.width, height=settings.height,
                            pair_capacity=settings.pair_capacity)
    # jitted, as gstpu's Trainer runs it (an eager shard_map takes minutes)
    step = jax.jit(jax_sharded_step(
        jsettings, JaxConfig(lambda_dssim=config.lambda_dssim), mesh))
    j = jnp.asarray
    jp = {k: j(v) for k, v in params.items()}
    n = params["positions"].shape[0]
    _, _, loss, pos_grads, counts, _ = step(
        jp, jax_init_adam(jp), jnp.ones(n, bool),
        jnp.tile(j(cam["view"])[None], (2, 1, 1)),
        jnp.tile(j(cam["proj"])[None], (2, 1, 1)),
        jnp.tile(j(cam["campos"])[None], (2, 1)),
        jnp.full((2,), cam["tan_fovx"], jnp.float32),
        jnp.full((2,), cam["tan_fovy"], jnp.float32),
        jax_pad(j(targets), jsettings, n_model=2), jnp.int32(0))
    want = np.asarray(pos_grads)
    scale = float(np.abs(want).max())
    assert scale > 1e-4

    ranks = run_ranks(_vs_gstpu_step, 4, tmp_path)
    for got in ranks:
        assert abs(got["loss"] - float(loss)) < 1e-5
        np.testing.assert_allclose(got["pos_grads"] / scale, want / scale,
                                   atol=2e-5)
        assert got["counts"] == np.asarray(counts).tolist()


@pytest.mark.parametrize("rows", [16, 32])
def test_ssim_map_chunks_matches_gstpu(rows):
    rng = np.random.default_rng(rows)
    img = rng.uniform(0, 1, (3, rows + 10, 24, 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (3, rows + 10, 24, 3)).astype(np.float32)
    got = ssim_map_chunks(torch.tensor(img), torch.tensor(tgt)).numpy()
    want = np.asarray(jax_ssim_map_chunks(jnp.asarray(img),
                                          jnp.asarray(tgt)))
    assert got.shape == (3, rows, 24, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
