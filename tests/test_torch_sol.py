"""The port's speed-of-light model against the JAX model's (CPU).

- K3's plain version (``gstpu_torch.sol_model.sol_compositing_plain``)
  against ``scripts/sol_model.py::sol_compositing`` run in Pallas interpret
  mode (``pallas_call`` wrapped with ``interpret=True``, ``TILES`` set to 2
  or 3, ``_timeit`` returning the kernel's output in place of a time; nothing
  in ``scripts/`` changes): forward within 2e-6 absolute, backward within
  1e-6 of each output row's largest magnitude (the JAX kernel takes the
  product by roll-doubling and the prefix sum by a triangular matrix product,
  the plain version by ``cumprod`` and ``cumsum``).
- ``kernel_model``, a NumPy model of K3's arithmetic in the order of
  ``csrc/sol_compositing.cu`` with the design constants read from it (lanes
  walked in order, t_ex from the exclusive product or by division, the six
  gradient terms summed per pixel, then over each thread's pixels, the
  warp's butterfly, the warp partials in order), against the plain version,
  within the limits that the card check holds the kernel to
  (``chip_smoke.K3_FWD_TOL``, ``K3_BWD_REL_TOL``); and ``tile_walk``, the
  kernel's walk of a grid of CTAs over the tiles, at tile counts that no
  grid divides and at 0 tiles.
- The sort stage exactly equal to ``jax.lax.sort`` (two keys, stable), the
  scans to ``jnp.cumsum`` and ``lax.cummax``, dtypes included.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from chip_smoke import K3_BWD_REL_TOL, K3_FWD_TOL
from gstpu_torch import sol_model
from gstpu_torch.ops import cuda_build
from scripts import sol_model as jax_sol

FWD_TOL = 2e-6
BWD_REL_TOL = 1e-6


@pytest.fixture
def jax_k3(monkeypatch):
    """``run(n_chunks, tiles, backward)``: the JAX model's kernel output."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jax_sol, "_timeit", lambda fn, *a, **k: fn())

    def run(n_chunks, tiles, backward):
        monkeypatch.setattr(jax_sol, "TILES", tiles)
        return np.asarray(jax_sol.sol_compositing(n_chunks, backward))
    return run


def _row_rel(got, want):
    """Largest error of each output row over that row's largest magnitude."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return (np.abs(got - want).max(axis=(0, 2))
            / np.abs(want).max(axis=(0, 2)))


def _plain(n_chunks, tiles, backward):
    return sol_model.sol_compositing_plain(sol_model.feature_block("cpu"),
                                           n_chunks, tiles, backward).numpy()


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("n_chunks,tiles", [(1, 2), (2, 3), (5, 2)])
def test_plain_k3_matches_jax_interpret(jax_k3, n_chunks, tiles, backward):
    want = jax_k3(n_chunks, tiles, backward)
    got = _plain(n_chunks, tiles, backward)
    assert got.shape == want.shape == (tiles, 2, 128 if backward else 256)
    assert got.dtype == want.dtype == np.float32
    if backward:
        assert np.abs(want).max() > 10.0
        assert (_row_rel(got, want) < BWD_REL_TOL).all(), _row_rel(got, want)
    else:
        assert (want[:, 1] < 1.0).any()            # the T carry moved
        assert np.abs(got - want).max() < FWD_TOL


def k3_constants() -> dict:
    """The design constants of ``csrc/sol_compositing.cu``: {name: int or
    bool}."""
    text = (cuda_build.CSRC / "sol_compositing.cu").read_text()
    return {name: value == "true" if value in ("true", "false")
            else int(value)
            for name, value in re.findall(
                r"constexpr (?:int|bool) (k\w+) = (\d+|true|false);", text)}


def _warp_sum(v, pix_per_thread: int):
    """The backward's sum of the 256 pixels' values per warp: each thread's
    ``pix_per_thread`` pixels (pixels pix_per_thread * t + k) in order, then
    the 32 threads of the warp in the butterfly's tree (distance 16 first,
    as ``s += __shfl_down_sync(s, off)`` for off 16..1 sums into lane 0)."""
    per_thread = v.reshape(-1, pix_per_thread)
    s = per_thread[:, 0].copy()
    for k in range(1, pix_per_thread):
        s = s + per_thread[:, k]
    s = s.reshape(-1, 32)
    for off in (16, 8, 4, 2, 1):
        s[:, :32 - off] = s[:, :32 - off] + s[:, off:]
    return s[:, 0]


def kernel_model(feat: np.ndarray, n_chunks: int, backward: bool):
    """K3's arithmetic for one tile in float32 NumPy: (2, 256) forward,
    (2, 128) backward, as ``csrc/sol_compositing.cu`` orders it."""
    consts = k3_constants()
    pix_per_thread = consts["kBwdPixPerThread"]
    warps = 256 // pix_per_thread // 32
    f32 = np.float32
    blk = feat[0]
    pix_x = np.arange(256).astype(f32) * f32(0.0625)
    pix_y = pix_x * f32(0.5)
    trans = np.ones(256, f32)
    acc0 = np.zeros(256, f32)
    prefix_u = np.zeros(256, f32)
    lane_acc = np.zeros((2, 128), f32)
    for c in range(n_chunks):
        s = f32(1.0) + f32(c) * sol_model.TIE
        prod = np.ones(256, f32)
        p_last = np.full(256, np.inf, f32)
        cum_u = np.zeros(256, f32)
        part = np.zeros((warps, 2, 128), f32)
        for j in range(128):
            x, y, ca, cb, cc, op, f6, f7, f8, f9 = (blk[k, j] * s
                                                    for k in range(10))
            dx = x - pix_x
            dy = y - pix_y
            power = f32(-0.5) * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            g = np.exp(np.minimum(power, f32(0.0)))
            alpha = np.minimum(f32(0.99), op * g)
            alpha = np.where(alpha >= f32(1.0 / 255.0), alpha, f32(0.0))
            before = prod
            prod = prod * (f32(1.0) - alpha)
            p_incl = trans * prod
            if consts["kExclusiveT"]:
                t_ex = trans * before
            else:
                t_ex = p_incl / (f32(1.0) - alpha)
            kept = p_incl >= f32(1e-4)
            w = np.where(kept, alpha * t_ex, f32(0.0))
            p_last = np.where(kept, np.minimum(p_last, p_incl), p_last)
            if not backward:
                acc0 = acc0 + w * f6
                continue
            cdot = (f6 + f7 + f8 + f9) * w
            u = w * cdot
            cum_u = cum_u + u
            inv_one_m = f32(1.0) / (f32(1.0) - alpha)
            dl_da = np.where(kept, cdot * t_ex - (prefix_u + cum_u) * inv_one_m
                             - inv_one_m * f32(0.25), f32(0.0))
            dl_dg = op * dl_da
            gdx = g * dx
            gdy = g * dy
            r = dl_dg * (-gdx * ca - gdy * cb)
            r = r + dl_dg * (-gdy * cc - gdx * cb)
            r = r + f32(-0.5) * gdx * dx * dl_dg
            r = r + f32(-0.5) * gdx * dy * dl_dg
            r = r + f32(-0.5) * gdy * dy * dl_dg
            r = r + np.where(kept, g, f32(0.0)) * dl_da
            r2 = w * pix_x
            r2 = r2 + w * pix_y
            r2 = r2 + w * (pix_x + f32(1.0))
            r2 = r2 + w * cdot
            part[:, 0, j] = _warp_sum(r, pix_per_thread)
            part[:, 1, j] = _warp_sum(r2, pix_per_thread)
        trans = np.where(np.isfinite(p_last), p_last, trans)
        if backward:
            prefix_u = prefix_u + cum_u
            total = part[0]
            for w_ in range(1, warps):
                total = total + part[w_]
            lane_acc = lane_acc + total
    return lane_acc if backward else np.stack([acc0, trans])


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("n_chunks", [1, 2, 5])
def test_kernel_model_matches_plain(n_chunks, backward):
    feat = sol_model.feature_block("cpu").numpy()
    got = kernel_model(feat, n_chunks, backward)[None]
    want = _plain(n_chunks, 1, backward)
    assert got.dtype == np.float32 and got.shape == want.shape
    if backward:
        assert (_row_rel(got, want) < K3_BWD_REL_TOL).all()
    else:
        assert np.abs(got - want).max() < K3_FWD_TOL


def tile_walk(tiles: int, grid: int) -> list:
    """The tiles that each CTA of a grid of ``grid`` walks, as the kernel's
    ``for (tile = blockIdx.x; tile < tiles; tile += gridDim.x)``."""
    return [list(range(b, tiles, grid)) for b in range(grid)]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("tiles,grid", [(3, 2), (5, 3), (3, 3), (0, 0)])
def test_kernel_model_over_a_grid_matches_plain(tiles, grid, backward):
    """Each tile computed by the CTA that walks it, once; the launch grid
    (a CTA per tile, or fewer CTAs striding over the tiles) need not divide
    the tile count, and 0 tiles launch nothing."""
    feat = sol_model.feature_block("cpu").numpy()
    walked = tile_walk(tiles, grid)
    assert sorted(t for cta in walked for t in cta) == list(range(tiles))
    want = _plain(2, tiles, backward)
    got = np.zeros(want.shape, np.float32)
    for cta in walked:
        for t in cta:
            got[t] = kernel_model(feat, 2, backward)
    assert want.shape == (tiles, 2, 128 if backward else 256)
    if tiles == 0:
        return
    if backward:
        assert (_row_rel(got, want) < K3_BWD_REL_TOL).all()
    else:
        assert np.abs(got - want).max() < K3_FWD_TOL


def test_k3_constants_are_read_from_the_source():
    consts = k3_constants()
    assert set(consts) >= {"kFwdPixPerThread", "kBwdPixPerThread",
                           "kLaneBatch", "kHoistLanes", "kExclusiveT",
                           "kPersistent"}
    for name in ("kFwdPixPerThread", "kBwdPixPerThread"):
        assert consts[name] in (1, 2, 4, 8)
    assert 2 * consts["kLaneBatch"] in (2, 4, 8, 16, 32)
    assert isinstance(consts["kExclusiveT"], bool)


def test_k3_wrapper_runs_the_plain_version_on_the_cpu():
    feat = sol_model.feature_block("cpu")
    before = dict(sol_model.LAUNCHES)
    for backward in (False, True):
        got = sol_model.sol_compositing(feat, 2, 3, backward)
        assert torch.equal(got, sol_model.sol_compositing_plain(feat, 2, 3,
                                                                backward))
        assert torch.equal(got, got[:1].expand_as(got))   # identical tiles
        empty = sol_model.sol_compositing(feat, 2, 0, backward)
        assert empty.shape == (0, 2, 128 if backward else 256)
    assert sol_model.LAUNCHES == before


def test_k3_wrapper_refuses_a_device_without_a_kernel():
    feat = sol_model.feature_block("cpu").to("meta")
    before = dict(sol_model.LAUNCHES)
    with pytest.raises(ValueError, match="no K3 kernel for device meta"):
        sol_model.sol_compositing(feat, 2, 3, False)
    assert sol_model.LAUNCHES == before


def test_k3_bound_at_the_model_volumes():
    assert sol_model.N_CHUNKS == 2 and sol_model.TILES == 2500
    assert sol_model.SORT_PAIRS == 1 << 19
    for backward, out_bytes in ((False, 5_120_000), (True, 2_560_000)):
        b = sol_model.k3_bound(sol_model.TILES, sol_model.N_CHUNKS, backward,
                               67e12, 3.35e12)
        assert b["steps"] == 163_840_000
        assert b["bytes"] == 8192 + out_bytes
        assert b["bound_by"] == "operations"
        assert b["bound_ms"] == b["flop_bound_ms"] > b["byte_bound_ms"]


@pytest.mark.parametrize("case", ["model inputs", "ties"])
def test_pair_sort_equals_lax_sort(case):
    a, b, c, _ = sol_model.sort_inputs("cpu", 4096)
    if case == "ties":        # equal (a, b) keys: the sort must be stable
        rng = np.random.default_rng(1)
        a = torch.tensor(rng.integers(0, 8, 4096).astype(np.int32))
        b = torch.tensor(rng.integers(0, 4, 4096).astype(np.int32))
        c = torch.arange(4096, dtype=torch.int32)
    want = jax.lax.sort(tuple(jnp.asarray(x.numpy()) for x in (a, b, c)),
                        num_keys=2, is_stable=True)
    for got, ref in zip(sol_model.pair_sort(a, b, c), want):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_binning_scans_equal_jax():
    _, b, _, _ = sol_model.sort_inputs("cpu", 4096)
    csum, cmax = sol_model.binning_scans(b)
    jb = jnp.asarray(b.numpy())
    for got, ref in ((csum, jnp.cumsum(jb)), (cmax, jax.lax.cummax(jb))):
        assert np.asarray(ref).dtype == np.int32 and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (csum.numpy() < 0).any()          # the int32 sum wrapped, as XLA's


def test_sol_model_needs_the_card():
    with pytest.raises(RuntimeError):
        sol_model.run("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sol_model.run()
