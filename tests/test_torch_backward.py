"""Backward compositing of the PyTorch port against gstpu's (CPU).

- The port's plain ``composite_backward`` (the CPU form of kernel K2,
  ``csrc/rasterize_bwd.cu``) against gstpu's XLA ``composite_backward``,
  against the stored gradients of ``tests/golden/pallas_gate.npz`` and
  against gstpu's Pallas kernel in interpret mode on the high-opacity
  early-exit scene.  Tolerance 1e-5 of each output's largest magnitude, as
  ``tests/test_pallas.py`` pins the Pallas kernel to the XLA path: the same
  forward-order algorithm, summed in another order.
- ``sequential_rows``, a NumPy model of K2's arithmetic (one pixel per
  lane, pairs walked one by one with the sequential transmittance, one row
  of ten sums per pair slot), through the port's epilogue
  ``segment_sum_pair_rows``, against gstpu's gradients: 1e-4 of the largest
  magnitude, because the sequential transmittance rounds differently from
  the cumulative product, an error the (1 - alpha) divisions amplify.
- The segmented form of the model, as K2 runs under the differentiable
  render: each work item (tile, segment) starts from ``forward_checkpoints``,
  a NumPy model of K1's checkpoints (T, color, inverse depth and done at
  every ``segment``-th pair).  Only the prefix it takes from a checkpoint
  rounds differently: C . dL/dpix + D * dL/ddepth in one expression where
  the walk adds w * cdot pair by pair, about one float32 ulp of ctot_dot,
  which the 1 / (1 - alpha) <= 100 of dL/dalpha amplifies.  So its rows
  stay within SEGMENT_TOL = 5e-6 of each field's largest magnitude of the
  unsegmented model's rows (2.7e-6 at most on these scenes), and through the
  epilogue within the same 1e-4 of gstpu's gradients.  A checkpoint k equals the port's plain
  forward on tile counts cut to k * segment.
- The epilogue alone against ``index_add_`` of the rows by Gaussian id,
  with the two-tier kept slice (slots past it read the zero row).
- ``render`` on the CPU: the kernel wrappers run the plain versions, K1
  makes no checkpoints and K2 gets none, and the gradients equal gstpu's.
"""

import dataclasses

import jax
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
from gstpu.ops.rasterize import render as jax_render
from gstpu_torch import convert
from gstpu_torch import scenes as torch_scenes
from gstpu_torch.config import RenderSettings
from gstpu_torch.ops import cuda_rasterize
from gstpu_torch.ops import rasterize as TR
from gstpu_torch.utils import tracing

GRAD_NAMES = ("d_color", "d_mean2d", "d_conic", "d_opac", "d_invdepth")


def _scene(seed, opac, n=80, size=64, cull=False, band=False):
    """The scene of tests/test_pallas.py::_setup as NumPy dicts, with the
    forward outputs and seeded cotangents (depth included).  ``band``
    rasterizes tile rows 1 and 3 only (row0 1, row stride 2)."""
    rng = np.random.default_rng(seed)
    cam = scenes.example_camera(width=size, height=size)
    pts, shs, scales, rotations, opacities = scenes.random_scene(
        rng, n=n, opacity_range=opac)
    j = jnp.asarray
    kw = dict(width=size, height=size, pair_capacity=1 << 13)
    if cull:
        # between the post-cull (389) and pre-cull (447) pair counts
        kw.update(pair_cull=True, kept_capacity=416)
    row0 = 0
    if band:
        kw.update(tile_rows=2, row_stride=2)
        row0 = 1
    s = JaxSettings(**kw)
    prep = preprocess(j(pts), j(scales), j(rotations), j(opacities), j(shs),
                      j(cam["view"]), j(cam["proj"]), j(cam["campos"]),
                      size, size, cam["tan_fovx"], cam["tan_fovy"],
                      s.grid_x, s.grid_y, 3)
    cull_kw = {}
    if cull:
        ca, cb, cc = prep.conic[:, 0], prep.conic[:, 1], prep.conic[:, 2]
        mid = 0.5 * (ca + cc)
        lam = mid - jnp.sqrt(jnp.maximum(mid * mid - (ca * cc - cb * cb),
                                         0.0))
        log_term = 2.0 * jnp.log(jnp.maximum(255.0 * prep.opacity, 1e-12))
        cull_kw = dict(cull_xy=prep.xy, cull_tcut=jnp.where(
            lam > 0.0, 1.0001 * log_term / lam, jnp.inf),
            kept_capacity=s.kept_capacity)
    rect, tiles = R.clip_rect_to_band(prep.rect, prep.tiles_touched, row0,
                                      s.band_rows, s.row_stride)
    pairs = build_pairs(tiles, rect, prep.depth, s.grid_x, s.band_tiles,
                        s.pair_capacity, row0=row0, row_stride=s.row_stride,
                        **cull_kw)
    color, dacc, final_t, _ = R.composite_forward(prep, pairs, s, row0=row0)
    ct = rng.normal(0, 1, (s.band_tiles, 256, 3)).astype(np.float32)
    ct_d = rng.normal(0, 1, (s.band_tiles, 256)).astype(np.float32)
    inputs = dict(color_pre_bg=np.asarray(color), final_t=np.asarray(final_t),
                  dl_dpix=ct, bg=np.asarray([0.2, 0.1, 0.4], np.float32),
                  depth_acc=np.asarray(dacc), dl_ddepth=ct_d, row0=row0)
    return (RenderSettings(**kw),
            {k: np.asarray(v) for k, v in prep._asdict().items()},
            {k: np.asarray(v) for k, v in pairs._asdict().items()}, inputs)


def _gate():
    g = np.load(torch_scenes.GATE_NPZ)
    inputs = dict(color_pre_bg=g["color"], final_t=g["final_t"],
                  dl_dpix=g["dl_dpix"], bg=np.zeros(3, np.float32),
                  depth_acc=g["depth"], dl_ddepth=g["ct_d"])
    return (RenderSettings(width=160, height=160, pair_capacity=1 << 16),
            {k: g[f"prep_{k}"] for k in JaxPrep._fields},
            {k: g[f"pairs_{k}"] for k in JaxPairs._fields}, inputs, g)


def _early_exit():
    """tests/test_pallas.py's early-exit scene (seed 7, opacities 0.85-1),
    as gstpu_torch.scenes.early_exit_scene builds it."""
    settings, p, cam, ct, ct_d, bg = torch_scenes.early_exit_scene()
    j = jnp.asarray
    s = JaxSettings(width=settings.width, height=settings.height,
                    pair_capacity=settings.pair_capacity)
    prep = preprocess(j(p["positions"]), j(p["scales"]), j(p["rotations"]),
                      j(p["opacities"]), j(p["shs"]), j(cam["view"]),
                      j(cam["proj"]), j(cam["campos"]), s.width, s.height,
                      cam["tan_fovx"], cam["tan_fovy"], s.grid_x, s.grid_y, 3)
    pairs = build_pairs(prep.tiles_touched, prep.rect, prep.depth,
                        s.grid_x, s.num_tiles, s.pair_capacity)
    color, dacc, final_t, _ = R.composite_forward(prep, pairs, s)
    inputs = dict(color_pre_bg=np.asarray(color), final_t=np.asarray(final_t),
                  dl_dpix=ct, bg=bg, depth_acc=np.asarray(dacc),
                  dl_ddepth=ct_d)
    return (settings, {k: np.asarray(v) for k, v in prep._asdict().items()},
            {k: np.asarray(v) for k, v in pairs._asdict().items()}, inputs)


def _torch_args(prep_np, pairs_np, inputs):
    return (convert.prep_from_numpy(prep_np, "cpu", prefix=""),
            convert.pairs_from_numpy(pairs_np, "cpu", prefix=""),
            {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
             for k, v in inputs.items()})


def _jax_args(settings, prep_np, pairs_np, inputs):
    s = JaxSettings(**{f.name: getattr(settings, f.name)
                       for f in dataclasses.fields(settings)})
    return (s, JaxPrep(**{k: jnp.asarray(v) for k, v in prep_np.items()}),
            JaxPairs(**{k: jnp.asarray(v) for k, v in pairs_np.items()}),
            {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
             for k, v in inputs.items()})


def _assert_grads_close(got, want, rel):
    for a, b, name in zip(got, want, GRAD_NAMES):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, atol=rel,
                                   err_msg=name)


def _model_inputs(prep, pairs, settings, row0):
    f32 = np.float32
    depth = prep.depth.numpy()
    pix_x, pix_y = (x.numpy() for x in TR._tile_pixel_coords(settings, row0))
    return dict(
        xy=prep.xy.numpy(), conic=prep.conic.numpy(), op=prep.opacity.numpy(),
        rgb=prep.rgb.numpy(),
        inv_depth=(f32(1.0) / np.where(depth == 0.0, f32(1.0), depth)
                   ).astype(f32),
        gauss_id=pairs.gauss_id.numpy(), starts=pairs.tile_start.numpy(),
        counts=pairs.tile_count.numpy(), pix_x=pix_x, pix_y=pix_y)


def _pair_alpha(m, gi, tile):
    """Alpha, skip and exp of one pair at a tile's 256 pixels, in
    float32 as composite_common.cuh computes them."""
    f32 = np.float32
    dx = m["xy"][gi, 0] - m["pix_x"][tile]
    dy = m["xy"][gi, 1] - m["pix_y"][tile]
    ca, cb, cc = m["conic"][gi]
    power = f32(-0.5) * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    g = np.exp(np.minimum(power, f32(0.0)))
    alpha = np.minimum(f32(0.99), m["op"][gi] * g)
    passing = (power <= 0.0) & (alpha >= f32(1.0 / 255.0))
    return dx, dy, (ca, cb, cc), g, alpha, passing


def forward_checkpoints(prep, pairs, settings, segment, row0=0):
    """NumPy model of K1's checkpoints (``cuda_rasterize.Checkpoints``):
    the forward walk of each tile, its state (T, color r/g/b, inverse
    depth, done) recorded before the pairs at positions 0, segment,
    2 * segment, ... of the tile, in the slot of work item (tile, k) of the
    work list that ``cuda_rasterize.build_work_list`` and ``work_items``
    make (K1 writes the same items)."""
    f32 = np.float32
    m = _model_inputs(prep, pairs, settings, row0)
    work = cuda_rasterize.build_work_list(pairs.tile_count,
                                          pairs.gauss_id.shape[0], segment)
    work = work._replace(items=cuda_rasterize.work_items(work,
                                                         pairs.tile_count))
    slot = {(tile, k): b for b, (tile, k)
            in enumerate(work.items[:int(work.ends[-1])].tolist())}
    state = np.full((work.items.shape[0], 6, 256), np.nan, f32)
    for tile in range(settings.band_tiles):
        trans = np.ones(256, f32)
        c = np.zeros((4, 256), f32)              # color r, g, b; inverse depth
        done = np.zeros(256, bool)
        for pos in range(m["counts"][tile]):
            if pos % segment == 0:
                state[slot[tile, pos // segment]] = np.concatenate(
                    [trans[None], c, done[None].astype(f32)])
            if done.all():
                continue
            gi = m["gauss_id"][m["starts"][tile] + pos]
            alpha, passing = _pair_alpha(m, gi, tile)[4:]
            passing &= ~done
            test_t = trans * (f32(1.0) - alpha)
            kept = passing & (test_t >= f32(1e-4))
            done |= passing & (test_t < f32(1e-4))
            w = alpha * trans
            feat = np.append(m["rgb"][gi], m["inv_depth"][gi]).astype(f32)
            c = np.where(kept, c + w * feat[:, None], c)
            trans = np.where(kept, test_t, trans)
    return cuda_rasterize.Checkpoints(work, torch.from_numpy(state))


def sequential_rows(prep, pairs, settings, color_pre_bg, final_t, dl_dpix,
                    bg, depth_acc, dl_ddepth, row0=0, checkpoints=None):
    """NumPy model of K2: the (K2 + 1, 10) per-pair rows the kernel writes.

    For each tile the 256 pixels are one float32 vector; the tile's pairs
    are walked one at a time as the kernel's threads walk them: alpha with
    the individual skips, the sequential transmittance T * (1 - alpha) with
    the break below 1e-4, the running prefix of w * cdot, and the ten
    gradient terms of the kept pixels summed into the pair's row.  The walk
    stops once every pixel is done (the kernel's rows past its exit stay
    zero).

    With ``checkpoints`` (``forward_checkpoints`` or K1's) the walk runs
    per work item b, as the kernel does under the differentiable render:
    the segment's pairs from checkpoint b's T and done, with the prefix
    C . dL/dpix + D * dL/ddepth of its color C and inverse depth D.
    """
    f32 = np.float32
    m = _model_inputs(prep, pairs, settings, row0)
    ct, ct_d = dl_dpix.numpy(), dl_ddepth.numpy()
    ft = final_t.numpy()
    ctot_dot = (np.sum(color_pre_bg.numpy() * ct, -1, dtype=f32)
                + depth_acc.numpy() * ct_d).astype(f32)
    bg_dot = np.sum(bg.numpy()[None, None, :] * ct, -1, dtype=f32)
    rows = np.zeros((m["gauss_id"].shape[0] + 1, 10), f32)
    if checkpoints is None:
        walks = [(tile, 0, m["counts"][tile], np.ones(256, f32),
                  np.zeros(256, f32), np.zeros(256, bool))
                 for tile in range(settings.band_tiles)]
    else:
        work, state = checkpoints
        seg, state = work.segment, state.numpy()
        walks = []
        for b, (tile, k) in enumerate(work.items[:int(work.ends[-1])].numpy()):
            c = state[b]
            prefix = (c[1] * ct[tile, :, 0] + c[2] * ct[tile, :, 1]
                      + c[3] * ct[tile, :, 2] + c[4] * ct_d[tile])
            walks.append((tile, k * seg, min(m["counts"][tile], (k + 1) * seg),
                          c[0].copy(), prefix, c[5] != 0))
    for tile, first, end, trans, prefix, done in walks:
        for q in range(m["starts"][tile] + first, m["starts"][tile] + end):
            if done.all():
                break
            gi = m["gauss_id"][q]
            dx, dy, (ca, cb, cc), g, alpha, passing = _pair_alpha(m, gi, tile)
            passing &= ~done
            test_t = trans * (f32(1.0) - alpha)
            done = done | (passing & (test_t < f32(1e-4)))
            kept = passing & (test_t >= f32(1e-4))
            w = alpha * trans
            rgb = m["rgb"][gi]
            cdot = (rgb[0] * ct[tile, :, 0] + rgb[1] * ct[tile, :, 1]
                    + rgb[2] * ct[tile, :, 2]
                    + m["inv_depth"][gi] * ct_d[tile])
            prefix = np.where(kept, prefix + w * cdot, prefix)
            inv_one_m = f32(1.0) / (f32(1.0) - alpha)
            dl_dalpha = (cdot * trans - (ctot_dot[tile] - prefix) * inv_one_m
                         - (ft[tile] * inv_one_m) * bg_dot[tile])
            dl_dg = m["op"][gi] * dl_dalpha
            gdx, gdy = g * dx, g * dy
            v = np.stack([
                dl_dg * (-gdx * ca - gdy * cb), dl_dg * (-gdy * cc - gdx * cb),
                f32(-0.5) * gdx * dx * dl_dg, f32(-0.5) * gdx * dy * dl_dg,
                f32(-0.5) * gdy * dy * dl_dg, g * dl_dalpha,
                w * ct[tile, :, 0], w * ct[tile, :, 1], w * ct[tile, :, 2],
                w * ct_d[tile]], -1)
            rows[q] = np.sum(np.where(kept[:, None], v, f32(0.0)), 0,
                             dtype=f32)
            trans = np.where(kept, test_t, trans)
    return torch.from_numpy(rows)


@pytest.mark.parametrize("seed,opac,cull,band", [
    (2, (0.2, 0.9), False, False), (1, (0.7, 1.0), False, False),
    (4, (0.2, 0.9), True, False), (2, (0.2, 0.9), False, True)])
def test_plain_backward_matches_gstpu(seed, opac, cull, band):
    settings, prep_np, pairs_np, inputs = _scene(seed, opac, cull=cull,
                                                 band=band)
    prep, pairs, ins = _torch_args(prep_np, pairs_np, inputs)
    got = TR.composite_backward(prep, pairs, settings, **ins)
    s, jprep, jpairs, jins = _jax_args(settings, prep_np, pairs_np, inputs)
    want = R.composite_backward(jprep, jpairs, s, **jins)
    assert float(np.abs(np.asarray(want[3])).max()) > 0
    _assert_grads_close([x.numpy() for x in got], want, 1e-5)


def test_plain_backward_matches_stored_gate():
    settings, prep_np, pairs_np, inputs, g = _gate()
    prep, pairs, ins = _torch_args(prep_np, pairs_np, inputs)
    got = TR.composite_backward(prep, pairs, settings, **ins)
    _assert_grads_close([x.numpy() for x in got],
                        [g[f"g_{k}"] for k in GRAD_NAMES], 1e-5)


def test_plain_backward_matches_pallas_on_early_exit_scene():
    settings, prep_np, pairs_np, inputs = _early_exit()
    starts = pairs_np["tile_start"][pairs_np["tile_count"] > 0]
    assert (starts % 128 != 0).any()             # misaligned tile starts
    assert (inputs["final_t"] < 1e-2).any()      # saturated pixels
    prep, pairs, ins = _torch_args(prep_np, pairs_np, inputs)
    got = TR.composite_backward(prep, pairs, settings, **ins)
    s, jprep, jpairs, jins = _jax_args(settings, prep_np, pairs_np, inputs)
    want = pallas_rasterize.composite_backward(jprep, jpairs, s,
                                               interpret=True, **jins)
    _assert_grads_close([x.numpy() for x in got], want, 1e-5)


# The segment of the models' checkpoints per case: several segments in
# the deepest tiles (the kernels take multiples of 256; the models any).
MODEL_SEGMENTS = {"gate": 512, "early_exit": 32, "cull": 16, "band": 16}
SEGMENT_TOL = 5e-6


def _model_case(case):
    """(settings, prep, pairs, inputs as torch, gstpu's gradients)."""
    if case == "gate":
        settings, prep_np, pairs_np, inputs, g = _gate()
        want = [g[f"g_{k}"] for k in GRAD_NAMES]
    else:
        settings, prep_np, pairs_np, inputs = (
            _early_exit() if case == "early_exit"
            else _scene(4, (0.2, 0.9), cull=case == "cull",
                        band=case == "band"))
        s, jprep, jpairs, jins = _jax_args(settings, prep_np, pairs_np,
                                           inputs)
        want = R.composite_backward(jprep, jpairs, s, **jins)
    return (settings, *_torch_args(prep_np, pairs_np, inputs), want)


@pytest.mark.parametrize("case", ["gate", "early_exit", "cull", "band"])
def test_kernel_model_through_epilogue_matches_gstpu(case):
    settings, prep, pairs, ins, want = _model_case(case)
    rows = sequential_rows(prep, pairs, settings, **ins)
    got = TR.segment_sum_pair_rows(rows, pairs, settings)
    _assert_grads_close([x.numpy() for x in got], want, 1e-4)


@pytest.mark.parametrize("case", ["gate", "early_exit", "cull", "band"])
def test_segmented_kernel_model_matches_unsegmented(case):
    settings, prep, pairs, ins, want = _model_case(case)
    row0 = ins.get("row0", 0)
    seg = MODEL_SEGMENTS[case]
    ckpt = forward_checkpoints(prep, pairs, settings, seg, row0=row0)
    # more work items than occupied tiles: some tile is split
    n_items = int(ckpt.work.ends[-1])
    assert n_items > int((pairs.tile_count > 0).sum())
    assert not torch.isnan(ckpt.state[:n_items]).any()
    rows = sequential_rows(prep, pairs, settings, **ins, checkpoints=ckpt)
    whole = sequential_rows(prep, pairs, settings, **ins)
    scale = whole.abs().amax(dim=0)
    assert bool((scale > 0).all())
    np.testing.assert_array_less((rows - whole).abs().amax(dim=0).numpy(),
                                 SEGMENT_TOL * scale.numpy())
    got = TR.segment_sum_pair_rows(rows, pairs, settings)
    _assert_grads_close([x.numpy() for x in got], want, 1e-4)


@pytest.mark.parametrize("case", ["gate", "early_exit"])
def test_forward_checkpoints_equal_the_forward_on_cut_counts(case):
    """Checkpoint k of every tile with a k-th segment equals the plain
    forward's final T, color and inverse depth with the tile's count cut to
    k * segment (within the gate's 1e-5: the plain forward takes T as a
    cumulative product)."""
    settings, prep, pairs, ins, _ = _model_case(case)
    seg = MODEL_SEGMENTS[case]
    ckpt = forward_checkpoints(prep, pairs, settings, seg)
    n = int(ckpt.work.ends[-1])
    items = ckpt.work.items[:n].long()
    for k in range(1, int(items[:, 1].max()) + 1):
        cut = torch.clamp(pairs.tile_count, max=k * seg)
        color, dacc, final_t, _ = TR.composite_forward(
            prep, pairs._replace(tile_count=cut), settings)
        at_k = items[:, 1] == k
        tiles = items[at_k, 0]
        state = ckpt.state[:n][at_k]                     # (tiles, 6, 256)
        np.testing.assert_allclose(state[:, 0].numpy(),
                                   final_t[tiles].numpy(), atol=1e-5)
        np.testing.assert_allclose(state[:, 1:4].numpy(),
                                   color[tiles].transpose(1, 2).numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(state[:, 4].numpy(), dacc[tiles].numpy(),
                                   atol=1e-4)


@pytest.mark.parametrize("cull", [False, True])
def test_epilogue_matches_index_add_of_rows(cull):
    settings, prep_np, pairs_np, _ = _scene(4, (0.2, 0.9), cull=cull)
    pairs = convert.pairs_from_numpy(pairs_np, "cpu", prefix="")
    k2 = pairs.gauss_id.shape[0]
    n = pairs.gauss_cum.shape[0]
    rng = np.random.default_rng(0)
    rows = torch.tensor(rng.normal(size=(k2 + 1, 10)).astype(np.float32))
    rows[:k2][pairs.tile_id >= settings.band_tiles] = 0.0  # slots of no tile
    rows[k2] = 0.0
    if cull:
        assert int(pairs.num_pairs) > k2 >= int(pairs.num_kept)
    want = torch.zeros((n, 10), dtype=torch.float64)
    want.index_add_(0, pairs.gauss_id.long(), rows[:k2].double())
    got = TR.segment_sum_pair_rows(rows, pairs, settings)
    np.testing.assert_allclose(got[0].numpy(), want[:, 6:9].numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(
        got[1].numpy(),
        (want[:, 0:2] * torch.tensor([32.0, 32.0], dtype=torch.float64))
        .numpy(), atol=1e-3)
    np.testing.assert_allclose(got[2].numpy(), want[:, 2:5].numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(got[3].numpy(), want[:, 5].numpy(), atol=1e-5)
    np.testing.assert_allclose(got[4].numpy(), want[:, 9].numpy(), atol=1e-5)


def test_backward_wrapper_runs_plain_version_on_cpu():
    settings, prep_np, pairs_np, inputs = _scene(2, (0.2, 0.9))
    prep, pairs, ins = _torch_args(prep_np, pairs_np, inputs)
    before = dict(tracing.COUNTERS)
    got = cuda_rasterize.composite_backward(prep, pairs, settings, **ins)
    want = TR.composite_backward(prep, pairs, settings, **ins)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tracing.COUNTERS == before
    with pytest.raises(ValueError, match="no compositing kernel"):
        cuda_rasterize.backward_rows(prep, pairs, settings, **ins)
    with pytest.raises(ValueError, match="no checkpoints"):
        cuda_rasterize.composite_backward(
            prep, pairs, settings, **ins,
            checkpoints=forward_checkpoints(prep, pairs, settings, 16))


def test_render_on_the_cpu_passes_no_checkpoints(monkeypatch):
    """The differentiable render through the kernel wrappers on CPU
    tensors: K1's wrapper returns no checkpoints, K2's gets none, and the
    gradients equal gstpu's (the scene of test_torch_grad's
    test_render_grads_match_gstpu_vjp)."""
    calls = []
    fwd, bwd = (cuda_rasterize.composite_forward_checkpointed,
                cuda_rasterize.composite_backward)

    def spy_fwd(*a, **k):
        out = fwd(*a, **k)
        calls.append(("fwd", out[4]))
        return out

    def spy_bwd(*a, **k):
        calls.append(("bwd", k.get("checkpoints", "none passed")))
        return bwd(*a, **k)

    monkeypatch.setattr(cuda_rasterize, "composite_forward_checkpointed",
                        spy_fwd)
    monkeypatch.setattr(cuda_rasterize, "composite_backward", spy_bwd)
    rng = np.random.default_rng(3)
    size = 48
    cam = scenes.example_camera(width=size, height=size)
    primals = scenes.random_scene(rng, n=40)
    ct = rng.normal(0, 1, (size, size, 3)).astype(np.float32)
    ct_d = rng.normal(0, 1, (size, size)).astype(np.float32)
    bg = np.asarray([0.2, 0.1, 0.4], np.float32)
    pts, shs, scales, rotations, opacities = primals
    primals = (pts, scales, rotations, opacities, shs)
    camera = (cam["view"], cam["proj"], cam["campos"], bg)
    kw = dict(width=size, height=size, pair_capacity=1 << 12)

    def f(*p):
        img, depth, _ = jax_render(JaxSettings(**kw), cam["tan_fovx"],
                                   cam["tan_fovy"], 1.0, *p,
                                   *map(jnp.asarray, camera), None,
                                   jnp.int32(0))
        return img, depth

    _, vjp = jax.vjp(jax.jit(f), *map(jnp.asarray, primals))
    want = vjp((jnp.asarray(ct), jnp.asarray(ct_d)))
    tp = [torch.tensor(x, requires_grad=True) for x in primals]
    img, depth, _ = TR.render(RenderSettings(**kw), cam["tan_fovx"],
                              cam["tan_fovy"], 1.0, *tp,
                              *(torch.tensor(x) for x in camera))
    got = torch.autograd.grad((img * torch.tensor(ct)).sum()
                              + (depth * torch.tensor(ct_d)).sum(), tp)
    assert calls == [("fwd", None), ("bwd", "none passed")]
    for a, b in zip(got, want):
        b = np.asarray(b, np.float64)
        scale = max(float(np.abs(b).max()), 1e-8)
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=1e-4)


@pytest.mark.parametrize("parity", [True, False])
def test_a_culled_gaussian_in_the_cameras_plane_gets_no_gradient(parity):
    """A Gaussian two units beside the camera in its plane (view-space
    depth about 2e-7) is culled, and the loss does not depend on it.  Its
    projection terms overflow there; the adjoint chain drops them, as
    ``gsbench/reference/splat.py::preprocess_grads`` does, rather than
    multiplying them by nought: its position, scale and rotation gradients
    are finite and zero, and the others' are those of the same scene with
    it culled behind the camera."""
    rng = np.random.default_rng(5)
    size = 32
    cam = scenes.example_camera(width=size, height=size)
    pts, shs, scales, rotations, opacities = scenes.random_scene(rng, n=12)
    target = torch.tensor(rng.uniform(0, 1, (size, size, 3)),
                          dtype=torch.float32)
    view = torch.tensor(cam["view"])
    inv = torch.linalg.inv(view.double())
    settings = RenderSettings(width=size, height=size, pair_capacity=1 << 12,
                              parity=parity)

    def grads_with_first_at(view_point):
        p = pts.copy()
        p[0] = (torch.tensor(view_point + [1.0], dtype=torch.float64)
                @ inv)[:3].float().numpy()
        tp = [torch.tensor(x, requires_grad=True)
              for x in (p, scales, rotations, opacities, shs)]
        img, _, aux = TR.render(settings, cam["tan_fovx"], cam["tan_fovy"],
                                1.0, *tp, view, torch.tensor(cam["proj"]),
                                torch.tensor(cam["campos"]), torch.zeros(3))
        assert int(aux.radii[0]) == 0
        loss = (img - target).abs().mean()
        return loss.item(), torch.autograd.grad(loss, tp), p[0]

    loss_behind, behind, _ = grads_with_first_at([0.0, 0.0, -1.0])
    loss, in_plane, first = grads_with_first_at([2.0, 0.0, 0.0])
    depth = float(torch.tensor(list(first) + [1.0]) @ view[:, 2])
    assert abs(depth) < 1e-6
    assert loss == loss_behind
    for name, g, b in zip(("positions", "scales", "rotations", "opacities",
                           "shs"), in_plane, behind):
        assert torch.isfinite(g).all(), name
        assert float(g[0].abs().max()) == 0.0, name
        assert torch.equal(g[1:], b[1:]), name
