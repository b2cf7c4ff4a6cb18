"""Kernels K1 (``gstpu_torch/csrc/rasterize_fwd.cu``), K2
(``gstpu_torch/csrc/rasterize_bwd.cu``) and K3
(``gstpu_torch/csrc/sol_compositing.cu``) on a CUDA card against their
plain PyTorch versions, with the thresholds of ``chip_smoke``: K1 by
``chip_smoke.compare``; K2 plus its epilogue within 1e-3 of each output's
largest magnitude (the compiled gate's) of the stored JAX gradients, and
flip-tolerant against the plain version on the card; K1's checkpoints
(outputs bit-identical with and without them, each checkpoint bit-equal to
K1 on cut tile counts) and K2 from them (``chip_smoke.k2_segmented_checks``:
against K2 from T = 1 within ``K2_SEGMENT_ROW_TOL`` of each field's largest
magnitude, two runs bit-identical, flip-tolerant against the plain version),
on the gate and on a row band; K1 with checkpoints and K2 from them on the
round-robin bands of the sharded path (tile rows 1::2, 1::4 and 3::4) against
the plain versions; the wrappers' checks of work lists and
checkpoint buffers; K3 within
``chip_smoke.K3_FWD_TOL`` (forward, absolute) and ``K3_BWD_REL_TOL``
(backward, over each row's largest magnitude), every tile bit-identical,
and no launch for 0 tiles; the binning kernels (``csrc/binning.cu``)
against the plain ``binning.build_pairs`` on the card, every ``Pairs``
field bit for bit, on the gate (cull off, where they are also the stored
JAX pairs, and on, a kept capacity, a round-robin band), an overflow, equal depths, tiles with no pair and 3M
seeded Gaussians in 32M slots, and the wrapper's checks; the preprocess
kernel (``csrc/preprocess.cu``) against the plain ``preprocess`` on the
card, every ``PreprocessOut`` field bit for bit (a NaN matches any NaN) and
the same bits on a second launch, on the gate (where the entry also gives
the stored JAX prep within the gate's limits), at every SH degree with and
without the tight radius, an alive mask and a scale modifier, at the edges
of ``scenes.preprocess_edge_case``, on a sharded slice (contiguous, and as
columns of the all-gather's packed buffer), at 2.96M seeded
Gaussians, the wrapper's checks, and one preprocess launch per K1 launch in
``render_gaussians``.

This file imports nothing of JAX, so it runs on a machine without it once
``tests/conftest.py`` (which imports jax) is left out:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import (GRAD_NAMES, K3_BWD_REL_TOL, K3_FWD_TOL, check_grads,
                        compare, k1_checkpoint_checks, k2_segmented_checks,
                        kernel_vs_plain)
from gstpu_torch import convert, scenes, sol_model
from gstpu_torch.config import RenderSettings
from gstpu_torch.ops import binning, cuda_binning, cuda_rasterize
from gstpu_torch.ops import cuda_preprocess, kernel_check, rasterize
from gstpu_torch.ops.binning import build_pairs
from gstpu_torch.ops.preprocess import preprocess
from gstpu_torch.utils import tracing


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1, K2 and K3 have no CPU form")
    return torch.device("cuda")


def _case(name, device):
    if name == "gate":
        g = np.load(scenes.GATE_NPZ)
        return (RenderSettings(width=160, height=160, pair_capacity=1 << 16),
                convert.prep_from_numpy(g, device),
                convert.pairs_from_numpy(g, device))
    settings, prep, pairs = scenes.span_edge_case()
    return (settings, convert.prep_from_numpy(prep, device, prefix=""),
            convert.pairs_from_numpy(pairs, device, prefix=""))


def _numpy(outs):
    return tuple(x.cpu().numpy() for x in outs)


def _gate_backward_inputs(device):
    g = np.load(scenes.GATE_NPZ)
    t = lambda k: torch.tensor(g[k], device=device)  # noqa: E731
    return g, dict(color_pre_bg=t("color"), final_t=t("final_t"),
                   dl_dpix=t("dl_dpix"),
                   bg=torch.zeros(3, dtype=torch.float32, device=device),
                   depth_acc=t("depth"), dl_ddepth=t("ct_d"))


@pytest.mark.parametrize("case", ["gate", "span_edges"])
def test_kernel_matches_plain_cuda(case):
    settings, prep, pairs = _case(case, _cuda())
    before = tracing.COUNTERS["k1.launches"]
    got = cuda_rasterize.composite_forward(prep, pairs, settings)
    torch.cuda.synchronize()
    assert tracing.COUNTERS["k1.launches"] == before + 1
    assert got[3].dtype == torch.int32
    compare(case, _numpy(got),
            _numpy(rasterize.composite_forward(prep, pairs, settings)))


def test_kernel_wrapper_rejects_bad_pairs_cuda():
    settings, prep, pairs = _case("span_edges", _cuda())
    before = dict(tracing.COUNTERS)
    with pytest.raises(TypeError, match="tile_start"):
        cuda_rasterize.composite_forward(
            prep, pairs._replace(tile_start=pairs.tile_start.long()), settings)
    with pytest.raises(ValueError, match="tile_count"):
        cuda_rasterize.composite_forward(
            prep, pairs._replace(tile_count=pairs.tile_count[:-1]), settings)
    assert tracing.COUNTERS == before


def test_backward_kernel_matches_gate_and_plain_cuda():
    settings, prep, pairs = _case("gate", _cuda())
    g, inputs = _gate_backward_inputs(prep.xy.device)
    before = tracing.COUNTERS["k2.launches"]
    got = cuda_rasterize.composite_backward(prep, pairs, settings, **inputs)
    torch.cuda.synchronize()
    assert tracing.COUNTERS["k2.launches"] == before + 1
    check_grads("gate", got, tuple(g[f"g_{k}"] for k in GRAD_NAMES),
                flip_tolerant=False)
    check_grads("gate vs plain", got, rasterize.composite_backward(
        prep, pairs, settings, **inputs), flip_tolerant=True)


def test_backward_kernel_rows_are_deterministic_and_zero_past_the_tiles_cuda():
    settings, prep, pairs = _case("gate", _cuda())
    _, inputs = _gate_backward_inputs(prep.xy.device)
    a = cuda_rasterize.backward_rows(prep, pairs, settings, **inputs)
    b = cuda_rasterize.backward_rows(prep, pairs, settings, **inputs)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    in_tiles = int(pairs.tile_count.sum())
    assert not a[in_tiles:].any()                   # slots of no tile, last row
    assert a[:in_tiles].abs().sum() > 0


def test_backward_kernel_wrapper_rejects_bad_inputs_cuda():
    settings, prep, pairs = _case("gate", _cuda())
    _, inputs = _gate_backward_inputs(prep.xy.device)
    before = dict(tracing.COUNTERS)
    with pytest.raises(ValueError, match="dl_dpix"):
        cuda_rasterize.backward_rows(prep, pairs, settings, **{
            **inputs, "dl_dpix": inputs["dl_dpix"][:-1]})
    with pytest.raises(TypeError, match="final_t"):
        cuda_rasterize.backward_rows(prep, pairs, settings, **{
            **inputs, "final_t": inputs["final_t"].double()})
    assert tracing.COUNTERS == before


def test_backward_kernel_on_a_row_band_matches_plain_cuda():
    """Tile rows 1 and 3 of a 64x64 scene (row0 1, row stride 2)."""
    device = _cuda()
    rng = np.random.default_rng(2)
    cam = scenes.example_camera(width=64, height=64)
    params = scenes.random_scene(rng, n=80)
    settings = RenderSettings(width=64, height=64, pair_capacity=1 << 13,
                              tile_rows=2, row_stride=2)
    pts, shs, scales, rotations, opacities = (
        torch.tensor(x, device=device) for x in params)
    prep = preprocess(pts, scales, rotations, opacities, shs,
                      *(torch.tensor(cam[k], device=device)
                        for k in ("view", "proj", "campos")), 64, 64,
                      cam["tan_fovx"], cam["tan_fovy"], settings.grid_x,
                      settings.grid_y, 3)
    rect, tiles = rasterize.clip_rect_to_band(prep.rect, prep.tiles_touched,
                                              1, settings.band_rows, 2)
    pairs = build_pairs(tiles, rect, prep.depth, settings.grid_x,
                        settings.band_tiles, settings.pair_capacity, row0=1,
                        row_stride=2)
    color, dacc, final_t, _ = cuda_rasterize.composite_forward(
        prep, pairs, settings, row0=1)
    t = settings.band_tiles
    inputs = dict(color_pre_bg=color, final_t=final_t, depth_acc=dacc,
                  dl_dpix=torch.tensor(rng.normal(size=(t, 256, 3)),
                                       dtype=torch.float32, device=device),
                  dl_ddepth=torch.tensor(rng.normal(size=(t, 256)),
                                         dtype=torch.float32, device=device),
                  bg=torch.tensor([0.2, 0.1, 0.4], device=device))
    got = cuda_rasterize.composite_backward(prep, pairs, settings, row0=1,
                                            **inputs)
    want = rasterize.composite_backward(prep, pairs, settings, row0=1,
                                        **inputs)
    assert float(want[3].abs().max()) > 0
    check_grads("row band", got, want, flip_tolerant=True)


def _gate_band(device, row0=1, stride=2):
    """The gate's Gaussians binned to the round-robin band of tile rows
    ``row0 + k * stride`` (default 1, 3, 5, 7, 9; as the sharded path bands
    the 10 rows, with rows past the grid empty), its K1 outputs and seeded
    cotangents."""
    g = np.load(scenes.GATE_NPZ)
    settings = RenderSettings(width=160, height=160, pair_capacity=1 << 16,
                              tile_rows=-(-10 // stride), row_stride=stride)
    prep = convert.prep_from_numpy(g, device)
    rect, tiles = rasterize.clip_rect_to_band(prep.rect, prep.tiles_touched,
                                              row0, settings.band_rows,
                                              stride)
    pairs = build_pairs(tiles, rect, prep.depth, settings.grid_x,
                        settings.band_tiles, settings.pair_capacity,
                        row0=row0, row_stride=stride)
    color, dacc, final_t, _ = cuda_rasterize.composite_forward(
        prep, pairs, settings, row0=row0)
    rng = np.random.default_rng(5)
    t = settings.band_tiles
    inputs = dict(color_pre_bg=color, final_t=final_t, depth_acc=dacc,
                  dl_dpix=torch.tensor(rng.normal(size=(t, 256, 3)),
                                       dtype=torch.float32, device=device),
                  dl_ddepth=torch.tensor(rng.normal(size=(t, 256)),
                                         dtype=torch.float32, device=device),
                  bg=torch.tensor([0.2, 0.1, 0.4], device=device), row0=row0)
    return settings, prep, pairs, inputs


def test_forward_kernel_checkpoints_cuda():
    settings, prep, pairs = _case("gate", _cuda())
    before = dict(tracing.COUNTERS)
    res = k1_checkpoint_checks("gate", prep, pairs, settings)
    assert res["ok"] and res["checkpoints_compared"] > 0
    launched = tracing.COUNTERS["k1.ctas"] - before["k1.ctas"]
    # each launch (two, and one per checkpoint compared) reports its grid:
    # one CTA per 64-pixel strip of every tile
    assert launched > 0
    assert launched % (settings.band_tiles * 256 // 64) == 0


@pytest.mark.parametrize("case", ["gate", "band"])
def test_segmented_backward_kernel_matches_whole_tiles_and_plain_cuda(case):
    device = _cuda()
    if case == "gate":
        settings, prep, pairs = _case("gate", device)
        inputs = _gate_backward_inputs(device)[1]
    else:
        settings, prep, pairs, inputs = _gate_band(device)
    assert int(pairs.tile_count.max()) > cuda_rasterize.SEGMENT
    before = tracing.COUNTERS["k2.launches"]
    ctas = tracing.COUNTERS["k2.ctas"]
    k2_segmented_checks(case, prep, pairs, settings, inputs)
    torch.cuda.synchronize()
    assert tracing.COUNTERS["k2.launches"] == before + 3
    # two launches over the work list's bound of items, one from T = 1 over
    # the tiles
    bound = cuda_rasterize.work_capacity(settings.band_tiles,
                                         pairs.gauss_id.shape[0],
                                         cuda_rasterize.SEGMENT)
    assert (tracing.COUNTERS["k2.ctas"] - ctas
            == 2 * bound + settings.band_tiles)
    *_, ckpt = cuda_rasterize.composite_forward_checkpointed(
        prep, pairs, settings, row0=inputs.get("row0", 0))
    n = int(ckpt.work.ends[-1])
    assert n > int((pairs.tile_count > 0).sum())      # a tile is split
    assert torch.equal(ckpt.work.items[:n], cuda_rasterize.work_items(
        ckpt.work, pairs.tile_count)[:n])


@pytest.mark.parametrize("row0,stride", [(1, 2), (1, 4), (3, 4)])
def test_checkpointed_kernels_on_a_round_robin_band_cuda(row0, stride):
    """The sharded path's shapes: K1 with checkpoints and K2 from them on a
    band of tile rows ``row0 + k * stride``, against their plain versions
    (``chip_smoke.kernel_vs_plain``, ``k1_checkpoint_checks``,
    ``k2_segmented_checks``)."""
    settings, prep, pairs, inputs = _gate_band(_cuda(), row0, stride)
    assert int(pairs.tile_count.max()) > cuda_rasterize.SEGMENT
    kernel_vs_plain(f"band {row0}::{stride}", prep, pairs, settings, row0)
    res = k1_checkpoint_checks(f"band {row0}::{stride}", prep, pairs,
                               settings, row0)
    assert res["ok"] and res["checkpoints_compared"] > 0
    k2_segmented_checks(f"band {row0}::{stride}", prep, pairs, settings,
                        inputs)


def test_backward_kernel_wrapper_rejects_bad_checkpoints_cuda():
    settings, prep, pairs = _case("gate", _cuda())
    _, inputs = _gate_backward_inputs(prep.xy.device)
    *_, ckpt = cuda_rasterize.composite_forward_checkpointed(prep, pairs,
                                                             settings)
    work = ckpt.work
    before = dict(tracing.COUNTERS)
    for bad in (ckpt._replace(state=ckpt.state[:, :5]),
                ckpt._replace(state=ckpt.state.double()),
                ckpt._replace(state=ckpt.state.cpu()),
                ckpt._replace(work=work._replace(items=work.items[:-1])),
                ckpt._replace(work=work._replace(ends=work.ends.long())),
                ckpt._replace(work=work._replace(order=work.order[1:])),
                ckpt._replace(work=work._replace(segment=100))):
        with pytest.raises(ValueError):
            cuda_rasterize.backward_rows(prep, pairs, settings, **inputs,
                                         checkpoints=bad)
    assert tracing.COUNTERS == before


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("n_chunks", [1, 2, 5])
def test_k3_matches_plain_cuda(n_chunks, backward):
    feat = sol_model.feature_block(_cuda())
    form = "sol_compositing_bwd" if backward else "sol_compositing_fwd"
    before = sol_model.LAUNCHES[form]
    got = sol_model.sol_compositing(feat, n_chunks, 37, backward)
    torch.cuda.synchronize()
    assert sol_model.LAUNCHES[form] == before + 1
    bits = got.view(torch.int32)
    assert bool((bits == bits[:1]).all())
    want = sol_model.sol_compositing_plain(feat, n_chunks, 37, backward)
    diff = (got.double() - want.double()).abs()
    if backward:
        scale = want.double().abs().amax(dim=(0, 2))
        assert bool((diff.amax(dim=(0, 2)) / scale < K3_BWD_REL_TOL).all())
    else:
        assert float(diff.max()) < K3_FWD_TOL


@pytest.mark.parametrize("backward", [False, True])
def test_k3_launches_nothing_for_no_tiles_cuda(backward):
    feat = sol_model.feature_block(_cuda())
    before = dict(sol_model.LAUNCHES), dict(sol_model.CTAS)
    got = sol_model.sol_compositing(feat, 2, 0, backward)
    torch.cuda.synchronize()
    assert got.shape == (0, 2, 128 if backward else 256)
    assert got.is_cuda
    assert (sol_model.LAUNCHES, sol_model.CTAS) == before


def test_k3_wrapper_rejects_bad_blocks_cuda():
    feat = sol_model.feature_block(_cuda())
    before = dict(sol_model.LAUNCHES)
    with pytest.raises(TypeError, match="float32"):
        sol_model.sol_compositing(feat.double(), 2, 4, False)
    with pytest.raises(ValueError, match="block"):
        sol_model.sol_compositing(feat[:, :8], 2, 4, True)
    for n_chunks, tiles in ((2, -1), (-1, 4)):
        with pytest.raises(ValueError, match=">= 0"):
            sol_model.sol_compositing(feat, n_chunks, tiles, False)
    assert sol_model.LAUNCHES == before


# --- binning: csrc/binning.cu against the plain binning.build_pairs ---

def _binning_gate(device, case):
    """The gate's prep binned as ``_render_fwd`` bins it: (args, kwargs)
    of ``build_pairs`` for the whole grid or the band of rows 1, 3, ..., 9,
    with the pair cull on unless ``case`` is "cull_off"."""
    g = np.load(scenes.GATE_NPZ)
    prep = convert.prep_from_numpy(g, device)
    row0, stride, rows = (1, 2, 5) if case == "band" else (0, 1, 10)
    rect, tiles = rasterize.clip_rect_to_band(prep.rect, prep.tiles_touched,
                                              row0, rows, stride)
    kw = dict(row0=row0, row_stride=stride)
    if case != "cull_off":
        kw.update(cull_xy=prep.xy,
                  cull_tcut=rasterize.pair_cull_threshold(prep))
    return (tiles, rect, prep.depth, 10, 10 * rows, 1 << 16), kw


def _shifted_inputs(device, seed=7):
    """Seeded Gaussians on tiles 3-8 of 12 columns and rows 2-6 of 10, so
    the first and last tiles and whole rows and columns get no pair."""
    inp = chip_smoke.binning_inputs(seed, 5000, 6, 5, "cpu")
    rect = inp["rect"].clone()
    seen = inp["tiles_touched"] > 0
    rect[seen] += torch.tensor([3, 2, 3, 2], dtype=torch.int32)
    inp["rect"] = rect
    inp["cull_xy"] += torch.tensor([48.0, 32.0]) * seen[:, None]
    return {k: v.to(device) for k, v in inp.items()}


def _kernels_match_plain(args, **kw):
    """The kernels' ``Pairs`` (one counted launch) equal to the plain
    version's on the card in every field; returns them."""
    before = tracing.COUNTERS["binning.launches"]
    got = cuda_binning.build_pairs(*args, **kw)
    torch.cuda.synchronize()
    assert tracing.COUNTERS["binning.launches"] == before + 1
    assert chip_smoke.pairs_equal(got, binning.build_pairs(*args, **kw)) == []
    return got


@pytest.mark.parametrize("case", ["cull_off", "cull_on", "kept_capacity",
                                  "band"])
def test_binning_kernels_match_plain_on_the_gate_cuda(case):
    args, kw = _binning_gate(_cuda(), case)
    if case == "kept_capacity":
        kept = int(binning.build_pairs(*args, **kw).num_kept)
        kw["kept_capacity"] = -(-int(kept * 1.05) // 1024) * 1024
    got = _kernels_match_plain(args, **kw)
    if case == "cull_off":
        # the whole grid at the stored capacity: JAX's pairs, bit for bit
        stored = convert.pairs_from_numpy(np.load(scenes.GATE_NPZ), _cuda())
        assert chip_smoke.pairs_equal(got, stored) == []
    else:
        assert int(got.num_kept) < int(got.num_pairs)
    if case == "kept_capacity":
        assert got.gauss_id.shape == (kw["kept_capacity"],)


@pytest.mark.parametrize("cull", [False, True])
def test_binning_kernels_match_plain_on_an_overflow_cuda(cull):
    args, kw = _binning_gate(_cuda(), "cull_on" if cull else "cull_off")
    args = args[:5] + (4096,)
    got = _kernels_match_plain(args, **kw)
    assert int(got.num_pairs) > 4096
    assert int(got.tile_count.sum()) == (int(got.num_kept) if cull else 4096)


def test_binning_kernels_keep_the_order_of_equal_depths_cuda():
    inp = chip_smoke.binning_inputs(11, 20000, 8, 6, _cuda(), tied=1.0)
    args = (inp["tiles_touched"], inp["rect"], inp["depth"], 8, 48, 1 << 18)
    got = _kernels_match_plain(args)
    kept = got.tile_id < 48
    ties = (got.tile_id[1:] == got.tile_id[:-1]) & kept[1:] & (
        inp["depth"][got.gauss_id[1:].long()]
        == inp["depth"][got.gauss_id[:-1].long()])
    assert int(ties.sum()) > 10000
    # within a tile, equal depths stay in Gaussian order
    assert bool((got.gauss_id[1:][ties] > got.gauss_id[:-1][ties]).all())


@pytest.mark.parametrize("kept_capacity", [None, 0, 4096])
def test_binning_kernels_on_tiles_with_no_pair_cuda(kept_capacity):
    inp = _shifted_inputs(_cuda())
    args = (inp["tiles_touched"], inp["rect"], inp["depth"], 12, 120,
            1 << 16)
    got = _kernels_match_plain(args, cull_xy=inp["cull_xy"],
                               cull_tcut=inp["cull_tcut"],
                               kept_capacity=kept_capacity)
    if kept_capacity != 0:
        empty = got.tile_count == 0
        assert bool(empty[0]) and bool(empty[-1]) and int(empty.sum()) >= 70


@pytest.mark.parametrize("cull", [False, True])
def test_binning_kernels_match_plain_at_3m_gaussians_cuda(cull):
    """About 3M seeded Gaussians on mip360-view's 78 x 52 tiles in 32M
    slots (7.3 pairs a visible Gaussian, two thirds of the slots filled);
    two launches give the same bits."""
    dev = _cuda()
    inp = chip_smoke.binning_inputs(3, 3_000_000, 78, 52, dev)
    args = (inp["tiles_touched"], inp["rect"], inp["depth"], 78, 4056,
            32 << 20)
    kw = {}
    if cull:
        kw = dict(cull_xy=inp["cull_xy"], cull_tcut=inp["cull_tcut"],
                  kept_capacity=30 << 20)
    got = _kernels_match_plain(args, **kw)
    assert 19e6 < int(got.num_pairs) < 32 << 20
    if cull:
        assert int(got.num_kept) < int(got.num_pairs)
    assert chip_smoke.pairs_equal(cuda_binning.build_pairs(*args, **kw),
                                  got) == []


def test_binning_wrapper_rejects_bad_inputs_cuda():
    args, kw = _binning_gate(_cuda(), "cull_on")
    tiles, rect, depth = args[:3]
    before = dict(tracing.COUNTERS)
    with pytest.raises(TypeError, match="tiles_touched"):
        cuda_binning.build_pairs(tiles.long(), *args[1:], **kw)
    with pytest.raises(ValueError, match="depth"):
        cuda_binning.build_pairs(tiles, rect, depth.cpu(), *args[3:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_binning.build_pairs(tiles, rect.t().contiguous().t(), depth,
                                 *args[3:], **kw)
    with pytest.raises(ValueError, match="cull_tcut"):
        cuda_binning.build_pairs(*args, cull_xy=kw["cull_xy"],
                                 cull_tcut=kw["cull_tcut"][:-1])
    assert tracing.COUNTERS == before


# --- preprocess: csrc/preprocess.cu against the plain preprocess ---

def _prep_matches_plain(args, **kw):
    """The kernel's ``PreprocessOut`` (one counted launch) equal to the
    plain version's on the card in every field, bit for bit (a NaN matches
    any NaN), and a second launch giving the same bits; returns it."""
    before = tracing.COUNTERS["preprocess.launches"]
    got = cuda_preprocess.preprocess(*args, **kw)
    torch.cuda.synchronize()
    assert tracing.COUNTERS["preprocess.launches"] == before + 1
    diff = chip_smoke.prep_diff(got, preprocess(*args, **kw))
    assert chip_smoke.differing(diff) == [], diff
    assert chip_smoke.prep_equal(cuda_preprocess.preprocess(*args, **kw),
                                 got) == []
    return got


def _prep_gate(device, sh_degree=3):
    return kernel_check.gate_inputs(device)[:-1] + (sh_degree,)


def test_preprocess_kernel_matches_plain_on_the_gate_cuda():
    dev = _cuda()
    _prep_matches_plain(_prep_gate(dev))
    # through the entry, as the bench's kernel gate runs it: the stored JAX
    # prep within the gate's limits
    res = kernel_check.preprocess_backend_parity(device=dev)
    assert res["ok"], res


@pytest.mark.parametrize("form", ["plain", "tight_alive_scaled"])
@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_preprocess_kernel_matches_plain_at_every_sh_degree_cuda(sh_degree,
                                                                 form):
    dev = _cuda()
    kw = {}
    if form == "tight_alive_scaled":
        alive = np.random.default_rng(5).uniform(size=kernel_check.N) < 0.7
        kw = dict(tight_radius=True, scale_modifier=0.7,
                  alive=torch.as_tensor(alive, device=dev))
    got = _prep_matches_plain(_prep_gate(dev, sh_degree), **kw)
    assert 1000 < int(got.visible.sum())
    if kw:
        assert not bool(got.visible[~kw["alive"]].any())


def test_preprocess_kernel_matches_plain_at_the_edges_cuda():
    """Depth 0, just behind and on the near plane, det 0, off the grid,
    saturated rects, a negative colour (``scenes.preprocess_edge_case``;
    the CPU tests check that each edge is hit)."""
    dev = _cuda()
    arrays, cam = scenes.preprocess_edge_case()
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    args = tuple(t(arrays[k]) for k in ("means", "scales", "rotations",
                                        "opacities", "shs")) + (
        t(cam["view"]), t(cam["proj"]), t(cam["campos"]), cam["width"],
        cam["height"], cam["tan_fovx"], cam["tan_fovy"], 10, 10, 3)
    got = _prep_matches_plain(args)
    e = scenes.PREP_EDGES
    assert bool(torch.isnan(got.conic[e["depth_zero"]]).all())
    assert int(got.radii[e["saturated_rect_inf"]]) == 2**30


@pytest.mark.parametrize("gathered", [False, True])
def test_preprocess_kernel_matches_plain_on_a_sharded_slice_cuda(gathered):
    """The second half of 8,002 Gaussians, as rank 1 of two preprocesses
    it: its means and scales start 48,012 bytes in (not 16-byte aligned);
    ``gathered``: every parameter a column of one packed buffer, as the
    sharded path's all-gather hands them (not contiguous: copied first),
    and the view matrix transposed twice (not contiguous either)."""
    from gstpu_torch.parallel import collectives

    dev = _cuda()
    rng = np.random.default_rng(3)
    cam = scenes.example_camera(width=160, height=160)
    pts, shs, scales, rotations, opacities = scenes.random_scene(
        rng, n=8002, extent=1.3, z_center=-8.0, scale_range=(0.01, 0.08))
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    full = [t(x) for x in (pts, scales, rotations, opacities, shs)]
    view = t(cam["view"])
    if gathered:
        full = collectives._unpack_floats(collectives._pack_floats(full),
                                          full)
        view = view.t().contiguous().t()
        assert not any(x.is_contiguous() for x in full[:3] + [view])
    args = tuple(x[4001:] for x in full) + (
        view, t(cam["proj"]), t(cam["campos"]), 160, 160, cam["tan_fovx"],
        cam["tan_fovy"], 10, 10, 3)
    assert args[0].data_ptr() % 16 != 0
    _prep_matches_plain(args, alive=torch.ones(4001, dtype=torch.bool,
                                               device=dev))


def test_preprocess_kernel_matches_plain_at_3m_gaussians_cuda():
    """2.96M seeded Gaussians at mip360-view's 1237 x 822 (78 x 52 tiles),
    SH degree 3, as ``chip_smoke.py``'s phase 16 times them."""
    dev = _cuda()
    args, kw = chip_smoke.preprocess_inputs(7, 2_960_000, 1237, 822, dev)
    got = _prep_matches_plain(args, **kw)
    assert 0.05 < float(got.visible.float().mean()) < 0.95


def test_preprocess_wrapper_rejects_bad_inputs_cuda():
    dev = _cuda()
    args = _prep_gate(dev)
    means, scales, rotations, opacities, shs, view, proj, campos = args[:8]
    rest = args[8:]
    n = means.shape[0]
    before = dict(tracing.COUNTERS)

    def call(*arrays, **kw):
        return cuda_preprocess.preprocess(*arrays, *rest, **kw)

    with pytest.raises(TypeError, match="means"):
        call(means.double(), *args[1:8])
    with pytest.raises(ValueError, match="campos"):
        call(*args[:7], campos.cpu())
    with pytest.raises(ValueError, match="opacities"):
        call(*args[:3], opacities[:, None], *args[4:8])
    shifted = torch.empty(4 * n + 1, device=dev)[1:].view(n, 4)
    shifted.copy_(rotations)
    with pytest.raises(ValueError, match="aligned"):
        call(*args[:2], shifted, *args[3:8])
    with pytest.raises(TypeError, match="alive"):
        call(*args[:8], alive=torch.ones(n, dtype=torch.uint8, device=dev))
    with pytest.raises(ValueError, match="sh_degree"):
        cuda_preprocess.preprocess(*args[:-1], 4)
    assert tracing.COUNTERS == before


def test_render_launches_preprocess_as_often_as_k1_cuda():
    from gstpu_torch.render import render_gaussians

    dev = _cuda()
    g = kernel_check.gate_inputs(dev)
    means, scales, rotations, opacities, shs, view, proj, campos = g[:8]
    keys = ("preprocess.launches", "k1.launches", "binning.launches")
    before = {k: tracing.COUNTERS[k] for k in keys}
    for _ in range(2):
        render_gaussians(torch.zeros(3, device=dev), means,
                         opacity=opacities, scales=scales,
                         rotations=rotations, viewmatrix=view,
                         projmatrix=proj, tan_fovx=g[10], tan_fovy=g[11],
                         image_height=160, image_width=160, sh=shs,
                         campos=campos, device=dev)
    torch.cuda.synchronize()
    got = {k: tracing.COUNTERS[k] - before[k] for k in keys}
    assert got["preprocess.launches"] == got["k1.launches"] >= 2
    assert got["binning.launches"] == got["k1.launches"]
