"""Tile-based alpha compositing and the differentiable render, on torch
tensors.

Port of ``gstpu/ops/rasterize.py``.

- ``composite_forward`` is the chunked front-to-back walk: with per-pair
  effective alphas (zero where the reference ``continue``s: ``power > 0`` or
  ``alpha < 1/255``), the running transmittance is a cumulative product, and
  the reference's break at the first would-be transmittance below 1e-4
  becomes the per-pixel ``done`` flag.
- ``composite_backward`` is its adjoint in forward order with a running
  prefix of ``w * cdot`` in place of the reference's reverse replay, and
  ``index_add_`` for the per-Gaussian sums.

Both are the plain versions of the CUDA kernels in ``ops/cuda_rasterize.py``
and are what runs for tensors on the CPU.  ``segment_sum_pair_rows`` is the
epilogue that turns the backward kernel's per-pair rows into per-Gaussian
gradients.

``render`` is the differentiable render (a ``torch.autograd.Function``):
preprocess (``ops/cuda_preprocess.py``) and binning
(``ops/cuda_binning.py``), each a kernel for CUDA tensors and the plain
version on the CPU, compositing, background and tiles back to an image,
with the hand-written backward of the JAX package's custom VJP.
``render_forward`` runs the same forward without autograd.

Sharded (``settings.shard_axis``, the name of an axis of the ``mesh`` that
the caller passes): each rank preprocesses its 1/size slice of the
Gaussians and all-gathers the ``PreprocessOut``; the backward
reduce-scatters the compositing's per-Gaussian cotangents first, runs the
adjoint chain on the slice alone and returns gradients at full size, zero
outside the slice, so that the reduce-scatter of the caller's all-gather
of the parameters hands each rank its slice complete
(``parallel/sharded.py``).  When N does not divide by the axis size, a
warning says so and every rank runs the whole chain.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gstpu_torch.config import RenderSettings, TILE_PIXELS, TILE_X, TILE_Y
from gstpu_torch.ops import cuda_binning, cuda_preprocess, preprocess_bwd
from gstpu_torch.ops.binning import Pairs
from gstpu_torch.ops.preprocess import PreprocessOut
from gstpu_torch.utils import tracing

ALPHA_MIN = 1.0 / 255.0   # forward.py:481
T_EPS = 1e-4              # forward.py:487
ALPHA_MAX = 0.99          # forward.py:478

_SLICE_FALLBACK_WARNED: set = set()


def _warn_slice_fallback(n: int, size: int, where: str) -> None:
    """Warn, once per shape, that the sliced per-Gaussian chain is off.

    The sharded path runs the preprocess and the adjoint chain on each
    rank's 1/size slice of the Gaussians; the Trainer and
    ``make_sharded_render`` round N up to a multiple of the axis size, so
    this fires only for other callers."""
    import warnings

    key = (n, size, where)
    if key not in _SLICE_FALLBACK_WARNED:
        _SLICE_FALLBACK_WARNED.add(key)
        warnings.warn(
            f"sharded render: N={n} is not a multiple of the 'model' axis "
            f"size {size}; the sliced {where} chain is DISABLED and every "
            "rank runs it over all N Gaussians. Pad the parameter capacity "
            "to a multiple of the axis size (the Trainer and "
            "make_sharded_render do this automatically).", RuntimeWarning)


def _slice_axis(settings: RenderSettings, mesh, n: int, where: str):
    """The mesh axis whose ranks each take a slice of the N Gaussians'
    preprocess and adjoint chain, or None: not sharded, Q15's translation
    bias (affine, not linear, so it stays whole), an axis of one rank, or N
    not a multiple of its size (with a warning)."""
    if settings.shard_axis is None or settings.grad_bias_parity:
        return None
    if mesh is None:
        raise ValueError(f"settings.shard_axis={settings.shard_axis!r} needs "
                         "the mesh that names it")
    axis = mesh.axis(settings.shard_axis)
    if axis.size == 1:
        return None
    if n % axis.size:
        _warn_slice_fallback(n, axis.size, where)
        return None
    return axis


class RenderAux(NamedTuple):
    radii: torch.Tensor       # (N,) int32
    num_pairs: torch.Tensor   # () int32, overflow check vs pair_capacity
    final_t: torch.Tensor     # (T, 256) f32 final transmittance per pixel
    n_contrib: torch.Tensor   # (T, 256) int32
    xy: torch.Tensor          # (N, 2) projected means
    num_kept: torch.Tensor    # () int32, post-cull check vs kept_capacity


def _tile_pixel_coords(settings: RenderSettings, row0: int = 0,
                       device=None):
    """(T_band, P) pixel-center coordinates of the rasterized tile band.

    Band tile row k maps to global tile row ``row0 + k * row_stride``.
    """
    t = torch.arange(settings.band_tiles, dtype=torch.int32, device=device)
    tx = t % settings.grid_x
    ty = (t // settings.grid_x) * settings.row_stride + row0
    p = torch.arange(TILE_PIXELS, dtype=torch.int32, device=device)
    lx = p % TILE_X
    ly = p // TILE_X
    pixf_x = (tx[:, None] * TILE_X + lx[None, :]).to(torch.float32)
    pixf_y = (ty[:, None] * TILE_Y + ly[None, :]).to(torch.float32)
    return pixf_x, pixf_y


def clip_rect_to_band(rect: torch.Tensor, tiles_touched: torch.Tensor,
                      row0: int, band_rows: int, stride: int = 1):
    """Clip per-Gaussian tile rects to the band's tile rows
    {row0 + k*stride : k in [0, band_rows)}.

    Returns (rect_local, tiles_touched_local); the local rect's y values are
    band-local k indices.  With row0=0, stride=1, band_rows=grid_y this is
    the identity.
    """
    rmin_x, rmin_y, rmax_x, rmax_y = (rect[:, i] for i in range(4))

    def cdiv(a):
        return -torch.div(-a, stride, rounding_mode="floor")

    k_lo = torch.clamp(cdiv(rmin_y - row0), 0, band_rows)
    k_hi = torch.clamp(cdiv(rmax_y - row0), 0, band_rows)
    tiles = (k_hi - k_lo) * (rmax_x - rmin_x)
    tiles = torch.where(tiles_touched > 0, tiles, 0)
    rect_local = torch.stack([rmin_x, k_lo, rmax_x, k_hi], dim=-1)
    return rect_local, tiles


def pair_cull_threshold(prep: PreprocessOut) -> torch.Tensor:
    """Per-Gaussian squared-distance threshold of the exact pair cull.

    alpha(d) <= op * exp(-0.5 * lambda_min(conic) * d^2) < 1/255  <=>
    d^2 > 2 ln(255 op) / lambda_min; the 1.0001 margin errs toward keeping.
    """
    ca, cb, cc = prep.conic[:, 0], prep.conic[:, 1], prep.conic[:, 2]
    mid = 0.5 * (ca + cc)
    det_c = ca * cc - cb * cb
    lam_min = mid - torch.sqrt(torch.clamp(mid * mid - det_c, min=0.0))
    log_term = 2.0 * torch.log(torch.clamp(255.0 * prep.opacity, min=1e-12))
    return torch.where(lam_min > 0.0, 1.0001 * log_term / lam_min,
                       torch.inf)


def _chunk_pair_data(pairs: Pairs, chunk_idx: int, chunk: int):
    """Gather one chunk of per-pair Gaussian ids for every tile at once."""
    k = pairs.gauss_id.shape[0]
    j = torch.arange(chunk, dtype=torch.int32, device=pairs.gauss_id.device)
    pos_in_tile = chunk_idx * chunk + j                          # (C,)
    pair_idx = pairs.tile_start[:, None] + pos_in_tile[None, :]
    pvalid = pos_in_tile[None, :] < pairs.tile_count[:, None]    # (T, C)
    pair_idx = torch.clamp(pair_idx, 0, k - 1)
    gid = pairs.gauss_id[pair_idx.long()].long()                 # (T, C)
    return gid, pvalid, pos_in_tile


def _chunk_alpha(prep: PreprocessOut, gid, pvalid, pixf_x, pixf_y):
    """Per-(tile, pixel, pair) alpha with the reference's individual skips.

    Returns (alpha_eff, indiv, g, dx, dy, (ca, cb, cc), op): the alpha where
    the pair passes ``power <= 0`` and ``alpha >= 1/255`` (else 0), that
    pass mask, and the Gaussian geometry the backward differentiates.
    """
    xy = prep.xy[gid]                                            # (T, C, 2)
    con = prep.conic[gid]                                        # (T, C, 3)
    op = prep.opacity[gid]                                       # (T, C)
    dx = xy[:, None, :, 0] - pixf_x[:, :, None]                  # (T, P, C)
    dy = xy[:, None, :, 1] - pixf_y[:, :, None]
    ca = con[:, None, :, 0]
    cb = con[:, None, :, 1]
    cc = con[:, None, :, 2]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    # exp in float64, rounded to float32: the float32 exp of PyTorch's CPU
    # kernels can differ in the last bit from one process to the next, and
    # the backward's 1 / (1 - alpha) terms carry such a bit past 1e-5 of
    # the gradients' scale
    g = torch.exp(torch.clamp(power, max=0.0).double()).float()
    op = op[:, None, :]
    alpha = torch.clamp(op * g, max=ALPHA_MAX)
    indiv = pvalid[:, None, :] & (power <= 0.0) & (alpha >= ALPHA_MIN)
    alpha_eff = torch.where(indiv, alpha, 0.0)
    return alpha_eff, indiv, g, dx, dy, (ca, cb, cc), op


def composite_forward(prep: PreprocessOut, pairs: Pairs,
                      settings: RenderSettings, row0: int = 0):
    """Front-to-back compositing over all tiles of the band (plain version).

    Returns per-tile-pixel buffers: color (T,P,3) before the background,
    inverse depth (T,P), final transmittance (T,P) and n_contrib (T,P) int32
    (last kept position + 1).
    """
    dev = prep.xy.device
    num_tiles = settings.band_tiles
    chunk = settings.chunk
    pixf_x, pixf_y = _tile_pixel_coords(settings, row0, dev)
    # depth >= 0.2 for every visible Gaussian; 0 only for culled ones, which
    # never appear in the pair list: guard anyway.
    inv_depth = 1.0 / torch.where(prep.depth == 0.0, 1.0, prep.depth)

    t = num_tiles
    trans = torch.ones((t, TILE_PIXELS), dtype=torch.float32, device=dev)
    done = torch.zeros((t, TILE_PIXELS), dtype=torch.bool, device=dev)
    color = torch.zeros((t, TILE_PIXELS, 3), dtype=torch.float32, device=dev)
    dacc = torch.zeros((t, TILE_PIXELS), dtype=torch.float32, device=dev)
    last = torch.zeros((t, TILE_PIXELS), dtype=torch.int32, device=dev)
    if t == 0:
        return color, dacc, trans, last
    n_chunks = int(((pairs.tile_count + chunk - 1) // chunk).max())

    i = 0
    while i < n_chunks and not bool(done.all()):
        gid, pvalid, pos_in_tile = _chunk_pair_data(pairs, i, chunk)
        alpha_eff, indiv = _chunk_alpha(prep, gid, pvalid, pixf_x,
                                        pixf_y)[:2]
        one_m = 1.0 - alpha_eff
        p_incl = trans[:, :, None] * torch.cumprod(one_m, dim=-1)  # (T,P,C)
        t_ex = p_incl / one_m                                      # 1-a >= 0.01
        kept = indiv & (p_incl >= T_EPS) & ~done[:, :, None]
        w = torch.where(kept, alpha_eff * t_ex, 0.0)

        col = prep.rgb[gid]                                        # (T,C,3)
        color = color + torch.einsum("tpc,tck->tpk", w, col)
        dacc = dacc + torch.sum(w * inv_depth[gid][:, None, :], dim=-1)

        p_kept = torch.where(kept, p_incl, torch.inf)
        p_last = torch.amin(p_kept, dim=-1)
        trans = torch.where(torch.isfinite(p_last), p_last, trans)
        # the reference BREAKS the pixel at the first passing Gaussian whose
        # would-be transmittance crosses below 1e-4 (forward.py:486-488)
        done = done | torch.any(indiv & (p_incl < T_EPS), dim=-1)

        contrib_pos = torch.where(kept, pos_in_tile[None, None, :] + 1, 0)
        last = torch.maximum(last, torch.amax(contrib_pos, dim=-1)
                             .to(torch.int32))
        i += 1
    return color, dacc, trans, last


def composite_backward(prep: PreprocessOut, pairs: Pairs,
                       settings: RenderSettings, color_pre_bg, final_t,
                       dl_dpix, bg, row0: int = 0, depth_acc=None,
                       dl_ddepth=None):
    """Adjoint of compositing in forward order (plain version).

    ``dl_dpix``: (T, P, 3) pixel-color cotangents.  Returns per-Gaussian
    gradients (dL_dcolor (N,3), dL_dmean2d_ndc (N,2), dL_dconic (N,3),
    dL_dopacity (N,), dL_dinvdepth (N,)).  ``dL_dmean2d_ndc`` carries the
    reference's ``0.5 * W`` and ``0.5 * H`` NDC scaling; the conic's b
    gradient has the reference's half convention (``cov2d_backward`` doubles
    it back).

    ``depth_acc``/``dl_ddepth`` (both (T, P)) enable the depth gradient: the
    inverse-depth image is a fourth composited channel with no background.
    """
    n = prep.xy.shape[0]
    dev = prep.xy.device
    chunk = settings.chunk
    pixf_x, pixf_y = _tile_pixel_coords(settings, row0, dev)

    with_depth = dl_ddepth is not None
    ctot_dot = torch.sum(color_pre_bg * dl_dpix, dim=-1)              # (T,P)
    if with_depth:
        ctot_dot = ctot_dot + depth_acc * dl_ddepth
    bg_dot = torch.sum(bg[None, None, :] * dl_dpix, dim=-1)           # (T,P)
    ddelx_dx = 0.5 * settings.width
    ddely_dy = 0.5 * settings.height
    inv_depth = 1.0 / torch.where(prep.depth == 0.0, 1.0, prep.depth)

    t = settings.band_tiles
    f32 = dict(dtype=torch.float32, device=dev)
    trans = torch.ones((t, TILE_PIXELS), **f32)
    done = torch.zeros((t, TILE_PIXELS), dtype=torch.bool, device=dev)
    prefix_u = torch.zeros((t, TILE_PIXELS), **f32)
    # one spare row: pairs no pixel kept are scattered there and dropped
    d_color = torch.zeros((n + 1, 3), **f32)
    d_mean2d = torch.zeros((n + 1, 2), **f32)
    d_conic = torch.zeros((n + 1, 3), **f32)
    d_opac = torch.zeros((n + 1,), **f32)
    d_invd = torch.zeros((n + 1,), **f32)
    n_chunks = int(((pairs.tile_count + chunk - 1) // chunk).max()) if t else 0

    i = 0
    while i < n_chunks and not bool(done.all()):
        gid, pvalid, _ = _chunk_pair_data(pairs, i, chunk)
        alpha_eff, indiv, g, dx, dy, (ca, cb, cc), op = _chunk_alpha(
            prep, gid, pvalid, pixf_x, pixf_y)
        one_m = 1.0 - alpha_eff
        p_incl = trans[:, :, None] * torch.cumprod(one_m, dim=-1)
        t_ex = p_incl / one_m
        kept = indiv & (p_incl >= T_EPS) & ~done[:, :, None]
        w = torch.where(kept, alpha_eff * t_ex, 0.0)

        # the channel and pixel sums are written out, not einsum: a BLAS
        # call may order its additions by the data's alignment, so the
        # result would change from run to run
        col = prep.rgb[gid]                                       # (T,C,3)
        cdot = torch.sum(col[:, None] * dl_dpix[:, :, None], dim=-1)  # (T,P,C)
        if with_depth:
            cdot = cdot + inv_depth[gid][:, None, :] * dl_ddepth[:, :, None]
        u = w * cdot
        prefix_u_incl = prefix_u[:, :, None] + torch.cumsum(u, dim=-1)

        inv_one_m = 1.0 / one_m
        dl_dalpha = (cdot * t_ex
                     - (ctot_dot[:, :, None] - prefix_u_incl) * inv_one_m
                     - (final_t[:, :, None] * inv_one_m) * bg_dot[:, :, None])
        dl_dalpha = torch.where(kept, dl_dalpha, 0.0)

        # per-pair sums over the tile's pixels
        d_color_pair = torch.sum(w[..., None] * dl_dpix[:, :, None], dim=1)
        dl_dg = op * dl_dalpha                                    # (T,P,C)
        gdx = g * dx
        gdy = g * dy
        dg_ddelx = -gdx * ca - gdy * cb
        dg_ddely = -gdy * cc - gdx * cb
        d_mx = torch.sum(dl_dg * dg_ddelx, dim=1) * ddelx_dx      # (T,C)
        d_my = torch.sum(dl_dg * dg_ddely, dim=1) * ddely_dy
        d_ca = torch.sum(-0.5 * gdx * dx * dl_dg, dim=1)
        d_cb = torch.sum(-0.5 * gdx * dy * dl_dg, dim=1)
        d_cc = torch.sum(-0.5 * gdy * dy * dl_dg, dim=1)
        d_op = torch.sum(torch.where(kept, g, 0.0) * dl_dalpha, dim=1)

        anyk = torch.any(kept, dim=1)                             # (T,C)
        gid_s = torch.where(anyk, gid, n).reshape(-1)
        d_color.index_add_(0, gid_s, d_color_pair.reshape(-1, 3))
        d_mean2d.index_add_(0, gid_s,
                            torch.stack([d_mx, d_my], dim=-1).reshape(-1, 2))
        d_conic.index_add_(0, gid_s, torch.stack([d_ca, d_cb, d_cc],
                                                 dim=-1).reshape(-1, 3))
        d_opac.index_add_(0, gid_s, d_op.reshape(-1))
        if with_depth:
            d_invd_pair = torch.sum(w * dl_ddepth[:, :, None], dim=1)
            d_invd.index_add_(0, gid_s, d_invd_pair.reshape(-1))

        # carry updates (identical to the forward)
        p_kept = torch.where(kept, p_incl, torch.inf)
        p_last = torch.amin(p_kept, dim=-1)
        trans = torch.where(torch.isfinite(p_last), p_last, trans)
        done = done | torch.any(indiv & (p_incl < T_EPS), dim=-1)
        prefix_u = prefix_u + torch.sum(u, dim=-1)
        i += 1
    return d_color[:n], d_mean2d[:n], d_conic[:n], d_opac[:n], d_invd[:n]


# Fields of a per-pair gradient row of the backward kernel, in order.
PAIR_ROW_FIELDS = ("mean2d_x", "mean2d_y", "conic_a", "conic_b", "conic_c",
                   "opacity", "color_r", "color_g", "color_b", "invdepth")


# Slots past the last Gaussian's segment are summed in pieces of at most
# this many rows (see segment_sum_pair_rows).
_TAIL_SEGMENT = 1024


def segment_sum_pair_rows(rows: torch.Tensor, pairs: Pairs,
                          settings: RenderSettings):
    """Epilogue of the backward kernel: per-pair rows to per-Gaussian sums.

    ``rows``: (K2 + 1, 10) f32, one row per sorted pair slot (fields
    ``PAIR_ROW_FIELDS``) and a last row of zeros; rows the kernel did not
    write (past a tile's early exit, slots of no tile) must be zero.  The
    rows are gathered to Gaussian-major order by ``gm_pos`` (slots past the
    kept slice read the zero row) and summed per Gaussian over the
    ``gauss_cum`` segments by ``torch.segment_reduce``, which adds each
    segment's rows one after another in slot order, one thread per segment
    and field on the card: deterministic, and without the cancellation of a
    difference of running sums.  The slots past the last segment (invalid
    pairs, zero rows) form segments of at most 1024 rows, so no thread walks
    the whole unused capacity.  Returns the five gradients of
    ``composite_backward``.
    """
    n = pairs.gauss_cum.shape[0]
    k2 = pairs.gauss_id.shape[0]
    if rows.shape != (k2 + 1, len(PAIR_ROW_FIELDS)):
        raise ValueError(f"rows has shape {tuple(rows.shape)}, expected "
                         f"{(k2 + 1, len(PAIR_ROW_FIELDS))}")
    k_full = pairs.gm_pos.shape[0]
    src = torch.clamp(pairs.gm_pos, max=k2).long()
    rows_gm = rows[src]                                       # (K, 10)
    ends = torch.clamp(pairs.gauss_cum.long(), 0, k_full)
    lengths = torch.diff(ends, prepend=ends.new_zeros(1))
    n_tail = -(-k_full // _TAIL_SEGMENT)
    tail = torch.clamp(
        (k_full - ends[-1:]) - _TAIL_SEGMENT * torch.arange(
            n_tail, device=ends.device), 0, _TAIL_SEGMENT)
    acc = torch.segment_reduce(rows_gm, "sum",
                               lengths=torch.cat([lengths, tail]),
                               axis=0)[:n]
    d_mean2d = acc[:, 0:2] * torch.tensor(
        [0.5 * settings.width, 0.5 * settings.height], dtype=acc.dtype,
        device=acc.device)
    return acc[:, 6:9], d_mean2d, acc[:, 2:5], acc[:, 5], acc[:, 9]


def tiles_to_image(tiled: torch.Tensor, settings: RenderSettings) -> torch.Tensor:
    """(T_band, 256, ...) tile-pixel layout -> (rows*16, W, ...) image.

    A full-grid render is cropped to (H, W); a band render returns the
    uncropped band.
    """
    gx = settings.grid_x
    gy = settings.band_rows
    trailing = tuple(tiled.shape[2:])
    img = tiled.reshape((gy, gx, TILE_Y, TILE_X) + trailing)
    img = img.transpose(1, 2).reshape((gy * TILE_Y, gx * TILE_X) + trailing)
    if settings.tile_rows is None:
        return img[:settings.height, :settings.width]
    return img[:, :settings.width]


def image_to_tiles(img: torch.Tensor, settings: RenderSettings) -> torch.Tensor:
    """(H_band, W, ...) -> (T_band, 256, ...), zero-padded to the tile grid."""
    gx, gy = settings.grid_x, settings.band_rows
    trailing = tuple(img.shape[2:])
    padded = img.new_zeros((gy * TILE_Y, gx * TILE_X) + trailing)
    padded[:img.shape[0], :img.shape[1]] = img
    out = padded.reshape((gy, TILE_Y, gx, TILE_X) + trailing)
    return out.transpose(1, 2).reshape((gy * gx, TILE_PIXELS) + trailing)


def _kernel_compositing():
    """(composite_forward, composite_backward) of the differentiable
    render: the kernel wrappers, which run the plain versions for CPU
    tensors; the forward also returns K1's checkpoints for K2 (None on the
    CPU)."""
    # cuda_rasterize imports this module for the plain versions
    from gstpu_torch.ops import cuda_rasterize
    return (cuda_rasterize.composite_forward_checkpointed,
            cuda_rasterize.composite_backward)


def _render_fwd(settings: RenderSettings, tan_fovx: float, tan_fovy: float,
                scale_modifier: float, means, scales, rotations, opacities,
                shs, view, proj, campos, bg, alive, row0: int,
                composite_fwd, mesh=None):
    """Forward render; returns ((image, depth, RenderAux), (prep, pairs,
    color, dacc, *rest)), the second tuple being what the backward needs:
    ``rest`` is what ``composite_fwd`` returns past its four outputs (the
    checkpoints of ``cuda_rasterize.composite_forward_checkpointed``)."""
    def _preprocess(ms, sc, rt, op, sh, al):
        return cuda_preprocess.preprocess(
            ms, sc, rt, op, sh, view, proj, campos, settings.width,
            settings.height, tan_fovx, tan_fovy, settings.grid_x,
            settings.grid_y, settings.sh_degree,
            scale_modifier=scale_modifier, alive=al,
            tight_radius=settings.tight_radius)

    axis = _slice_axis(settings, mesh, means.shape[0], "preprocess")
    with tracing.span("forward.preprocess"):
        if axis is None:
            prep = _preprocess(means, scales, rotations, opacities, shs, alive)
        else:
            # the preprocess is elementwise per Gaussian: each rank runs its
            # slice and all-gathers the outputs
            from gstpu_torch.parallel import collectives
            nl = means.shape[0] // axis.size
            i0 = axis.index * nl

            def sl(x):
                return None if x is None else x[i0:i0 + nl]

            prep_local = _preprocess(sl(means), sl(scales), sl(rotations),
                                     sl(opacities), sl(shs), sl(alive))
            prep = PreprocessOut(*collectives.all_gather_many(prep_local,
                                                              axis))
    with tracing.span("forward.binning"):
        rect_band, tiles_band = clip_rect_to_band(
            prep.rect, prep.tiles_touched, row0, settings.band_rows,
            settings.row_stride)
        cull_xy = cull_tcut = None
        if settings.pair_cull:
            cull_tcut = pair_cull_threshold(prep)
            cull_xy = prep.xy
        pairs = cuda_binning.build_pairs(
            tiles_band, rect_band, prep.depth, settings.grid_x,
            settings.band_tiles, settings.pair_capacity, cull_xy=cull_xy,
            cull_tcut=cull_tcut, row0=row0, row_stride=settings.row_stride,
            kept_capacity=settings.kept_capacity)
    with tracing.span("forward.composite"):
        color, dacc, final_t, n_contrib, *rest = composite_fwd(
            prep, pairs, settings, row0=row0)
    with tracing.span("forward.image"):
        image_tiles = color + final_t[:, :, None] * bg[None, None, :]
        image = tiles_to_image(image_tiles, settings)
        depth = tiles_to_image(dacc, settings)
    aux = RenderAux(radii=prep.radii, num_pairs=pairs.num_pairs,
                    final_t=final_t, n_contrib=n_contrib, xy=prep.xy,
                    num_kept=pairs.num_kept)
    return (image, depth, aux), (prep, pairs, color, dacc, *rest)


def render_forward(settings: RenderSettings, tan_fovx: float, tan_fovy: float,
                   scale_modifier: float, means, scales, rotations, opacities,
                   shs, view, proj, campos, bg, alive=None, row0: int = 0,
                   mesh=None):
    """Forward render without autograd: returns (image (H,W,3), depth (H,W),
    RenderAux), the forward of ``render``.

    Compositing runs the CUDA kernel for tensors on a CUDA device (without
    checkpoints: no backward follows) and the plain version for tensors on
    the CPU.  ``mesh`` resolves ``settings.shard_axis``.
    """
    from gstpu_torch.ops import cuda_rasterize
    return _render_fwd(settings, tan_fovx, tan_fovy, scale_modifier, means,
                       scales, rotations, opacities, shs, view, proj, campos,
                       bg, alive, row0, cuda_rasterize.composite_forward,
                       mesh)[0]


_N_PREP = len(PreprocessOut._fields)
_N_PAIRS = len(Pairs._fields)


class _Render(torch.autograd.Function):
    """Custom-VJP render (``gstpu/ops/rasterize.py::render``,
    ``_render_fwd`` and ``_render_bwd``).  Checkpoints that the forward
    compositing returns (K1's, on the card) go to the backward compositing
    (K2)."""

    @staticmethod
    def forward(ctx, settings, tan_fovx, tan_fovy, scale_modifier, row0,
                compositing, mesh, means, scales, rotations, opacities, shs,
                view, proj, campos, bg, alive):
        (image, depth, aux), (prep, pairs, color, dacc, *rest) = _render_fwd(
            settings, tan_fovx, tan_fovy, scale_modifier, means, scales,
            rotations, opacities, shs, view, proj, campos, bg, alive, row0,
            compositing[0], mesh)
        ctx.static = (settings, tan_fovx, tan_fovy, scale_modifier, row0,
                      compositing[1], mesh)
        # K1's checkpoints are the kernels' state, not autograd inputs
        ctx.checkpoints = rest[0] if rest else None
        ctx.save_for_backward(*prep, *pairs, color, dacc, aux.final_t, means,
                              scales, rotations, shs, view, proj, campos, bg)
        ctx.mark_non_differentiable(*aux)
        return (image, depth) + tuple(aux)

    @staticmethod
    def backward(ctx, ct_image, ct_depth, *_aux_cotangents):
        (settings, tan_fovx, tan_fovy, scale_modifier, row0,
         composite_bwd, mesh) = ctx.static
        checkpoints = ({} if ctx.checkpoints is None
                       else {"checkpoints": ctx.checkpoints})
        saved = ctx.saved_tensors
        prep = PreprocessOut(*saved[:_N_PREP])
        pairs = Pairs(*saved[_N_PREP:_N_PREP + _N_PAIRS])
        (color, dacc, final_t, means, scales, rotations, shs, view, proj,
         campos, bg) = saved[_N_PREP + _N_PAIRS:]

        with tracing.span("backward.composite"):
            dl_dpix = image_to_tiles(ct_image, settings)
            # the inverse-depth image is a fourth composited channel with
            # no background term (the reference has no depth backward)
            dl_ddepth = image_to_tiles(ct_depth, settings)
            d_color, d_mean2d, d_conic, d_opac, d_invd = composite_bwd(
                prep, pairs, settings, color, final_t, dl_dpix, bg,
                row0=row0, depth_acc=dacc, dl_ddepth=dl_ddepth,
                **checkpoints)

        with tracing.span("backward.adjoint"):
            focal_x = settings.width / (2.0 * tan_fovx)
            focal_y = settings.height / (2.0 * tan_fovy)
            n = means.shape[0]
            chain = (means, prep.cov3d, prep.radii, shs, prep.clamped,
                     scales, rotations, prep.depth)
            axis = _slice_axis(settings, mesh, n, "adjoint")
            if axis is not None:
                # the chain is per Gaussian and linear in the cotangents:
                # sum the bands' cotangents first (a Gaussian's pairs span
                # several bands), then chain this rank's slice alone
                from gstpu_torch.parallel import collectives
                nl = n // axis.size
                i0 = axis.index * nl
                chain = tuple(x[i0:i0 + nl] for x in chain)
                d_conic, d_mean2d, d_color, d_invd = \
                    collectives.reduce_scatter_many(
                        (d_conic, d_mean2d, d_color, d_invd), axis)
            (means_c, cov3d, radii, shs_c, clamped, scales_c, rots_c,
             depth) = chain
            # preprocess adjoint chain: cov2d -> projection -> SH -> cov3d,
            # with dL/dmeans gathered from four sources
            dmean_cov, dcov3d = preprocess_bwd.cov2d_backward(
                means_c, cov3d, radii, focal_x, focal_y, tan_fovx,
                tan_fovy, view, d_conic, parity=settings.parity,
                translation_bias=settings.grad_bias_parity)
            dmean_proj = preprocess_bwd.projection_backward(
                means_c, radii, proj, d_mean2d)
            dsh, dmean_sh = preprocess_bwd.sh_backward(
                means_c, shs_c, radii, campos, clamped, d_color,
                settings.sh_degree)
            dscale, drot = preprocess_bwd.cov3d_backward(
                scales_c, rots_c, radii, scale_modifier, dcov3d,
                parity=settings.parity)
            # depth chain: inv_depth = 1/t_z, t_z = [p,1] @ view (row
            # vector), so dL/dp_j += -inv_depth^2 * dL/dinv_depth * view[j, 2]
            inv_depth = 1.0 / torch.where(depth == 0.0, 1.0, depth)
            d_tz = torch.where(radii > 0, -inv_depth * inv_depth * d_invd,
                               0.0)
            dmean_depth = d_tz[:, None] * view[None, :3, 2]
            dmean = dmean_cov + dmean_proj + dmean_sh + dmean_depth
            if axis is not None:
                # back at full size, zero outside the slice: the
                # reduce-scatter of the caller's all-gather sums the ranks
                # and hands each its slice complete
                def embed(x):
                    full = x.new_zeros((n,) + tuple(x.shape[1:]))
                    full[i0:i0 + nl] = x
                    return full

                dmean, dscale, drot, dsh = map(embed,
                                               (dmean, dscale, drot, dsh))
        # settings, tan_fovx, tan_fovy, scale_modifier, row0, compositing,
        # mesh; the camera, background and alive mask are inputs, not
        # parameters
        return ((None,) * 7 + (dmean, dscale, drot, d_opac, dsh)
                + (None,) * 5)


def render(settings: RenderSettings, tan_fovx: float, tan_fovy: float,
           scale_modifier: float, means, scales, rotations, opacities, shs,
           view, proj, campos, bg, alive=None, row0: int = 0, mesh=None,
           _compositing=None):
    """Differentiable render: returns (image (H,W,3), depth (H,W), aux).

    Gradients flow to ``means``, ``scales``, ``rotations``, ``opacities``
    and ``shs`` through the hand-written backward: compositing adjoint (the
    CUDA kernel K2 and its epilogue for CUDA tensors, from K1's checkpoints;
    the plain version for CPU tensors), then the preprocess adjoint chain with the reference's
    quirks under ``settings.parity``.  ``alive`` is an (N,) bool mask of
    capacity padding.  ``mesh`` (a ``parallel.mesh.Mesh``) resolves
    ``settings.shard_axis``.  ``_compositing``, a (composite_forward,
    composite_backward) pair in place of the kernel wrappers, is for checks
    that hold the kernels against their plain versions on the card.
    """
    out = _Render.apply(settings, float(tan_fovx), float(tan_fovy),
                        float(scale_modifier), int(row0),
                        _compositing or _kernel_compositing(), mesh, means,
                        scales, rotations, opacities, shs, view, proj, campos,
                        bg, alive)
    return out[0], out[1], RenderAux(*out[2:])
