"""Sharded render and train step over a (data, model) mesh of ranks.

Port of ``gstpu/parallel/sharded.py``; each function here runs on every
rank of the mesh, as the body of the JAX package's ``shard_map`` runs on
every device.

- Parameters and Adam moments are split over ``model`` (axis 0 of every
  parameter tensor).
- Forward: the parameter shards are all-gathered over ``model``; each rank
  preprocesses its 1/n_model slice of the Gaussians (all-gathering the
  result, ``ops/rasterize.py``), then bins and rasterizes only its own
  round-robin tile rows ``{m + k * n_model}`` with K1.
- Loss: each rank sums its band's L1 (and, with ``lambda_dssim``, its
  band's SSIM map, from 5-row halos exchanged with its row neighbours;
  with ``lambda_depth``, its band's masked inverse-depth L1); the partial
  losses are summed over both axes.
- Backward: K2 on the band; the all-gather's backward reduce-scatters the
  Gaussians' gradients over ``model``; the camera batch is summed over
  ``data``.
- Adam runs on each rank's shard.

A batch holds one camera per data index: rank ``(d, m)`` takes camera ``d``
and band ``m`` of its padded target.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from gstpu_torch.config import GSConfig, RenderSettings, TILE_Y
from gstpu_torch.models.gaussians import activate_params
from gstpu_torch.ops.losses import _abs, ssim_map_chunks
from gstpu_torch.ops.rasterize import render, render_forward, tiles_to_image
from gstpu_torch.optim import adam_step, schedule_lrs
from gstpu_torch.parallel import collectives

HALO = 5  # rows an 11x11 SSIM window reaches past a tile row


def band_settings(settings: RenderSettings, n_model: int) -> RenderSettings:
    """Settings of one rank's band: the round-robin tile rows
    ``{m + k * n_model : k < ceil(grid_y / n_model)}`` of model index m.

    Round-robin rows, not contiguous bands: a scene's splats gather in the
    middle rows.  Rows past ``grid_y`` clip empty and are masked or cropped
    by the callers.  With more than one model rank the settings name the
    ``model`` axis, so each rank runs the per-Gaussian chains on its slice
    (``ops/rasterize.py``)."""
    rows = -(-settings.grid_y // n_model)
    return dataclasses.replace(settings, tile_rows=rows, row_stride=n_model,
                               shard_axis="model" if n_model > 1 else None)


def interleave_bands(bands: torch.Tensor, n_model: int, band_rows: int,
                     height: int, width: int) -> torch.Tensor:
    """(n_model * band_rows * 16, W, ...) gathered bands, band m holding
    tile rows ``m::n_model``, to the (H, W, ...) image."""
    trailing = tuple(bands.shape[1:])
    img = bands.reshape((n_model, band_rows, TILE_Y) + trailing)
    img = img.transpose(0, 1).reshape((n_model * band_rows * TILE_Y,)
                                      + trailing)
    return img[:height, :width]


def render_sharded(settings: RenderSettings, mesh, params: dict, alive,
                   view, proj, campos, bg, tan_fovx: float, tan_fovy: float,
                   scale_modifier: float = 1.0) -> dict:
    """The full frame from every model rank's band, without autograd.

    ``params`` and ``alive`` are the whole model, the same on every rank
    (the JAX function's global arrays); N is padded with dead Gaussians to
    a multiple of the model axis, so the sliced chains stay on.  Returns
    the (H, W[, 3]) image, inverse depth, final transmittance and
    contributor count, the same on every rank of a model row.
    """
    n_model = mesh.n_model
    bset = band_settings(settings, n_model)
    n = params["positions"].shape[0]
    extra = -n % n_model
    if extra:
        params = {k: torch.cat([x, x.new_zeros((extra,) + x.shape[1:])])
                  for k, x in params.items()}
        alive = torch.cat([alive, alive.new_zeros(extra)])
    with torch.no_grad():
        image, depth, aux = render_forward(
            bset, tan_fovx, tan_fovy, scale_modifier, params["positions"],
            params["scales"], params["rotations"], params["opacities"],
            params["shs"], view, proj, campos, bg, alive,
            row0=mesh.model.index, mesh=mesh)
    bands = [image, depth, tiles_to_image(aux.final_t, bset),
             tiles_to_image(aux.n_contrib, bset)]
    bands = collectives.all_gather_many(bands, mesh.model)
    full = [interleave_bands(b, n_model, bset.band_rows, settings.height,
                             settings.width) for b in bands]
    return dict(zip(("image", "depth", "final_t", "n_contrib"), full))


def make_sharded_render(settings: RenderSettings, mesh, tan_fovx: float,
                        tan_fovy: float, scale_modifier: float = 1.0):
    """Multi-rank render: returns ``fn(params, alive, view, proj, campos,
    bg[, tan_fovx, tan_fovy]) -> (H, W, 3)`` image, the same on every rank
    of a model row.  ``params`` is the whole model on every rank; the
    factory's tangents are the default, per-call ones override them."""
    def run(params, alive, view, proj, campos, bg, tfx=None, tfy=None):
        return render_sharded(
            settings, mesh, params, alive, view, proj, campos, bg,
            tan_fovx if tfx is None else tfx,
            tan_fovy if tfy is None else tfy, scale_modifier)["image"]
    return run


def _halo_exchange(chunks: torch.Tensor, mesh, halo: int):
    """The 5-row halos of round-robin tile-row chunks over ``model``.

    ``chunks``: (band_rows, 16, W, C), chunk k of model rank m being global
    tile row ``m + k * n_model``.  Returns (top, bottom): chunk k's top halo
    is the last ``halo`` rows of tile row g - 1, its bottom halo the first
    rows of tile row g + 1, received from ranks m - 1 and m + 1 in one
    exchange, zeros at the grid's top and bottom."""
    n_model, m = mesh.n_model, mesh.model.index
    recv_b, recv_t = collectives.Exchange.apply(
        mesh.model, chunks[:, :halo].contiguous(),
        chunks[:, -halo:].contiguous())
    # the wrap: rank n-1's chunk k borders rank 0's chunk k+1 (the last
    # chunk borders the grid's bottom: zeros); rank 0's chunk k borders
    # rank n-1's chunk k-1 (chunk 0 borders the grid's top)
    zeros = torch.zeros_like(recv_b[:1])
    bottom = (torch.cat([recv_b[1:], zeros]) if m == n_model - 1 else recv_b)
    top = torch.cat([zeros, recv_t[:-1]]) if m == 0 else recv_t
    return top, bottom


def sharded_loss_and_grads(settings: RenderSettings, config: GSConfig, mesh,
                           params_shard: dict, alive_shard, view, proj,
                           campos, tan_fovx: float, tan_fovy: float,
                           target_band, tdepth_band=None, dmask_band=None,
                           _compositing=None):
    """This rank's part of one sharded step: the loss summed over the mesh,
    this rank's shard of the gradients summed over ``data``, and the pair
    counts (num_pairs, num_kept), the maximum over the mesh.

    ``settings`` are the full frame's (``band_settings`` is applied here);
    ``target_band`` (band_h, W, 3) and the optional depth target and mask
    (band_h, W) are this rank's band of the padded targets
    (``pad_targets_to_grid``).  ``_compositing`` is passed on to ``render``.
    """
    n_model, n_data = mesh.n_model, mesh.n_data
    m = mesh.model.index
    bset = band_settings(settings, n_model)
    height, width = settings.height, settings.width
    lambda_dssim = float(config.lambda_dssim)
    lambda_depth = float(config.lambda_depth)
    alive = collectives.all_gather_rows(alive_shard, mesh.model)
    bg = torch.tensor(config.background_color, dtype=torch.float32,
                      device=target_band.device)
    ps = {k: x.detach().requires_grad_(True) for k, x in params_shard.items()}
    p = activate_params(collectives.all_gather_params(ps, mesh.model),
                        config.parameterization)
    image_band, depth_band, aux = render(
        bset, tan_fovx, tan_fovy, config.scale_modifier, p["positions"],
        p["scales"], p["rotations"], p["opacities"], p["shs"], view, proj,
        campos, bg, alive, m, mesh=mesh, _compositing=_compositing)
    # rows past the image (the tile grid's padding): band pixel row r lies
    # in global tile row m + (r // 16) * n_model
    r = torch.arange(image_band.shape[0], device=image_band.device)
    rows = (m + (r // TILE_Y) * n_model) * TILE_Y + r % TILE_Y
    mask = (rows < height).to(image_band.dtype)[:, None, None]
    # local partial sums: the collectives act on the loss and gradients
    # outside the differentiation
    l1_partial = torch.sum(_abs(image_band - target_band) * mask)
    partial = (1.0 - lambda_dssim) * l1_partial / (n_data * height * width
                                                   * 3.0)
    if lambda_dssim > 0.0:
        # band-local SSIM: an 11x11 window reaches 5 rows past a tile row,
        # so each rank exchanges 5-row halos with its row neighbours and
        # maps only its own rows; zeroed pad rows reproduce the full
        # image's zero padding, and each row belongs to one rank
        band_rows = bset.band_rows
        both = torch.cat([image_band * mask, target_band * mask], dim=-1)
        chunks = both.reshape(band_rows, TILE_Y, width, 6)
        top, bottom = _halo_exchange(chunks, mesh, HALO)
        ext = torch.cat([top, chunks, bottom], dim=1)
        smap = ssim_map_chunks(ext[..., :3], ext[..., 3:])
        ssim_sum = torch.sum(smap.reshape(-1, width, 3) * mask)
        partial = partial + lambda_dssim * (
            1.0 / (n_data * n_model)
            - ssim_sum / (n_data * height * width * 3.0))
    if tdepth_band is not None:
        # masked inverse-depth L1 of the band (pointwise: no halo); the
        # single-device normalization is H * W
        diff = _abs(depth_band - config.depth_scale * tdepth_band)
        partial = partial + lambda_depth * torch.sum(
            diff * dmask_band * mask[:, :, 0]) / (n_data * height * width)
    grads = torch.autograd.grad(partial, list(ps.values()))
    # the all-gather's backward reduce-scattered the bands over 'model';
    # the camera batch sums over 'data'
    grads = dict(zip(ps, collectives.all_reduce_many(grads, mesh.data)))
    loss = collectives.all_reduce(partial.detach(), None)
    counts = collectives.all_reduce(
        torch.stack([aux.num_pairs, aux.num_kept]), None, op="max")
    return loss, grads, counts


def make_sharded_train_step(settings: RenderSettings, config: GSConfig,
                            mesh):
    """Multi-rank train step.

    Returns ``fn(params_shard, adam_shard, alive_shard, views (B,4,4),
    projs (B,4,4), camposes (B,3), tan_fovxs (B,), tan_fovys (B,),
    targets (B,H',W,3), iteration[, target_depths (B,H',W), depth_masks
    (B,H',W)]) -> (new_params_shard, new_adam_shard, loss,
    pos_grads_shard, counts, iteration + 1)``, the JAX step's contract on
    every rank: B is the data axis's size, targets are padded to H' =
    n_model * band_rows * 16 (``pad_targets_to_grid``), the loss and the
    counts (num_pairs, num_kept; the maximum over the mesh) are the same
    on every rank.  Intrinsics ride per camera like the poses.
    """
    n_model = mesh.n_model
    band_h = band_settings(settings, n_model).band_rows * TILE_Y
    d, m = mesh.coords

    def step(params_shard, adam_shard, alive_shard, views, projs, camposes,
             tan_fovxs, tan_fovys, targets, iteration, target_depths=None,
             depth_masks=None, _compositing=None):
        def band(x):
            return None if x is None else x[d, m * band_h:(m + 1) * band_h]

        loss, grads, counts = sharded_loss_and_grads(
            settings, config, mesh, params_shard, alive_shard, views[d],
            projs[d], camposes[d], float(tan_fovxs[d]), float(tan_fovys[d]),
            band(targets), band(target_depths), band(depth_masks),
            _compositing=_compositing)
        new_p, new_adam = adam_step(params_shard, grads, adam_shard,
                                    schedule_lrs(config, iteration),
                                    iteration, config, alive=alive_shard)
        return new_p, new_adam, loss, grads["positions"], counts, \
            iteration + 1

    return step


def pad_targets_to_grid(targets: torch.Tensor, settings: RenderSettings,
                        n_model: int = 1) -> torch.Tensor:
    """(B, H, W[, C]) -> (B, n_model * band_rows * 16, W[, C]), zero-padded
    and permuted so that rows ``[m * band_h, (m + 1) * band_h)`` hold model
    rank m's round-robin tile rows ``m::n_model`` (``target_band``).  Depth
    targets and masks (B, H, W) shard the same way."""
    return torch.stack([
        torch.cat([target_band(t, settings, n_model, m)
                   for m in range(n_model)]) for t in targets])


def target_band(target: torch.Tensor, settings: RenderSettings,
                n_model: int, m: int) -> torch.Tensor:
    """Model rank m's band of one (H, W[, C]) target: its tile rows
    ``m::n_model``, zero-padded past the image; the m-th block of rows of
    ``pad_targets_to_grid`` for this one target."""
    band_rows = band_settings(settings, n_model).band_rows
    h_pad = band_rows * n_model * TILE_Y - target.shape[0]
    if h_pad:
        target = F.pad(target, (0, 0) * (target.dim() - 1) + (0, h_pad))
    trailing = tuple(target.shape[1:])
    rows = target.reshape((band_rows, n_model, TILE_Y) + trailing)[:, m]
    return rows.reshape((band_rows * TILE_Y,) + trailing)
