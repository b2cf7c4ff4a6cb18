"""The plain reference of a 3D Gaussian Splatting render and training step.

Plain PyTorch, written from the 3DGS method (Kerbl et al., SIGGRAPH 2023)
and the semantics of its reference CUDA rasterizer; it imports nothing of
the program under test.  Every function takes the inputs the benchmark made
(parameters, cameras, targets) and works out the rest itself: the
projection, the tile pairs and their depth order, the compositing, the
loss, the gradients and the Adam update.

Semantics held, in order of the step:

- preprocess: near cull at z < 0.2, EWA splat with view-space x/y clamped
  to 1.3 tan(fov) z and the 0.3 low-pass, conic, 3-sigma screen radius (or
  the tight alpha >= 1/255 reach), tile rect, SH colour of degree 3 plus
  0.5 clamped at 0;
- binning: one pair per (Gaussian, touched tile), dropped where the
  Gaussian's largest alpha over the tile's pixels is provably under 1/255
  (the exact pair cull), ordered by (tile, depth), ties by Gaussian;
- compositing: front to back per pixel, a pair skipped where its power is
  positive or its alpha (at most 0.99) is under 1/255, the pixel stopped at
  the first pair that would take its transmittance under 1e-4;
- loss: (1 - lambda) L1 + lambda (1 - SSIM), SSIM with an 11x11 Gaussian
  window of sigma 1.5 and zero padding;
- gradients: the compositing's are exact (autograd, tile block by tile
  block); the preprocess chain is the reference rasterizer's hand-written
  backward, which is not the exact adjoint of its forward in three places
  and is kept so: the EWA Jacobian product is taken as W J^T where the
  forward takes J W, the covariance as (S R)^T (S R) where the forward
  takes (R S)(R S)^T, the conic's inverse with det^2 + 1e-7, and the
  clamp of the view-space x/y treated as a constant;
- Adam with bias correction at iteration + 1, exponential learning-rate
  decay of each group, and quaternions renormalized after the step.

Geometry is done with small matrix products, as a plain implementation
writes it.  TF32 is switched off for every product here; the benchmark's
control computes the same with it on.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

TILE = 16
PIX = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
NEAR = 0.2

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
_INT_SAFE = float(1 << 30)
GROUPS = ("positions", "scales", "rotations", "opacities", "shs")


@dataclasses.dataclass
class Camera:
    """A pinhole camera in the row-vector convention: a point goes to view
    space as ``[p, 1] @ view`` and to clip space as ``[p, 1] @ proj``."""
    view: torch.Tensor     # (4, 4)
    proj: torch.Tensor     # (4, 4)
    campos: torch.Tensor   # (3,)
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int

    @property
    def grid(self) -> tuple[int, int]:
        return (-(-self.width // TILE), -(-self.height // TILE))


def activate(stored: dict) -> dict:
    """Stored parameters (log scales, opacity logits) to render space."""
    return {**stored, "scales": torch.exp(stored["scales"]),
            "opacities": torch.sigmoid(stored["opacities"])}


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) quaternions (x, y, z, w), not normalized, to (N, 3, 3)."""
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def eval_sh(shs: torch.Tensor, d: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH colour of (N, 16, 3) coefficients along unit directions."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    out = SH_C0 * shs[:, 0]
    if degree > 0:
        out = out - SH_C1 * y * shs[:, 1] + SH_C1 * z * shs[:, 2] \
            - SH_C1 * x * shs[:, 3]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        basis = (x * y, y * z, 2 * zz - xx - yy, x * z, xx - yy)
        for k in range(5):
            out = out + SH_C2[k] * basis[k] * shs[:, 4 + k]
        if degree > 2:
            basis = (y * (3 * xx - yy), x * y * z, y * (4 * zz - xx - yy),
                     z * (2 * zz - 3 * xx - 3 * yy), x * (4 * zz - xx - yy),
                     z * (xx - yy), x * (xx - 3 * yy))
            for k in range(7):
                out = out + SH_C3[k] * basis[k] * shs[:, 9 + k]
    return out


def _homogeneous(means: torch.Tensor) -> torch.Tensor:
    return torch.cat([means, means.new_ones((len(means), 1))], 1)


def _trunc_int(x: torch.Tensor) -> torch.Tensor:
    x = torch.nan_to_num(x, nan=0.0, posinf=_INT_SAFE, neginf=-_INT_SAFE)
    return x.clamp(-_INT_SAFE, _INT_SAFE).to(torch.int64)


def _pixel(means: torch.Tensor, cam: Camera) -> torch.Tensor:
    """(N, 2) pixel coordinates of the projected means."""
    clip = _homogeneous(means) @ cam.proj
    ndc = clip[:, :2] * (1.0 / (clip[:, 3:4] + 1e-7))
    size = ndc.new_tensor([cam.width, cam.height])
    return ((ndc + 1.0) * size - 1.0) * 0.5


def _jacobian(means: torch.Tensor, cam: Camera):
    """View-space points, the EWA Jacobian (N, 2, 3) at the clamped point,
    and the clamp masks."""
    t = _homogeneous(means) @ cam.view
    tz = t[:, 2]
    lim = (1.3 * cam.tan_fovx, 1.3 * cam.tan_fovy)
    ratio = (t[:, 0] / tz, t[:, 1] / tz)
    tx = torch.clamp(ratio[0], -lim[0], lim[0]) * tz
    ty = torch.clamp(ratio[1], -lim[1], lim[1]) * tz
    fx = cam.width / (2.0 * cam.tan_fovx)
    fy = cam.height / (2.0 * cam.tan_fovy)
    zero = torch.zeros_like(tz)
    jac = torch.stack([fx / tz, zero, -fx * tx / (tz * tz),
                       zero, fy / tz, -fy * ty / (tz * tz)], -1).reshape(-1, 2, 3)
    inside = tuple(((r >= -l) & (r <= l)).to(t.dtype) for r, l in zip(ratio, lim))
    return t, tx, ty, jac, inside


def covariance(p: dict, scale_modifier: float = 1.0) -> torch.Tensor:
    """(N, 3, 3) world covariance (R S)(R S)^T."""
    m = quat_to_rotmat(p["rotations"]) * (scale_modifier * p["scales"])[:, None, :]
    return m @ m.transpose(1, 2)


def preprocess(p: dict, cam: Camera, degree: int = 3, tight: bool = True,
               scale_modifier: float = 1.0, sigma: torch.Tensor | None = None,
               colour: bool = True) -> dict:
    """Per-Gaussian screen quantities of render-space parameters ``p``
    (``sigma``: their covariance, if already worked out; ``colour=False``
    skips the SH colour)."""
    means = p["positions"]
    gx, gy = cam.grid
    t, _, _, jac, _ = _jacobian(means, cam)
    depth = t[:, 2]
    xy = _pixel(means, cam)
    if sigma is None:
        sigma = covariance(p, scale_modifier)
    tf = jac @ cam.view[:3, :3]                                   # J W
    cov = tf @ sigma @ tf.transpose(1, 2)
    a, b, c = cov[:, 0, 0] + 0.3, cov[:, 0, 1], cov[:, 1, 1] + 0.3
    det = a * c - b * b
    det_ok = det != 0.0
    inv = 1.0 / torch.where(det_ok, det, 1.0)
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    mid = 0.5 * (a + c)
    root = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lam = torch.maximum(mid + root, mid - root)
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    op = p["opacities"].reshape(-1)
    if tight:
        reach2 = 2.0 * torch.log(torch.clamp(255.0 * op, min=1e-12)) * lam
        radius = torch.minimum(radius,
                               torch.ceil(torch.sqrt(torch.clamp(reach2, min=0.0))))
    rect = torch.stack([
        _trunc_int((xy[:, 0] - radius) / TILE).clamp(0, gx),
        _trunc_int((xy[:, 1] - radius) / TILE).clamp(0, gy),
        _trunc_int((xy[:, 0] + radius + TILE - 1.0) / TILE).clamp(0, gx),
        _trunc_int((xy[:, 1] + radius + TILE - 1.0) / TILE).clamp(0, gy)], -1)
    tiles = (rect[:, 3] - rect[:, 1]) * (rect[:, 2] - rect[:, 0])
    visible = (depth >= NEAR) & det_ok & (tiles != 0)
    vis = visible.to(means.dtype)
    out = {"xy": xy * vis[:, None], "depth": depth * vis,
           "conic": conic * vis[:, None], "opacity": op * vis, "sigma": sigma,
           "rect": rect, "tiles": torch.where(visible, tiles, 0),
           "visible": visible}
    if colour:
        offset = means - cam.campos
        dirs = offset / torch.clamp(offset.norm(dim=-1, keepdim=True), min=1e-12)
        rgb = eval_sh(p["shs"], dirs, degree) + 0.5
        out.update(rgb=torch.clamp(rgb, min=0.0) * vis[:, None],
                   clamped=(rgb < 0.0).to(rgb.dtype))
    return out


def cull_threshold(prep: dict) -> torch.Tensor:
    """Squared distance past which a Gaussian's alpha is under 1/255 for
    certain: 2 ln(255 op) over the conic's smaller eigenvalue, with a
    1.0001 margin toward keeping."""
    ca, cb, cc = prep["conic"].unbind(-1)
    mid = 0.5 * (ca + cc)
    lam_min = mid - torch.sqrt(torch.clamp(mid * mid - (ca * cc - cb * cb), min=0.0))
    log_term = 2.0 * torch.log(torch.clamp(255.0 * prep["opacity"], min=1e-12))
    return torch.where(lam_min > 0.0, 1.0001 * log_term / lam_min, torch.inf)


def pair_counts(prep: dict, cam: Camera) -> tuple[int, int]:
    """(pairs, pairs left by the cull) of one view, counted per tile row of
    each Gaussian's rect without listing the pairs: in a tile row at
    distance dy the kept tiles are those whose pixel span lies within
    sqrt(tcut - dy^2) of the centre."""
    rect, tiles = prep["rect"], prep["tiles"]
    heights = torch.where(tiles > 0, rect[:, 3] - rect[:, 1], 0)
    rows = int(heights.sum())
    g = torch.repeat_interleave(torch.arange(len(tiles), device=tiles.device),
                                heights, output_size=rows)
    first = torch.cumsum(heights, 0) - heights
    ty = rect[g, 1] + torch.arange(rows, device=tiles.device) - first[g]
    cx, cy = prep["xy"][g].unbind(-1)
    top = (ty * TILE).to(cy.dtype)
    dy = torch.clamp(cy, top, top + TILE - 1.0) - cy
    r2 = cull_threshold(prep)[g] - dy * dy
    r = torch.sqrt(torch.clamp(r2, min=0.0))
    lo = torch.maximum(torch.ceil((cx - (TILE - 1.0) - r) / TILE).to(torch.int64), rect[g, 0])
    hi = torch.minimum(torch.floor((cx + r) / TILE).to(torch.int64), rect[g, 2] - 1)
    kept = torch.where(r2 >= 0.0, torch.clamp(hi - lo + 1, min=0), 0).sum()
    return int(tiles.sum()), int(kept)


@dataclasses.dataclass
class Pairs:
    gid: torch.Tensor          # (K,) Gaussian of each kept pair, sorted
    tile_start: torch.Tensor   # (T,)
    tile_count: torch.Tensor   # (T,)
    num_pairs: int             # before the cull
    num_kept: int


def bin_pairs(prep: dict, cam: Camera, cull: bool = True) -> Pairs:
    """Every (Gaussian, touched tile) pair, culled, in (tile, depth) order."""
    gx, gy = cam.grid
    counts = prep["tiles"]
    dev = counts.device
    total = int(counts.sum())
    g = torch.repeat_interleave(torch.arange(len(counts), device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    local = torch.arange(total, device=dev) - first[g]
    rect = prep["rect"][g]
    width = torch.clamp(rect[:, 2] - rect[:, 0], min=1)
    tx = rect[:, 0] + local % width
    ty = rect[:, 1] + local // width
    keep = torch.ones(total, dtype=torch.bool, device=dev)
    if cull:
        cx, cy = prep["xy"][g].unbind(-1)
        x0 = (tx * TILE).to(cx.dtype)
        y0 = (ty * TILE).to(cy.dtype)
        dx = torch.clamp(cx, x0, x0 + TILE - 1.0) - cx
        dy = torch.clamp(cy, y0, y0 + TILE - 1.0) - cy
        keep = dx * dx + dy * dy <= cull_threshold(prep)[g]
    g, tile = g[keep], (ty * gx + tx)[keep]
    depth_bits = prep["depth"].view(torch.int32).to(torch.int64)[g]
    order = torch.sort((tile << 32) | depth_bits, stable=True)[1]
    count = torch.bincount(tile, minlength=gx * gy)
    return Pairs(gid=g[order], tile_start=torch.cumsum(count, 0) - count,
                 tile_count=count, num_pairs=total, num_kept=len(order))


def _blocks(pairs: Pairs, budget: int):
    """Tiles in blocks, deepest first, each block at most ``budget``
    (pixel, pair) elements wide: (tile ids, pairs per tile of the block)."""
    count, order = torch.sort(pairs.tile_count, descending=True, stable=True)
    count_h = count.tolist()
    i = 0
    while i < len(count_h) and count_h[i] > 0:
        depth = count_h[i]
        n = max(1, budget // (PIX * depth))
        yield order[i:i + n], depth
        i += n


def _pixel_centres(tiles: torch.Tensor, cam: Camera):
    gx = cam.grid[0]
    lp = torch.arange(PIX, device=tiles.device)
    px = (tiles % gx)[:, None] * TILE + lp % TILE
    py = (tiles // gx)[:, None] * TILE + lp // TILE
    return px.to(torch.float32), py.to(torch.float32)


def _composite_block(xy, conic, op, rgb, invd, valid, px, py):
    """One block's front-to-back walk.  Per-pair inputs (B, P, ...), pixel
    centres (B, 256).  Returns colour (B, 256, 3), inverse depth and final
    transmittance (B, 256), the pairs each pixel evaluates (up to its stop,
    or the whole tile) and its composited pairs."""
    dx = xy[:, None, :, 0] - px[:, :, None]                       # (B, 256, P)
    dy = xy[:, None, :, 1] - py[:, :, None]
    power = (-0.5 * (conic[:, None, :, 0] * dx * dx + conic[:, None, :, 2] * dy * dy)
             - conic[:, None, :, 1] * dx * dy)
    alpha = torch.clamp(op[:, None, :] * torch.exp(torch.clamp(power, max=0.0)),
                        max=ALPHA_MAX)
    passes = valid[:, None, :] & (power <= 0.0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(passes, alpha, 0.0)
    trans = torch.cumprod(1.0 - alpha, -1)                        # T after the pair
    kept = passes & (trans >= T_EPS)
    w = torch.where(kept, alpha * trans / (1.0 - alpha), 0.0)
    colour = w @ rgb                                              # (B, 256, 3)
    inv_depth = (w @ invd[:, :, None])[..., 0]
    final_t = torch.where(kept, trans, torch.inf).amin(-1)
    final_t = torch.where(torch.isfinite(final_t), final_t, 1.0)
    stops = passes & (trans < T_EPS)
    first_stop = torch.where(stops, torch.arange(stops.shape[-1], device=stops.device),
                             stops.shape[-1]).amin(-1)
    evaluated = torch.minimum(first_stop + 1, valid.sum(-1)[:, None])
    return colour, inv_depth, final_t, evaluated, kept.sum(-1)


def _gather(prep: dict, pairs: Pairs, tiles, depth):
    j = torch.arange(depth, device=tiles.device)
    valid = j < pairs.tile_count[tiles][:, None]
    idx = torch.clamp(pairs.tile_start[tiles][:, None] + j, max=max(len(pairs.gid) - 1, 0))
    gid = pairs.gid[idx]
    inv_depth = 1.0 / torch.where(prep["depth"] == 0.0, 1.0, prep["depth"])
    return gid, valid, [prep["xy"][gid], prep["conic"][gid], prep["opacity"][gid],
                        prep["rgb"][gid], inv_depth[gid]]


def _to_image(tiled: torch.Tensor, cam: Camera) -> torch.Tensor:
    gx, gy = cam.grid
    tail = tuple(tiled.shape[2:])
    img = tiled.reshape((gy, gx, TILE, TILE) + tail).transpose(1, 2)
    return img.reshape((gy * TILE, gx * TILE) + tail)[:cam.height, :cam.width]


def _to_tiles(img: torch.Tensor, cam: Camera) -> torch.Tensor:
    gx, gy = cam.grid
    tail = tuple(img.shape[2:])
    pad = img.new_zeros((gy * TILE, gx * TILE) + tail)
    pad[:cam.height, :cam.width] = img
    return pad.reshape((gy, TILE, gx, TILE) + tail).transpose(1, 2).reshape(
        (gx * gy, PIX) + tail)


def composite(prep: dict, pairs: Pairs, cam: Camera, bg: torch.Tensor,
              budget: int = 1 << 26) -> dict:
    """The image (H, W, 3), inverse depth (H, W), per-tile final
    transmittance and the walk's counts: ``evaluated`` (pixel, pair) steps
    and ``kept`` (composited) steps, summed over the frame."""
    gx, gy = cam.grid
    dev = prep["xy"].device
    colour = torch.zeros((gx * gy, PIX, 3), device=dev)
    inv_depth = torch.zeros((gx * gy, PIX), device=dev)
    final_t = torch.ones((gx * gy, PIX), device=dev)
    evaluated = kept = 0
    with torch.no_grad():
        for tiles, depth in _blocks(pairs, budget):
            _, valid, per_pair = _gather(prep, pairs, tiles, depth)
            px, py = _pixel_centres(tiles, cam)
            c, d, t, ev, k = _composite_block(*per_pair, valid, px, py)
            colour[tiles], inv_depth[tiles], final_t[tiles] = c, d, t
            evaluated += int(ev.sum())
            kept += int(k.sum())
    image = colour + final_t[:, :, None] * bg
    return {"image": _to_image(image, cam), "depth": _to_image(inv_depth, cam),
            "final_t": final_t, "evaluated": evaluated, "kept": kept}


def composite_grads(prep: dict, pairs: Pairs, cam: Camera, bg: torch.Tensor,
                    d_image: torch.Tensor, d_depth: torch.Tensor | None = None,
                    budget: int = 1 << 24) -> dict:
    """Exact gradients of <image, d_image> + <depth, d_depth> with respect to
    each Gaussian's pixel position, conic, opacity, colour and inverse depth
    (autograd through the walk, one tile block at a time)."""
    n = len(prep["xy"])
    dev = prep["xy"].device
    d_tiles = _to_tiles(d_image, cam)
    d_bg = (d_tiles * bg).sum(-1)
    d_inv = (_to_tiles(d_depth, cam) if d_depth is not None
             else torch.zeros_like(d_bg))
    out = [torch.zeros((n, 2), device=dev), torch.zeros((n, 3), device=dev),
           torch.zeros(n, device=dev), torch.zeros((n, 3), device=dev),
           torch.zeros(n, device=dev)]
    for tiles, depth in _blocks(pairs, budget):
        gid, valid, per_pair = _gather(prep, pairs, tiles, depth)
        leaves = [x.detach().requires_grad_(True) for x in per_pair]
        px, py = _pixel_centres(tiles, cam)
        with torch.enable_grad():
            c, d, t, _, _ = _composite_block(*leaves, valid, px, py)
            total = ((c * d_tiles[tiles]).sum() + (d * d_inv[tiles]).sum()
                     + (t * d_bg[tiles]).sum())
            grads = torch.autograd.grad(total, leaves)
        for acc, gr in zip(out, grads):
            gr = torch.where(valid.reshape(valid.shape + (1,) * (gr.dim() - 2)), gr, 0.0)
            acc.index_add_(0, gid.reshape(-1), gr.reshape((-1,) + acc.shape[1:]))
    return dict(zip(("xy", "conic", "opacity", "rgb", "inv_depth"), out))


def _window(device) -> torch.Tensor:
    x = torch.arange(11, dtype=torch.float32, device=device) - 5
    g = torch.exp(-(x * x) / (2.0 * 1.5 * 1.5))
    return g / g.sum()


def _blur(img: torch.Tensor) -> torch.Tensor:
    """Separable 11x11 Gaussian filter of (H, W, C), zero padding."""
    win = _window(img.device)
    ch = img.shape[-1]
    x = img.permute(2, 0, 1)[None]
    x = F.conv2d(x, win.reshape(1, 1, 11, 1).expand(ch, 1, 11, 1),
                 padding=(5, 0), groups=ch)
    x = F.conv2d(x, win.reshape(1, 1, 1, 11).expand(ch, 1, 1, 11),
                 padding=(0, 5), groups=ch)
    return x[0].permute(1, 2, 0)


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    mx, my = _blur(x), _blur(y)
    sxx = _blur(x * x) - mx * mx
    syy = _blur(y * y) - my * my
    sxy = _blur(x * y) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return torch.mean((2 * mx * my + c1) * (2 * sxy + c2)
                      / ((mx * mx + my * my + c1) * (sxx + syy + c2)))


def loss(image: torch.Tensor, target: torch.Tensor,
         lambda_dssim: float) -> torch.Tensor:
    diff = image - target
    l1 = torch.mean(torch.where(diff >= 0.0, diff, -diff))
    if lambda_dssim == 0.0:
        return l1
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim(image, target))


def preprocess_grads(p: dict, cam: Camera, prep: dict, g: dict,
                     degree: int = 3, scale_modifier: float = 1.0) -> dict:
    """The reference rasterizer's backward of the preprocess: from the
    per-Gaussian gradients ``g`` of ``composite_grads`` to the render-space
    positions, scales, rotations and SH (opacity passes through).  A culled
    Gaussian gets no gradient, as the reference rasterizer skips it: its
    terms are dropped, not multiplied by nought, since at a view-space depth
    near nought they overflow."""
    means = p["positions"]
    vis = prep["visible"][:, None]
    with torch.enable_grad():
        m = means.detach().requires_grad_(True)
        shs = p["shs"].detach().requires_grad_(True)
        offset = m - cam.campos
        norm = offset.norm(dim=-1, keepdim=True)
        rgb = eval_sh(shs, offset / torch.clamp(norm, min=1e-12), degree)
        tz = (_homogeneous(m) @ cam.view)[:, 2]
        inv_tz = 1.0 / torch.where(tz == 0.0, 1.0, tz)
        d_rgb = g["rgb"] * (1.0 - prep["clamped"])
        total = ((_pixel(m, cam) * g["xy"]).sum() + (rgb * d_rgb).sum()
                 + (inv_tz * g["inv_depth"]).sum())
        d_mean, d_sh = torch.autograd.grad(total, (m, shs))
    d_sh = torch.where((vis & (norm.detach() >= 1e-8))[:, :, None], d_sh, 0.0)

    # EWA covariance, as the reference rasterizer differentiates it
    t, tx, ty, jac, inside = _jacobian(means, cam)
    tz = t[:, 2]
    w3 = cam.view[:3, :3]
    tb = w3 @ jac.transpose(1, 2)                                 # W J^T (3, 2)
    cov = tb.transpose(1, 2) @ prep["sigma"] @ tb
    a, b, c = cov[:, 0, 0] + 0.3, cov[:, 0, 1], cov[:, 1, 1] + 0.3
    det = a * c - b * b
    inv2 = torch.where(det != 0.0, 1.0 / (det * det + 1e-7), 0.0)
    ga, gb, gc = g["conic"].unbind(-1)
    gb = 0.5 * gb                     # the conic's off-diagonal counted once
    da = inv2 * (-c * c * ga + 2 * b * c * gb + (det - a * c) * gc)
    dc = inv2 * (-a * a * gc + 2 * a * b * gb + (det - a * c) * ga)
    db = inv2 * 2 * (b * c * ga - (det + 2 * b * b) * gb + a * b * gc)
    adj = torch.stack([da, 0.5 * db, 0.5 * db, dc], -1).reshape(-1, 2, 2)
    d_sigma = tb @ adj @ tb.transpose(1, 2)
    d_jac = (w3.T @ (2.0 * prep["sigma"] @ tb @ adj)).transpose(1, 2)
    fx = cam.width / (2.0 * cam.tan_fovx)
    fy = cam.height / (2.0 * cam.tan_fovy)
    tz2, tz3 = tz * tz, tz * tz * tz
    d_t = torch.stack([
        -fx / tz2 * d_jac[:, 0, 2] * inside[0],
        -fy / tz2 * d_jac[:, 1, 2] * inside[1],
        -fx / tz2 * d_jac[:, 0, 0] - fy / tz2 * d_jac[:, 1, 1]
        + 2 * fx * tx / tz3 * d_jac[:, 0, 2] + 2 * fy * ty / tz3 * d_jac[:, 1, 2]], -1)
    d_mean = torch.where(vis, d_mean + d_t @ cam.view[:3, :3].T, 0.0)

    # covariance from scale and rotation, as (S R)^T (S R) is differentiated
    q = p["rotations"]
    rot = quat_to_rotmat(q)
    s = scale_modifier * p["scales"]
    d_m = 2.0 * s[:, :, None] * (rot @ d_sigma)
    d_scale = (rot * d_m).sum(1) * scale_modifier
    mm = s[:, :, None] * d_m.transpose(1, 2)
    x, y, z, r = q.unbind(-1)
    e = [[mm[:, i, j] for j in range(3)] for i in range(3)]
    d_rot = torch.stack([
        2 * (y * (e[1][0] + e[0][1]) + z * (e[2][0] + e[0][2]) + r * (e[1][2] - e[2][1]))
        - 4 * x * (e[2][2] + e[1][1]),
        2 * (x * (e[1][0] + e[0][1]) + r * (e[2][0] - e[0][2]) + z * (e[1][2] + e[2][1]))
        - 4 * y * (e[2][2] + e[0][0]),
        2 * (r * (e[0][1] - e[1][0]) + x * (e[2][0] + e[0][2]) + y * (e[1][2] + e[2][1]))
        - 4 * z * (e[1][1] + e[0][0]),
        2 * (z * (e[0][1] - e[1][0]) + y * (e[2][0] - e[0][2]) + x * (e[1][2] - e[2][1])),
    ], -1)
    return {"positions": d_mean, "scales": torch.where(vis, d_scale, 0.0),
            "rotations": torch.where(vis, d_rot, 0.0),
            "opacities": g["opacity"], "shs": d_sh}


def render(stored: dict, cam: Camera, bg: torch.Tensor, tight: bool,
           cull: bool, degree: int = 3) -> dict:
    """The forward of one view from stored (activated) parameters."""
    prep = preprocess(activate(stored), cam, degree, tight=tight)
    pairs = bin_pairs(prep, cam, cull=cull)
    out = composite(prep, pairs, cam, bg)
    out.update(num_pairs=pairs.num_pairs, num_kept=pairs.num_kept,
               tile_count=pairs.tile_count)
    return out


def loss_and_grads(stored: dict, cam: Camera, bg: torch.Tensor,
                   target: torch.Tensor, lambda_dssim: float,
                   degree: int = 3) -> tuple[float, dict, dict]:
    """One training view: the loss, its gradient with respect to every
    stored group (log scales and opacity logits through their
    activations), and the forward's counts."""
    p = activate(stored)
    prep = preprocess(p, cam, degree, tight=True)
    pairs = bin_pairs(prep, cam, cull=True)
    fwd = composite(prep, pairs, cam, bg)
    with torch.enable_grad():
        image = fwd["image"].detach().requires_grad_(True)
        value = loss(image, target, lambda_dssim)
        d_image, = torch.autograd.grad(value, image)
    g = composite_grads(prep, pairs, cam, bg, d_image)
    grads = preprocess_grads(p, cam, prep, g, degree)
    grads["scales"] = grads["scales"] * p["scales"]
    grads["opacities"] = grads["opacities"] * p["opacities"] * (1.0 - p["opacities"])
    counts = {"num_pairs": pairs.num_pairs, "num_kept": pairs.num_kept,
              "evaluated": fwd["evaluated"], "kept": fwd["kept"]}
    return float(value.detach()), grads, counts


def exp_lr(lr: float, final_factor: float, iteration: int, total: int) -> float:
    """Exponential decay in float32, as the optimizer schedules it."""
    if total <= 1:
        return float(torch.tensor(lr, dtype=torch.float32))
    f32 = torch.float32
    progress = torch.clamp(torch.tensor(iteration, dtype=torch.int32)
                           / (total - 1), max=1.0)
    return float(torch.tensor(lr, dtype=f32)
                 * torch.tensor(final_factor, dtype=f32) ** progress)


def adam(stored: dict, grads: dict, m: dict, v: dict, lrs: dict,
         iteration: int, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> tuple[dict, dict, dict]:
    """One Adam step of every group; quaternions renormalized after it."""
    t = torch.tensor(iteration + 1, dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
    bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
    new_p, new_m, new_v = {}, {}, {}
    for k in GROUPS:
        new_m[k] = b1 * m[k] + (1.0 - b1) * grads[k]
        new_v[k] = b2 * v[k] + (1.0 - b2) * grads[k] * grads[k]
        new_p[k] = stored[k] - lrs[k] * (new_m[k] / bc1) / (
            torch.sqrt(new_v[k] / bc2) + eps)
    q = new_p["rotations"]
    length = q.norm(dim=-1, keepdim=True)
    new_p["rotations"] = torch.where(length > 0.0,
                                     q / torch.where(length == 0.0, 1.0, length), q)
    return new_p, new_m, new_v


def precision(tf32: bool) -> None:
    """TF32 in matrix products and convolutions: off for the reference,
    on for its control."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
