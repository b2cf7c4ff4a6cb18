"""Image losses: L1, SSIM, depth loss, PSNR, on torch tensors.

Port of ``gstpu/ops/losses.py``; images are (H, W, C) float32 as in the JAX
package.  Gradients come from autograd.

- L1 is the mean absolute error over pixels and channels; its pixel
  gradient is ``sign(r - t) * (1 - lambda) / (H*W*3)``.
- SSIM is the official 3DGS one: an 11x11 Gaussian window of sigma 1.5,
  applied as two depthwise 1-D convolutions with zero padding.  The
  convolutions go through cuDNN on the card, which runs float32 in TF32
  unless ``torch.backends.cudnn.allow_tf32`` is False; the package switches
  it off on import and the train step again before each step.
- ``ssim_map_chunks`` is the same SSIM over row chunks with 5-row halos
  (``_filter_chunks``: valid vertically, zero-padded horizontally), for the
  band-local SSIM of the sharded train step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SSIM_C1 = 0.01 ** 2
SSIM_C2 = 0.03 ** 2
SSIM_WINDOW = 11
SSIM_SIGMA = 1.5


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| whose derivative at 0 is +1, as JAX differentiates ``jnp.abs``
    (``torch.abs`` gives 0 there): pixels that equal their target still
    pass the L1 gradient on, as in the JAX package."""
    return torch.where(x >= 0.0, x, -x)


def l1_loss(rendered: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error over all pixels and channels."""
    return torch.mean(_abs(rendered - target))


def l1_pixel_gradients(rendered: torch.Tensor, target: torch.Tensor,
                       lambda_dssim: float = 0.0) -> torch.Tensor:
    """dL/dpixel of the (1 - lambda) * L1 term."""
    h, w = rendered.shape[0], rendered.shape[1]
    weight = (1.0 - lambda_dssim) / (h * w * 3.0)
    return weight * torch.sign(rendered - target)


def _gaussian_window(device, size: int = SSIM_WINDOW,
                     sigma: float = SSIM_SIGMA) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return g / torch.sum(g)


def _filter2d_separable(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Separable 2-D filter of an (H, W, C) image, 'same' zero padding:
    a vertical then a horizontal depthwise convolution."""
    k = window.shape[0]
    c = img.shape[-1]
    x = img.permute(2, 0, 1)[None]                       # (1, C, H, W)
    kv = window.reshape(1, 1, k, 1).expand(c, 1, k, 1)
    kh = window.reshape(1, 1, 1, k).expand(c, 1, 1, k)
    y = F.conv2d(x, kv, padding=(k // 2, 0), groups=c)
    y = F.conv2d(y, kh, padding=(0, k // 2), groups=c)
    return y[0].permute(1, 2, 0)


def _filter_chunks(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Separable filter of halo-extended row chunks (B, He, W, C): valid
    vertically (He -> He - (k - 1)), zero-padded horizontally.

    Equal to the full image's ``_filter2d_separable`` wherever the (k-1)/2
    halo rows hold the image's true neighbouring rows (zeros at its
    borders): the band-local SSIM of the sharded step, which exchanges
    5-row halos with its neighbours in place of gathering the image.
    """
    k = window.shape[0]
    c = x.shape[-1]
    y = x.permute(0, 3, 1, 2)                            # (B, C, He, W)
    kv = window.reshape(1, 1, k, 1).expand(c, 1, k, 1)
    kh = window.reshape(1, 1, 1, k).expand(c, 1, 1, k)
    y = F.conv2d(y, kv, groups=c)
    y = F.conv2d(y, kh, padding=(0, k // 2), groups=c)
    return y.permute(0, 2, 3, 1)


def ssim_map_chunks(img_ext: torch.Tensor,
                    tgt_ext: torch.Tensor) -> torch.Tensor:
    """Per-pixel SSIM of halo-extended chunks.

    ``img_ext``/``tgt_ext``: (B, rows + 2*5, W, 3), each chunk with 5 halo
    rows above and below (the true neighbouring rows, or zeros at the
    image's border).  Returns the (B, rows, W, 3) map of those rows of the
    full image's ``ssim`` formula.
    """
    win = _gaussian_window(img_ext.device)
    stack = torch.cat([img_ext, tgt_ext, img_ext * img_ext,
                       tgt_ext * tgt_ext, img_ext * tgt_ext], dim=-1)
    mu1, mu2, x2, y2, xy = torch.chunk(_filter_chunks(stack, win), 5, dim=-1)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1 = x2 - mu1_sq
    sigma2 = y2 - mu2_sq
    sigma12 = xy - mu12
    num = (2.0 * mu12 + SSIM_C1) * (2.0 * sigma12 + SSIM_C2)
    den = (mu1_sq + mu2_sq + SSIM_C1) * (sigma1 + sigma2 + SSIM_C2)
    return num / den


def ssim(rendered: torch.Tensor, target: torch.Tensor,
         clamp_sigma: bool = False) -> torch.Tensor:
    """SSIM of two (H, W, C) images, mean over pixels and channels.

    ``clamp_sigma`` floors the variance estimates at 0: at the zero-padded
    borders they can turn negative, and a near-zero denominator then pushes
    the ratio past 1.  Off for the loss (the official formula); evaluation
    metrics turn it on.
    """
    win = _gaussian_window(rendered.device)
    mu1 = _filter2d_separable(rendered, win)
    mu2 = _filter2d_separable(target, win)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1 = _filter2d_separable(rendered * rendered, win) - mu1_sq
    sigma2 = _filter2d_separable(target * target, win) - mu2_sq
    sigma12 = _filter2d_separable(rendered * target, win) - mu12
    if clamp_sigma:
        # torch.maximum, like jnp.maximum, splits the gradient at a tie
        zero = torch.zeros_like(sigma1)
        sigma1 = torch.maximum(sigma1, zero)
        sigma2 = torch.maximum(sigma2, zero)
    num = (2.0 * mu12 + SSIM_C1) * (2.0 * sigma12 + SSIM_C2)
    den = (mu1_sq + mu2_sq + SSIM_C1) * (sigma1 + sigma2 + SSIM_C2)
    return torch.mean(num / den)


def combined_loss(rendered: torch.Tensor, target: torch.Tensor,
                  lambda_dssim: float = 0.0) -> torch.Tensor:
    """(1 - lambda) * L1 + lambda * (1 - SSIM), the official 3DGS objective
    (plain L1 when lambda is 0)."""
    l1 = l1_loss(rendered, target)
    if lambda_dssim == 0.0:
        return l1
    return ((1.0 - lambda_dssim) * l1
            + lambda_dssim * (1.0 - ssim(rendered, target)))


def depth_loss(rendered_inv_depth: torch.Tensor,
               target_inv_depth: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Masked L1 on inverse depth, averaged over all pixels."""
    diff = _abs(rendered_inv_depth - target_inv_depth) * mask
    h, w = rendered_inv_depth.shape[0], rendered_inv_depth.shape[1]
    return torch.sum(diff) / (h * w)


def psnr(rendered: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """PSNR in dB of [0, 1] images."""
    mse = torch.mean((rendered - target) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))

