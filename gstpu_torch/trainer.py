"""One single-device training step, and the capacity sizing it relies on.

Port of ``gstpu/trainer.py::Trainer._train_step`` (with ``_round_capacity``
and ``_settings``): activate the stored parameters, render through the
differentiable ``render``, take the loss, back-propagate through the
hand-written backward (kernel K2 on the card), then one Adam step with the
scheduled learning rates.  The training loop (flush, rollback, densify, eval
and I/O) is not ported yet.
"""

from __future__ import annotations

import torch

from gstpu_torch.config import GSConfig, RenderSettings
from gstpu_torch.models.gaussians import GaussianModel, activate_params
from gstpu_torch.ops.losses import combined_loss, depth_loss
from gstpu_torch.ops.rasterize import render
from gstpu_torch.optim import AdamState, adam_step, schedule_lrs


def round_capacity(pairs: float) -> int:
    """Pair capacity: the requested pairs rounded up to a multiple of 32768,
    at least 16384 (every capacity-sized stage pays for the slack)."""
    return max(-(-int(pairs) // 32768) * 32768, 1 << 14)


def train_settings(config: GSConfig, width: int, height: int,
                   pair_capacity: int, kept_capacity: int,
                   iteration: int | None = None,
                   pair_cull: bool = True) -> RenderSettings:
    """Render settings of a training step: tight radii, the exact pair cull
    and the two-tier kept capacity, with the SH degree warm-up when
    ``config.sh_degree_interval`` is set."""
    degree = config.sh_degree
    if config.sh_degree_interval and iteration is not None:
        degree = min(config.sh_degree, iteration // config.sh_degree_interval)
    return RenderSettings(width=width, height=height, sh_degree=degree,
                          pair_capacity=pair_capacity, tight_radius=True,
                          pair_cull=pair_cull,
                          kept_capacity=min(kept_capacity, pair_capacity))


def loss_and_grads(settings: RenderSettings, config: GSConfig,
                   model: GaussianModel, view: torch.Tensor,
                   proj: torch.Tensor, campos: torch.Tensor, tan_fovx: float,
                   tan_fovy: float, target: torch.Tensor,
                   target_depth: torch.Tensor | None = None,
                   depth_mask: torch.Tensor | None = None,
                   _compositing=None):
    """The loss of one view and its gradient with respect to every stored
    parameter group: ``(loss, {group: gradient}, RenderAux)``.

    The loss is ``combined_loss`` plus ``lambda_depth * depth_loss`` when a
    depth target is given.  ``_compositing`` is passed on to ``render``
    (for checks of the kernels against their plain versions).
    """
    bg = torch.tensor(config.background_color, dtype=torch.float32,
                      device=target.device)
    params = {k: x.detach().requires_grad_(True)
              for k, x in model.param_dict().items()}
    p = activate_params(params, config.parameterization)
    image, depth, aux = render(
        settings, tan_fovx, tan_fovy, config.scale_modifier, p["positions"],
        p["scales"], p["rotations"], p["opacities"], p["shs"], view, proj,
        campos, bg, model.alive, 0, _compositing=_compositing)
    loss = combined_loss(image, target, config.lambda_dssim)
    if target_depth is not None:
        loss = loss + config.lambda_depth * depth_loss(
            depth, config.depth_scale * target_depth, depth_mask)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads)), aux


def train_step(settings: RenderSettings, config: GSConfig,
               model: GaussianModel, adam: AdamState, view: torch.Tensor,
               proj: torch.Tensor, campos: torch.Tensor, tan_fovx: float,
               tan_fovy: float, target: torch.Tensor, iteration: int,
               target_depth: torch.Tensor | None = None,
               depth_mask: torch.Tensor | None = None):
    """One step: render, loss, backward, Adam (``loss_and_grads``, then
    ``adam_step`` with the scheduled learning rates).

    Returns ``(model, adam, loss, grad_positions, counts, iteration + 1)``
    as the JAX step does: ``counts`` is the (2,) int32 tensor (num_pairs,
    num_kept) that the caller holds against ``settings.pair_capacity`` and
    ``settings.kept_capacity`` (a step over either rendered a truncated pair
    list).  ``model`` and ``adam`` are not modified; new ones are returned.

    Float32 throughout: the step sets ``torch.backends.cudnn.allow_tf32 =
    False`` (cuDNN would otherwise run the SSIM convolutions in TF32) and
    keeps ``torch.backends.cuda.matmul.allow_tf32 = False``;
    reduced-precision geometry was found to stall SSIM training in the JAX
    package.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    loss, grads, aux = loss_and_grads(
        settings, config, model, view, proj, campos, tan_fovx, tan_fovy,
        target, target_depth=target_depth, depth_mask=depth_mask)
    new_params, new_adam = adam_step(
        model.param_dict(), grads, adam, schedule_lrs(config, iteration),
        iteration, config, alive=model.alive)
    counts = torch.stack([aux.num_pairs, aux.num_kept])
    return (model.replace(**new_params), new_adam, loss, grads["positions"],
            counts, iteration + 1)
