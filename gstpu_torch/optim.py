"""Adam with per-group learning rates and the reference's projections.

Port of ``gstpu/optim.py`` as plain functions on tensors (not
``torch.optim.Adam``), so the rounding and the state layout follow the JAX
package: the moments are dicts keyed like the parameters, which densify
indexes later.

- bias correction at ``iteration + 1``;
- per-group exponential learning-rate decay (``exp_lr``, ``schedule_lrs``);
- the raw parameterization clamps scales at 0.001 and opacities to [0, 1]
  after the step;
- quaternions are renormalized after the step, with a guard for zero length;
- ``alive`` keeps padding slots, their moments included, unchanged.

The learning rates and bias corrections are float32 scalars computed on the
host, as the JAX package computes them in float32 on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import torch

from gstpu_torch.config import GSConfig


@dataclasses.dataclass
class AdamState:
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


class LRs(NamedTuple):
    positions: float
    scales: float
    rotations: float
    opacities: float
    shs: float


def init_adam_state(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(m={k: torch.zeros_like(x) for k, x in params.items()},
                     v={k: torch.zeros_like(x) for k, x in params.items()})


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def exp_lr(initial_lr: float, final_lr_factor: float, iteration: int,
           total_iterations: int) -> float:
    """Exponential decay from ``initial_lr`` to ``initial_lr *
    final_lr_factor`` over ``total_iterations``, in float32."""
    if total_iterations <= 1:
        return float(_f32(initial_lr))
    progress = torch.clamp(
        torch.tensor(iteration, dtype=torch.int32) / (total_iterations - 1),
        max=1.0)
    return float(_f32(initial_lr) * _f32(final_lr_factor) ** progress)


def schedule_lrs(config: GSConfig, iteration: int) -> LRs:
    """Per-group learning rates at ``iteration``."""
    if not config.use_lr_scheduler:
        return LRs(*(float(_f32(x)) for x in (
            config.lr_pos, config.lr_scale, config.lr_rot, config.lr_opac,
            config.lr_sh)))
    total = config.num_iterations
    f = config.final_lr_factor
    return LRs(
        positions=exp_lr(config.lr_pos, f, iteration, total),
        scales=exp_lr(config.lr_scale, f, iteration, total),
        rotations=exp_lr(config.lr_rot, f, iteration, total),
        opacities=(exp_lr(config.lr_opac, f, iteration, total)
                   if config.schedule_opac else float(_f32(config.lr_opac))),
        shs=exp_lr(config.lr_sh, f, iteration, total),
    )


def adam_step(params: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor], state: AdamState, lrs: LRs,
              iteration: int, config: GSConfig,
              alive: torch.Tensor | None = None):
    """One Adam step over all five parameter groups.

    Returns (new params, new AdamState); the inputs are not modified.
    ``alive`` masks the update (params and moments) of capacity-padding
    slots.
    """
    b1, b2, eps = config.adam_beta1, config.adam_beta2, config.adam_epsilon
    t = _f32(iteration + 1)
    bc1 = float(1.0 - _f32(b1) ** t)
    bc2 = float(1.0 - _f32(b2) ** t)

    new_p, new_m, new_v = {}, {}, {}
    for k in params:
        lr = getattr(lrs, k)
        g = grads[k]
        m = b1 * state.m[k] + (1.0 - b1) * g
        v = b2 * state.v[k] + (1.0 - b2) * g * g
        update = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        new_p[k], new_m[k], new_v[k] = params[k] - update, m, v

    if config.parameterization == "raw":
        # the raw scheme clamps the stored values
        new_p["scales"] = torch.clamp(new_p["scales"], min=0.001)
        new_p["opacities"] = torch.clamp(new_p["opacities"], 0.0, 1.0)
    q = new_p["rotations"]
    qlen = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    new_p["rotations"] = torch.where(
        qlen > 0.0, q / torch.where(qlen == 0.0, 1.0, qlen), q)

    if alive is not None:
        def keep(new, old):
            return torch.where(alive.reshape((-1,) + (1,) * (new.dim() - 1)),
                               new, old)
        new_p = {k: keep(new_p[k], params[k]) for k in params}
        new_m = {k: keep(new_m[k], state.m[k]) for k in params}
        new_v = {k: keep(new_v[k], state.v[k]) for k in params}
    return new_p, AdamState(m=new_m, v=new_v)
