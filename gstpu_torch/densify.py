"""Adaptive densification: clone, split and prune under a fixed capacity.

Port of ``gstpu/densify.py``.  The reference's mask → scan → readback →
realloc → scatter sequence is a set of masked scatters into the model's
fixed-capacity arrays.  Appends past the capacity are dropped and counted in
``DensifyStats.overflow``; the trainer then grows the capacity and runs the
event again on the model it started from.

Every function returns a new model and leaves its input untouched (the
trainer re-runs an event on its input after an overflow, and a rollback
snapshot may share its tensors).

Reference behaviors kept:

- Q4: the thresholds use the position gradients of the current step, not
  an accumulated average;
- Q5: a topology change resets the Adam moments; the caller does this when
  ``stats.changed``;
- Q6: the raw scheme's opacity reset sets every live opacity to the value;
- Q14: freshly cloned Gaussians have zero gradient, so they never split in
  the same event;
- Q16 (``config.q16_last_index``): the reference's exclusive-scan sizing,
  which drops the last element of each step.

Split children: 2 per original, scales x 0.8, position jitter
U(-0.01, 0.01); clone noise U(0, 0.01); the originals of splits are removed.
The noise comes from a ``torch.Generator``, so it differs from the JAX
package's draws; the hooks ``clone_position_noise`` and
``split_position_jitter`` let a test pin both packages to one function.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gstpu_torch.config import GSConfig
from gstpu_torch.models.gaussians import GaussianModel, inverse_sigmoid
from gstpu_torch.ops.math3d import quat_to_rotmat

_FIELDS = ("positions", "scales", "rotations", "opacities", "shs", "alive",
           "n_alive")


class DensifyStats(NamedTuple):
    changed: torch.Tensor    # () bool: topology changed (reset Adam state)
    n_cloned: torch.Tensor   # () int32
    n_split: torch.Tensor    # () int32
    n_pruned: torch.Tensor   # () int32
    overflow: torch.Tensor   # () int32: appends dropped for lack of capacity
    n_alive: torch.Tensor    # () int32 after the event


def clone_position_noise(generator: torch.Generator, n: int,
                         scale: float) -> torch.Tensor:
    """(n, 3) noise added to cloned positions: U(0, scale).

    Row i is the noise of source index i (``_append_masked`` writes row i
    to clone(i)); the reference keys its clone noise by source index."""
    return torch.rand((n, 3), generator=generator, dtype=torch.float32,
                      device=generator.device) * scale


def split_position_jitter(generator: torch.Generator,
                          target_idx: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """(n, 3) jitter of split children: U(-scale, scale).

    ``target_idx[i]`` is child i's slot after the append, the index the
    reference keys its split jitter by."""
    u = torch.rand((target_idx.shape[0], 3), generator=generator,
                   dtype=torch.float32, device=generator.device)
    return (u * 2.0 - 1.0) * scale


def _append_masked(model: GaussianModel, mask: torch.Tensor, make_new,
                   n_copies: int, generator: torch.Generator):
    """Append ``n_copies`` derived Gaussians for every masked entry.

    ``make_new(params_of_source, copy_index, generator, target)`` returns
    the derived parameter dict (``target[i]``: the destination slot of
    source i's copy, ``capacity`` where it has none).  Returns (model,
    n_appended, overflow).
    """
    cap = model.capacity
    cum = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    total = cum[-1]
    base = model.n_alive + (cum - 1) * n_copies
    new = {k: v.clone() for k, v in model.param_dict().items()}
    alive = model.alive.clone()
    for c in range(n_copies):
        target = torch.where(mask, base + c, cap)
        derived = make_new(model.param_dict(), c, generator, target)
        # the JAX scatter drops writes at or past the capacity (the
        # unmasked sentinel and the overflow); torch's would raise
        keep = target < cap
        rows = target[keep].long()
        for k, val in derived.items():
            new[k].index_put_((rows,), val[keep])
        alive.index_put_((rows,), torch.ones_like(rows, dtype=torch.bool))
    want = total * n_copies
    # written: the entries with base + c < cap
    appended = torch.sum(torch.where(mask, torch.clip(cap - base, 0, n_copies),
                                     0), dtype=torch.int32)
    out = model.replace(**new, alive=alive, n_alive=model.n_alive + appended)
    return out, appended, want - appended


def compact(model: GaussianModel) -> GaussianModel:
    """Stable-compact the live Gaussians to the front."""
    order = torch.argsort(torch.logical_not(model.alive).to(torch.int32),
                          stable=True)
    n_alive = torch.sum(model.alive, dtype=torch.int32)
    return model.replace(
        **{k: v[order] for k, v in model.param_dict().items()},
        alive=model.alive[order], n_alive=n_alive)


def densify_and_prune(model: GaussianModel, pos_grads: torch.Tensor,
                      scene_extent: float, config: GSConfig,
                      generator: torch.Generator):
    """One densification event: clone, split, then prune.  Returns (model,
    DensifyStats); the counts stay on the device."""
    cap = model.capacity
    dev = model.positions.device
    activated = config.parameterization == "activated"
    grad_norms = torch.sqrt(torch.sum(pos_grads * pos_grads, -1)) \
        * model.alive
    # the thresholds compare render-space scales and opacities
    real_scales = torch.exp(model.scales) if activated else model.scales
    max_scale = torch.amax(real_scales, -1)
    scale_thresh = config.percent_dense * scene_extent
    high_grad = grad_norms >= config.densify_grad_threshold

    # step 1: clone small Gaussians
    clone_mask = model.alive & high_grad & (max_scale <= scale_thresh)
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    if config.q16_last_index:
        # Q16: the last pre-clone element never clones
        clone_mask = clone_mask & (idx != model.n_alive - 1)

    def make_clone(p, _c, gen, _target):
        noise = clone_position_noise(gen, p["positions"].shape[0],
                                     config.clone_noise_scale)
        return {**p, "positions": p["positions"] + noise}

    model1, n_cloned, ovf1 = _append_masked(model, clone_mask, make_clone, 1,
                                            generator)

    # step 2: split large Gaussians.  Q14: clones have zero gradient, so the
    # split mask is the pre-clone one over the originals.
    split_mask = model.alive & high_grad & (max_scale > scale_thresh)

    def make_child(p, _c, gen, target):
        if config.official_split_sampling:
            # official 3DGS: each child sampled from the parent's Gaussian,
            # scales divided by 0.8 * split_n
            real_s = torch.exp(p["scales"]) if activated else p["scales"]
            eps = torch.randn(p["positions"].shape, generator=gen,
                              dtype=torch.float32, device=gen.device)
            rot = quat_to_rotmat(p["rotations"])
            jitter = torch.einsum("nij,nj->ni", rot, eps * real_s)
            factor = 1.0 / (0.8 * config.split_n)
            if activated:
                child_scales = p["scales"] + torch.log(
                    torch.tensor(factor, dtype=torch.float32, device=dev))
            else:
                child_scales = p["scales"] * factor
        else:
            jitter = split_position_jitter(gen, target,
                                           config.clone_noise_scale)
            if activated:  # x factor in render space is + log in logs
                child_scales = p["scales"] + torch.log(torch.tensor(
                    config.split_scale_factor, dtype=torch.float32,
                    device=dev))
            else:
                child_scales = p["scales"] * config.split_scale_factor
        return {**p, "positions": p["positions"] + jitter,
                "scales": child_scales}

    if config.q16_last_index:
        # Q16: the split count excludes the post-clone array's last mask
        # bit; with nothing left the whole split block is skipped.
        # Otherwise a split-masked last element gets no children but is
        # removed, and the last appended child is dropped.
        last1 = model1.n_alive - 1
        eff = torch.sum(split_mask, dtype=torch.int32) \
            - split_mask[last1].to(torch.int32)
        do_split = eff > 0
        child_src = split_mask & (idx != last1) & do_split
        remove_mask = split_mask & do_split
        model2, n_children, ovf2 = _append_masked(
            model1, child_src, make_child, config.split_n, generator)
        last_child = model1.n_alive + config.split_n * eff - 1
        drop_last_child = do_split & (n_children > 0)
        model2 = model2.replace(
            alive=model2.alive & torch.logical_not(remove_mask)
            & ((idx != last_child) | ~drop_last_child),
            n_alive=model2.n_alive - drop_last_child.to(torch.int32))
        n_children = n_children - drop_last_child.to(torch.int32)
    else:
        model2, n_children, ovf2 = _append_masked(
            model1, split_mask, make_child, config.split_n, generator)
        model2 = model2.replace(
            alive=model2.alive & torch.logical_not(split_mask))
    model2 = compact(model2)

    # step 3: prune by opacity, with the reference's guards
    real_opac = (torch.sigmoid(model2.opacities) if activated
                 else model2.opacities)
    keep = model2.alive & (real_opac > config.cull_opacity_threshold)
    valid_count = torch.sum(keep, dtype=torch.int32)
    num_points = model2.n_alive
    if config.q16_last_index:
        # Q16: the guards see a count without the last element's keep bit,
        # and an engaged prune always drops the last surviving Gaussian
        valid_count = valid_count \
            - keep[model2.n_alive - 1].to(torch.int32)
        keep = keep & (idx != model2.n_alive - 1)
    prune_count = num_points - valid_count
    prune_ratio = prune_count.to(torch.float32) / torch.clamp(
        num_points.to(torch.float32), min=1.0)
    do_prune = ((valid_count >= config.min_valid_points)
                & (valid_count <= config.max_valid_points)
                & (prune_ratio <= config.max_allowed_prune_ratio)
                & (valid_count < num_points))
    pruned = compact(model2.replace(alive=keep))

    def select(a, b):
        return torch.where(do_prune.reshape((1,) * a.dim()), a, b)

    model3 = model2.replace(**{k: select(getattr(pruned, k),
                                         getattr(model2, k))
                               for k in _FIELDS})
    n_pruned = torch.where(do_prune, prune_count, 0)

    changed = (n_cloned > 0) | (n_children > 0) | (n_pruned > 0)
    stats = DensifyStats(changed=changed, n_cloned=n_cloned,
                         n_split=n_children, n_pruned=n_pruned,
                         overflow=ovf1 + ovf2, n_alive=model3.n_alive)
    return model3, stats


def reset_opacities(model: GaussianModel, value: float,
                    parameterization: str = "raw") -> GaussianModel:
    """Opacity reset.  Raw scheme: every live opacity set to ``value``
    (Q6).  Activated scheme: official 3DGS, min(opacity, value) in render
    space, stored as a logit."""
    v = torch.tensor(value, dtype=torch.float32,
                     device=model.opacities.device)
    if parameterization == "activated":
        new = inverse_sigmoid(torch.minimum(torch.sigmoid(model.opacities),
                                            v))
    else:
        new = v
    return model.replace(
        opacities=torch.where(model.alive, new, model.opacities))


def should_reset_opacity(config: GSConfig, iteration: int) -> bool:
    """The opacity-reset trigger.

    The reference's ``0 % 3000 == 0`` also fires at iteration 0, kept for
    the raw scheme; the activated scheme skips it (it would wipe the 0.1
    init before any learning)."""
    white = all(c == 1.0 for c in config.background_color)
    if iteration == 0 and config.parameterization == "activated":
        return False
    if (config.opacity_reset_until_iter is not None
            and iteration >= config.opacity_reset_until_iter):
        return False
    return (iteration % config.opacity_reset_interval == 0
            or (white and iteration == config.densify_from_iter))
