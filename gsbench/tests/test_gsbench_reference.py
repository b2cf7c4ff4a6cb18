"""The plain reference against the port's CPU path at a tiny size, and a
lower-precision run that the comparison fails."""

import json
import types

import pytest
import torch

from conftest import DATA
from harness import base, manifest
from reference import splat

scene = manifest.module("scenes", "surfaces")
CFG = json.loads((DATA / "gsbench/configs/tiny.json").read_text())
LIMITS = manifest.limits("tiny-train", DATA)
VIEW_LIMITS = manifest.limits("tiny-view", DATA)


def _view(seed, index):
    cams = scene.cameras(CFG)
    train, _ = scene.split(CFG)
    return base.camera(cams[train[index]], CFG, torch.device("cpu"))


@pytest.mark.parametrize("seed", [5, 2**31 + 7])
def test_loss_and_gradients_match_the_port(seed):
    from gstpu_torch.config import GSConfig
    from gstpu_torch.models.gaussians import GaussianModel
    from gstpu_torch.trainer import loss_and_grads, train_settings

    stored = scene.make_cloud(CFG, seed, torch.device("cpu"))
    target = scene.targets(CFG, seed, 1, torch.device("cpu"))[0]
    cam = _view(seed, 3)
    n = len(stored["positions"])
    model = GaussianModel(**stored, alive=torch.ones(n, dtype=torch.bool),
                          n_alive=torch.tensor(n))
    gs = GSConfig(parameterization="activated", lambda_dssim=0.2)
    settings = train_settings(gs, CFG["width"], CFG["height"], 1 << 16, 1 << 16)
    loss, grads, aux = loss_and_grads(settings, gs, model, cam.view, cam.proj, cam.campos,
                                      cam.tan_fovx, cam.tan_fovy, target)
    r_loss, r_grads, r_counts = splat.loss_and_grads(stored, cam, torch.zeros(3), target, 0.2)
    assert r_loss == pytest.approx(float(loss), rel=1e-5)
    assert (int(aux.num_pairs), int(aux.num_kept)) == (r_counts["num_pairs"],
                                                       r_counts["num_kept"])
    for k, g in grads.items():
        assert float((g - r_grads[k]).abs().max()) <= 1e-4 * float(g.abs().max()), k


def test_image_matches_the_port():
    from gstpu_torch.render import render_gaussians

    stored = scene.make_cloud(CFG, 9, torch.device("cpu"))
    p = splat.activate(stored)
    cam = _view(9, 1)
    image, depth, aux = render_gaussians(
        torch.zeros(3), p["positions"], opacity=p["opacities"], scales=p["scales"],
        rotations=p["rotations"], sh=p["shs"], viewmatrix=cam.view, projmatrix=cam.proj,
        campos=cam.campos, tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy,
        image_height=CFG["height"], image_width=CFG["width"], device="cpu")
    ref = splat.render(stored, cam, torch.zeros(3), tight=False, cull=False)
    assert int(aux.num_pairs) == ref["num_pairs"]
    assert float((image - ref["image"]).abs().mean()) < 1e-6
    assert float((depth - ref["depth"]).abs().max()) < 1e-5


def _bf16(stored):
    return {k: v.to(torch.bfloat16).float() for k, v in stored.items()}


def test_lower_precision_fails_the_comparison():
    """The reference with its geometry rounded to bfloat16 (the CPU has no
    TF32) in the program's place: the training comparison and the view
    comparison both fail."""
    train = manifest.module("drivers", "train").Driver
    run = train.__new__(train)
    run.cfg, run.seed, run.device, run.scene = CFG, 11, torch.device("cpu"), scene
    run.traffic = json.loads((DATA / "gsbench/traffic/train-late.json").read_text())
    run.cams = [scene.cameras(CFG)[i] for i in scene.split(CFG)[0]]
    run.compared_views = [0, 3, 5]
    want = run.reference_readings(None)
    run.scene = types.SimpleNamespace(make_cloud=lambda *a: _bf16(scene.make_cloud(*a)),
                                      targets=scene.targets)
    low = run.reference_readings(None)
    numbers = run.compare(low, want)
    assert any(numbers[k] > LIMITS[k] for k in numbers), numbers

    stored = scene.make_cloud(CFG, 11, torch.device("cpu"))
    cam = _view(11, 2)
    a = splat.render(stored, cam, torch.zeros(3), tight=False, cull=False)
    b = splat.render(_bf16(stored), cam, torch.zeros(3), tight=False, cull=False)
    view = manifest.module("drivers", "view").Driver.compare(None, {0: (b["image"], b["depth"], b["num_pairs"])},
                                {0: (a["image"], a["depth"], a["num_pairs"])})
    assert any(view[k] > VIEW_LIMITS[k] for k in view), view


def test_a_culled_gaussian_in_the_cameras_plane_gets_no_gradient():
    """A Gaussian at view-space depth nought is culled; its projection
    terms overflow there, and the reference drops them rather than
    multiplying them by nought: its gradient is zero, and the others' are
    those of the same cloud with it culled behind the camera."""
    stored = scene.make_cloud(CFG, 4, torch.device("cpu"))
    cam = _view(4, 0)
    target = scene.targets(CFG, 4, 1, torch.device("cpu"))[0]
    inv = torch.linalg.inv(cam.view.double())

    def grads_with_first_at(view_point):
        stored["positions"][0] = (torch.tensor(view_point + [1.0], dtype=torch.float64)
                                  @ inv)[:3].float()
        return splat.loss_and_grads(stored, cam, torch.zeros(3), target, 0.2)[1]
    behind = grads_with_first_at([0.0, 0.0, -1.0])
    in_plane = grads_with_first_at([2.0, 0.0, 0.0])
    depth = (torch.cat([stored["positions"][:1], torch.ones(1, 1)], 1) @ cam.view)[0, 2]
    assert float(depth) == pytest.approx(0.0, abs=1e-6)
    for k, g in in_plane.items():
        assert torch.isfinite(g).all(), k
        assert float(g[0].abs().max()) == 0.0, k
        assert torch.equal(g[1:], behind[k][1:]), k
