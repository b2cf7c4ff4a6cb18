"""The port's Trainer and train CLI end to end on the CPU (``device="cpu"``).

Counterparts of ``tests/test_trainer.py`` on ``scripts/make_tiny_nerf.py``'s
dataset at 32x32: the loop with its flushes, densify events, checkpoints
and evals; resume; the eval render's capacity regrow; the SH warm-up; depth
supervision; the activated parameterization; the rollback and replay of an
overflowed window against a run with ample capacity (rtol 2e-4, as the JAX
test).  Then a COLMAP capture and ``python -m gstpu_torch.train`` with
``--resume``.  The loss curves against gstpu's Trainer are in
``tests/test_torch_trainer_vs_gstpu.py``.
"""

import json

import numpy as np
import pytest
import torch

from gstpu_torch import densify
from gstpu_torch import train as train_cli
from gstpu_torch.config import GSConfig
from gstpu_torch.data.nerf import NerfSyntheticDataset
from gstpu_torch.models.gaussians import activate_params, init_model
from gstpu_torch.ops.losses import depth_loss
from gstpu_torch.ops.rasterize import render
from gstpu_torch.trainer import Trainer
from scripts.make_tiny_nerf import make_dataset
from tests.test_colmap import N_POINTS, _make_mixed_focal_rig, _write_model


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these runs are many small ops, which gain
    nothing from more, and the suite runs several modules at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny_nerf")
    make_dataset(path, size=32, n_train=3, n_val=2)
    return path


def _config():
    return GSConfig(num_points=64, num_iterations=6, save_interval=5,
                    densify_from_iter=2, densification_interval=3,
                    min_valid_points=1)


def _metrics(out):
    return [json.loads(line) for line in open(out / "metrics.jsonl")]


def _losses(out):
    return [float(x) for x in open(out / "loss.txt")]


def _camera_tensors(cam):
    return tuple(torch.from_numpy(np.asarray(cam[k], np.float32))
                 for k in ("world_to_camera", "full_proj_matrix",
                           "camera_center"))


def test_train_loop_end_to_end(tiny_dataset, tmp_path):
    out = tmp_path / "out"
    trainer = Trainer(str(tiny_dataset), str(out),
                      _config().replace(eval_views=1), device="cpu")
    assert trainer.device.type == "cpu"
    trainer.train()

    losses = _losses(out)
    assert len(losses) == 6 and all(np.isfinite(losses))
    metrics = _metrics(out)
    evals = [m for m in metrics if m.get("event") == "eval"]
    assert evals and np.isfinite(evals[-1]["psnr"])
    assert all(m["views"] == 1 for m in evals)
    full = [m for m in metrics if m.get("event") == "eval_full"]
    assert full and full[-1]["views"] == 2
    assert [m["iteration"] for m in metrics
            if m.get("event") == "densify"] == [3]
    assert metrics[-1] == {"event": "done", "iteration": 6}
    ply = out / "point_cloud" / "iteration_5" / "point_cloud.ply"
    assert ply.exists() and ply.stat().st_size > 0
    assert (out / "cameras.json").exists()
    assert (out / "state" / "5.pt").exists()


def test_train_resume_continues(tiny_dataset, tmp_path):
    out = tmp_path / "out"
    t1 = Trainer(str(tiny_dataset), str(out), _config(), device="cpu")
    t1.train()

    t2 = Trainer(str(tiny_dataset), str(out),
                 _config().replace(num_iterations=9), device="cpu")
    t2.restore(5)
    assert t2.iteration == 6
    # the state saved at 5 is the model after step 5, the end of t1's run
    for k in ("positions", "scales", "opacities", "shs", "alive", "n_alive"):
        assert torch.equal(getattr(t2.model, k), getattr(t1.model, k)), k
    assert torch.equal(t2.generator.get_state(), t1.generator.get_state())
    assert t2.losses == t1.losses
    t2.train()
    assert t2.iteration == 9
    assert len(_losses(out)) == 9
    assert _metrics(out)[-1] == {"event": "done", "iteration": 9}


def test_eval_render_regrows_capacity(tiny_dataset, tmp_path):
    """A full-frame eval render finds its pair shortfall and regrows its
    own capacities instead of dropping tiles."""
    trainer = Trainer(str(tiny_dataset), str(tmp_path / "out"), _config(),
                      device="cpu")
    args = _camera_tensors(trainer.train_data.camera(0))
    ample, _, aux_full = trainer._render_full(trainer.model, *args)
    need = int(aux_full.num_pairs)
    assert need > 0

    # drop the 16k rounding floor, which would hide the overflow here
    trainer._round_capacity = lambda pairs: max(int(pairs), 8)
    cap = max(8, need // 4)
    trainer._pair_capacity = trainer._kept_capacity = cap
    trainer._eval_pair_capacity = trainer._eval_kept_capacity = cap
    img, _, aux = trainer._render_full(trainer.model, *args)
    assert int(aux.num_pairs) == need
    assert trainer._eval_pair_capacity >= need
    np.testing.assert_allclose(img.numpy(), ample.numpy(), rtol=0, atol=1e-6)


def test_sh_degree_warmup(tiny_dataset, tmp_path):
    trainer = Trainer(str(tiny_dataset), str(tmp_path / "o"),
                      _config().replace(sh_degree_interval=2), device="cpu")
    assert trainer._settings(0).sh_degree == 0
    assert trainer._settings(3).sh_degree == 1
    assert trainer._settings(99).sh_degree == 3
    assert trainer._settings(None).sh_degree == 3
    trainer.train()
    losses = _losses(tmp_path / "o")
    assert len(losses) == 6 and all(np.isfinite(losses))


def test_depth_supervision_trains(tiny_dataset, tmp_path):
    """The depth term reaches the positions, and a depth-supervised run ends
    with a lower depth error than the same run without it."""
    data = NerfSyntheticDataset(str(tiny_dataset), "train")
    assert data.has_depth
    cfg = _config().replace(num_iterations=30, lambda_depth=4.0,
                            densify_from_iter=10_000)

    def depth_l1(trainer):
        vals = []
        for i in range(len(data)):
            cam = data.camera(i)
            _, d, _ = trainer._render_eval(trainer._settings(), trainer.model,
                                           *_camera_tensors(cam))
            td, m = data.depth(i)
            vals.append(float(depth_loss(
                d, cfg.depth_scale * torch.from_numpy(td),
                torch.from_numpy(m))))
        return np.mean(vals)

    trainer = Trainer(str(tiny_dataset), str(tmp_path / "d"), cfg,
                      device="cpu")
    cam = data.camera(0)
    td, m = data.depth(0)
    model = trainer.model
    pos = model.positions.clone().requires_grad_(True)
    _, d, _ = render(trainer._settings(0), trainer.tan_fovx,
                     trainer.tan_fovy, 1.0, pos, model.scales,
                     model.rotations, model.opacities, model.shs,
                     *_camera_tensors(cam), torch.zeros(3), model.alive)
    (grad,) = torch.autograd.grad(depth_loss(d, torch.from_numpy(td),
                                             torch.from_numpy(m)), pos)
    assert float(torch.linalg.vector_norm(grad[model.alive])) > 1e-6

    trainer.train()
    t0 = Trainer(str(tiny_dataset), str(tmp_path / "d0"),
                 cfg.replace(lambda_depth=0.0), device="cpu")
    t0.train()
    sup, unsup = depth_l1(trainer), depth_l1(t0)
    assert sup < unsup, (sup, unsup)


def test_depth_requires_depth_files(tmp_path):
    path = tmp_path / "nodepth"
    make_dataset(path, size=32, n_train=2, n_val=1)
    for p in path.glob("*/*_depth_*.png"):
        p.unlink()
    with pytest.raises(FileNotFoundError):
        Trainer(str(path), str(tmp_path / "o"),
                _config().replace(lambda_depth=0.5), device="cpu")


def test_activated_parameterization_trains(tiny_dataset, tmp_path):
    cfg = _config().replace(parameterization="activated", lambda_dssim=0.2)
    m = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    act = activate_params(m.param_dict(), "activated")
    np.testing.assert_allclose(act["scales"].numpy(), 0.1, rtol=1e-5)
    np.testing.assert_allclose(act["opacities"].numpy(), 0.1, rtol=1e-5)
    m2 = densify.reset_opacities(m, 0.01, "activated")
    op2 = activate_params(m2.param_dict(), "activated")["opacities"]
    np.testing.assert_allclose(op2[0].item(), 0.01, rtol=1e-4)
    m3 = densify.reset_opacities(m2, 0.5, "activated")  # min: stays 0.01
    op3 = activate_params(m3.param_dict(), "activated")["opacities"]
    np.testing.assert_allclose(op3[0].item(), 0.01, rtol=1e-4)

    out = tmp_path / "act"
    trainer = Trainer(str(tiny_dataset), str(out), cfg, device="cpu")
    trainer.train()
    losses = _losses(out)
    assert len(losses) == cfg.num_iterations and all(np.isfinite(losses))
    alive = trainer.model.alive
    assert float(trainer.model.scales[alive].mean()) < 0.0


def test_overflow_rollback_replays_window(tiny_dataset, tmp_path):
    """An overflowed window rolls back to its snapshot and replays at a
    grown capacity; its losses equal those of a run with ample capacity
    from the start (same seeds, same cameras)."""
    cfg = _config().replace(num_points=1024, initial_scale=1.0,
                            pair_capacity_per_gaussian=1.0,
                            densify_from_iter=10_000)
    out = tmp_path / "small"
    tr = Trainer(str(tiny_dataset), str(out), cfg, device="cpu")
    # capacities in steps of 1,024 without the 16k floor, so 1,024 large
    # splats over the 2x2 tile grid (about 4,096 pairs) overflow 2,048
    tr._round_capacity = lambda pairs: max(-(-int(pairs) // 1024) * 1024,
                                           1024)
    tr._pair_capacity = tr._kept_capacity = tr._round_capacity(
        tr.model.capacity * cfg.pair_capacity_per_gaussian)
    assert tr._pair_capacity == 2048
    tr.train()
    metrics = _metrics(out)
    overflows = [m for m in metrics if m.get("event") == "pair_overflow"]
    assert overflows and all(m["rolled_back"] for m in overflows)
    grows = [m for m in metrics if m.get("event") == "pair_capacity_grow"]
    assert grows and grows[-1]["capacity"] > 2048

    out2 = tmp_path / "ample"
    tr2 = Trainer(str(tiny_dataset), str(out2),
                  cfg.replace(pair_capacity_per_gaussian=8.0), device="cpu")
    tr2.train()
    assert not [m for m in _metrics(out2)
                if m.get("event") == "pair_overflow"]
    a, b = _losses(out), _losses(out2)
    assert len(a) == len(b) == cfg.num_iterations
    np.testing.assert_allclose(a, b, rtol=2e-4)


def test_trainer_on_colmap_dataset(tmp_path):
    """The Trainer finds a COLMAP capture, seeds from its points, trains and
    evaluates the holdout."""
    _write_model(tmp_path, binary=True)
    cfg = GSConfig(num_iterations=3, min_valid_points=1, save_interval=2)
    out = tmp_path / "out"
    tr = Trainer(str(tmp_path), str(out), config=cfg, device="cpu")
    assert int(tr.model.n_alive) == N_POINTS
    tr.train()
    assert len(tr.losses) == 3 and np.isfinite(tr.losses).all()
    events = {m.get("event") for m in _metrics(out)}
    assert {"sfm_init", "colmap_split", "eval", "eval_full",
            "test"} <= events


def test_trainer_multi_focal_rig(tmp_path):
    """Per-view intrinsics reach the step: each view renders with its own
    tan_fov."""
    _write_model(tmp_path, binary=True)
    _make_mixed_focal_rig(tmp_path)
    cfg = GSConfig(num_iterations=2, min_valid_points=1,
                   save_interval=1 << 30, eval_holdout=0)
    tr = Trainer(str(tmp_path), str(tmp_path / "out"), config=cfg,
                 device="cpu")
    assert len(np.unique(np.round(tr._tanfx, 6))) == 2
    cam1 = tr.train_data.camera(1)
    assert tr._tanfx[1] == pytest.approx(cam1["tan_fovx"], rel=1e-6)
    assert tr._tanfy[1] == pytest.approx(cam1["tan_fovy"], rel=1e-6)
    tr.train()
    assert np.isfinite(tr.losses).all()
    args = _camera_tensors(cam1)
    own, _, _ = tr._render_eval(tr._settings(), tr.model, *args,
                                tr._tanfx[1], tr._tanfy[1])
    cam0 = tr.train_data.camera(0)
    other, _, _ = tr._render_eval(tr._settings(), tr.model, *args,
                                  cam0["tan_fovx"], cam0["tan_fovy"])
    assert float(own.sum()) > 0
    assert not np.allclose(own.numpy(), other.numpy(), atol=1e-5)


def test_train_cli_resume(tiny_dataset, tmp_path):
    """``python -m gstpu_torch.train``: a run writes metrics, losses, a PLY
    and states; ``--resume`` goes on at the saved iteration + 1."""
    out = tmp_path / "cli"
    common = ["--dataset", str(tiny_dataset), "--output", str(out),
              "--device", "cpu", "--num-points", "64", "--save-interval",
              "4", "--densify-from-iter", "1", "--densification-interval",
              "2", "--eval-views", "1"]
    first = train_cli.main(common + ["--iterations", "6"])
    assert first.config.save_interval == 4
    assert first.config.densification_interval == 2
    assert (out / "state" / "4.pt").exists()
    assert (out / "point_cloud" / "iteration_5" / "point_cloud.ply").exists()
    assert len(_losses(out)) == 6

    resumed = train_cli.main(common + ["--iterations", "8", "--resume", "4"])
    assert resumed.iteration == 8
    losses = _losses(out)
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert losses[:5] == first.losses[:5]
    assert [m["iteration"] for m in _metrics(out)
            if m.get("event") == "done"] == [6, 8]


def test_entry_points_default_to_the_card(tiny_dataset, tmp_path):
    """Without ``device``, the Trainer and the CLI ask for the CUDA card
    (and raise where there is none)."""
    if torch.cuda.is_available():
        pytest.skip("checks the default where there is no CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(str(tiny_dataset), str(tmp_path / "o"), _config())
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--dataset", str(tiny_dataset), "--output",
                        str(tmp_path / "o2")])
    assert not (tmp_path / "o").exists()
