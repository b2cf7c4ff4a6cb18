"""The measurement helpers of ``chip_smoke.py`` that need no card.

- ``recording_checkpoints`` sees the checkpoints that the differentiable
  render's forward returns (None on the CPU), and puts the wrapper back.
- ``load_wrapper`` loads a wrapper module (``cuda_rasterize.py``, whose
  ``_library`` takes the library's name, or ``sol_model.py``, whose
  ``_library`` takes none) under its own name with the libraries it is
  given, and that module sets their argument types itself: how
  ``PreviousKernels`` launches the parent commit's kernels K1, K2 and K3
  through the parent's own C interfaces.  ``PreviousKernels`` names the
  parent files it lacks before it builds anything.
- ``bare_ms`` refuses a launch function without argument types and a call
  that never launches it, and puts the function back.
- ``in_turns`` measures previous, current, current, previous.
- Phase 12: the COLMAP writer round-trips through the port's loader;
  ``TrainerProbe`` holds one trainer step and one eval render after its
  ``check_step`` against the plain compositing, without counting their
  launches, and puts the trainer's functions back.
"""

import types

import numpy as np
import pytest
import torch

import chip_smoke
from gstpu_torch import scenes, sol_model
from gstpu_torch.config import RenderSettings
from gstpu_torch.ops import cuda_rasterize, rasterize
from gstpu_torch.utils import tracing


def test_recording_checkpoints_sees_each_render_and_restores():
    rng = np.random.default_rng(4)
    cam = scenes.example_camera(width=32, height=32)
    pts, shs, scales, rotations, opacities = (
        torch.tensor(x) for x in scenes.random_scene(rng, n=12))
    settings = RenderSettings(width=32, height=32, pair_capacity=1 << 10)
    wrapper = cuda_rasterize.composite_forward_checkpointed
    with chip_smoke.recording_checkpoints() as found:
        for _ in range(2):
            image, _, _ = rasterize.render(
                settings, cam["tan_fovx"], cam["tan_fovy"], 1.0, pts, scales,
                rotations, opacities, shs,
                *(torch.tensor(cam[k]) for k in ("view", "proj", "campos")),
                torch.zeros(3))
            assert image.shape == (32, 32, 3)
    assert found == [None, None]        # the plain version makes none
    assert cuda_rasterize.composite_forward_checkpointed is wrapper
    with pytest.raises(KeyError):
        with chip_smoke.recording_checkpoints():
            raise KeyError("inside")
    assert cuda_rasterize.composite_forward_checkpointed is wrapper


def _fake_libs():
    return {name: types.SimpleNamespace(**{f"gstpu_{name}":
                                           types.SimpleNamespace()})
            for name in ("rasterize_fwd", "rasterize_bwd")}


def test_load_wrapper_uses_the_given_libraries_and_their_own_types():
    libs = _fake_libs()
    module = chip_smoke.load_wrapper(cuda_rasterize.__file__, libs)
    assert module is not cuda_rasterize
    assert module.tracing.COUNTERS is not tracing.COUNTERS
    assert module.cuda_build.library("rasterize_bwd") is libs["rasterize_bwd"]
    assert module.cuda_build.device_index is not None
    # the module's own interface: this tree's, as the file is this tree's
    for lib in libs.values():
        fn, = vars(lib).values()
        assert fn.restype is not None
    assert len(libs["rasterize_fwd"].gstpu_rasterize_fwd.argtypes) == 20
    assert len(libs["rasterize_bwd"].gstpu_rasterize_bwd.argtypes) == 17


def test_load_wrapper_takes_a_module_whose_library_takes_no_name():
    libs = {"sol_compositing": types.SimpleNamespace(
        gstpu_sol_compositing=types.SimpleNamespace())}
    module = chip_smoke.load_wrapper(sol_model.__file__, libs)
    assert module is not sol_model and module.__name__ == "previous_sol_model"
    assert module.LAUNCHES is not sol_model.LAUNCHES
    assert module._library() is libs["sol_compositing"]
    assert len(libs["sol_compositing"].gstpu_sol_compositing.argtypes) == 7


def test_previous_kernels_names_the_missing_parent_files(tmp_path):
    (tmp_path / "rasterize_fwd.cu").write_text("// the parent's K1\n")
    with pytest.raises(FileNotFoundError) as err:
        chip_smoke.PreviousKernels(tmp_path)
    for name in ("rasterize_bwd.cu", "composite_common.cuh",
                 "cuda_rasterize.py", "sol_compositing.cu", "sol_model.py"):
        assert name in str(err.value)
    assert "rasterize_fwd.cu" not in str(err.value)


@pytest.mark.parametrize("missing", ["sol_compositing.cu", "sol_model.py"])
def test_previous_kernels_needs_the_parent_k3(tmp_path, missing):
    """K1's and K2's parent files alone are not enough: --previous also
    builds and launches the parent's K3."""
    for path in chip_smoke.PARENT_FILES:
        name = path.rsplit("/", 1)[-1]
        if name != missing:
            (tmp_path / name).write_text("# a parent file\n")
    with pytest.raises(FileNotFoundError, match=missing):
        chip_smoke.PreviousKernels(tmp_path)
    assert {n for names in chip_smoke.PARENT_WRAPPERS.values()
            for n in names} == {"rasterize_fwd", "rasterize_bwd",
                                "sol_compositing"}


def test_bare_ms_refuses_untyped_or_unlaunched_functions():
    untyped = types.SimpleNamespace(argtypes=None)
    lib = types.SimpleNamespace(gstpu_k=untyped)
    with pytest.raises(RuntimeError, match="argument types"):
        chip_smoke.bare_ms(lib, "gstpu_k", lambda: None)
    typed = types.SimpleNamespace(argtypes=[int])
    lib = types.SimpleNamespace(gstpu_k=typed)
    with pytest.raises(RuntimeError, match="did not launch"):
        chip_smoke.bare_ms(lib, "gstpu_k", lambda: None)
    assert lib.gstpu_k is typed


def test_in_turns_measures_previous_current_current_previous():
    calls = []

    def measure(name, value):
        def f():
            calls.append(name)
            return value + len(calls)
        return f

    previous, current, turns = chip_smoke.in_turns(measure("p", 10.0),
                                                   measure("c", 20.0))
    assert calls == ["p", "c", "c", "p"]
    assert turns == [11.0, 22.0, 23.0, 14.0]
    assert (previous, current) == (12.5, 22.5)


def test_colmap_capture_round_trip(tmp_path):
    """Phase 12's COLMAP writer through the port's loader at 64x64: the
    orbit cameras within CAPTURE_TOL, the images and points exactly, and
    the holdout split of the trainer's default (every 8th view)."""
    from gstpu_torch.data.colmap import ColmapDataset

    rng = np.random.default_rng(12)
    cams = [scenes.lego_orbit(2 * np.pi * k / chip_smoke.TRAINER_VIEWS, 64)
            for k in range(chip_smoke.TRAINER_VIEWS)]
    images = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
              for _ in cams]
    xyz = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (50, 3), dtype=np.uint8)
    chip_smoke.write_colmap_capture(tmp_path, cams, images, xyz, rgb)
    assert chip_smoke.capture_readback_error(tmp_path, cams) \
        <= chip_smoke.CAPTURE_TOL
    data = ColmapDataset(str(tmp_path), "train", holdout=0)
    for i in (0, 7, 15):
        np.testing.assert_array_equal(data.image(i), images[i] / np.float32(
            255.0))
    got_xyz, got_rgb = data.points3d()
    np.testing.assert_array_equal(got_xyz, xyz)
    np.testing.assert_array_equal(got_rgb, rgb / np.float32(255.0))
    test = ColmapDataset(str(tmp_path), "test")
    assert [p.rsplit("/", 1)[1] for p in test.image_paths] \
        == ["r_00.png", "r_08.png"]
    assert len(ColmapDataset(str(tmp_path), "train")) == 14


def test_rotmat_to_qvec_inverts_the_loader():
    from gstpu_torch.data.colmap import qvec_to_rotmat

    rng = np.random.default_rng(13)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        got = chip_smoke.rotmat_to_qvec(qvec_to_rotmat(q))
        np.testing.assert_allclose(got, q if q[0] >= 0 else -q, atol=1e-12)


class _FakeEvent:
    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def elapsed_time(self, end):
        return 1.0


def test_uncounted_puts_the_launch_counts_back():
    counts = dict(tracing.COUNTERS)
    with pytest.raises(KeyError):
        with chip_smoke.uncounted():
            tracing.COUNTERS.add("k1.launches", 3)
            tracing.COUNTERS.add("k2.ctas", 7)
            raise KeyError("inside")
    assert tracing.COUNTERS == counts


def test_trainer_probe_checks_a_step_and_an_eval_render(tmp_path,
                                                        monkeypatch):
    """A tiny run on the CPU (where the kernels' wrappers run their plain
    versions): the probe checks the step of ``check_step`` and the first
    eval render after it, at the trainer's own settings, and restores the
    trainer's functions."""
    from gstpu_torch import trainer as trainer_mod
    from gstpu_torch.config import GSConfig
    from scripts.make_tiny_nerf import make_dataset

    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    make_dataset(tmp_path / "data", size=32, n_train=3, n_val=2)
    cfg = GSConfig(num_points=64, num_iterations=6, save_interval=3,
                   eval_views=1, densify_from_iter=1,
                   densification_interval=2, min_valid_points=1)
    originals = (trainer_mod.train_step, trainer_mod.Trainer._render_full,
                 trainer_mod.Trainer._render_eval,
                 trainer_mod.Trainer._maybe_densify)
    probe = chip_smoke.TrainerProbe(check_step=3)
    with probe.attached():
        trainer = trainer_mod.Trainer(str(tmp_path / "data"),
                                      str(tmp_path / "out"), cfg,
                                      device="cpu")
        trainer.train()
    assert set(probe.checks) == {"step", "eval"}
    assert probe.checks["step"]["max_abs_err"] == 0.0
    assert probe.checks["eval"]["ok"]
    assert probe.steps == list(range(6))
    assert [it for it, _ in probe.densify_s] == [2, 4]
    assert len(probe.renders) == len(probe.render_ms()) > 0
    assert (trainer_mod.train_step, trainer_mod.Trainer._render_full,
            trainer_mod.Trainer._render_eval,
            trainer_mod.Trainer._maybe_densify) == originals
