"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have."""

import contextlib

import pytest
import torch

import run


def _run(cell, root):
    args = run.parse(["--workload", cell, "--seed", "2147483659", "--seconds", "0.2",
                      "--trace", "0"])
    return run.execute(args, root=root, device=torch.device("cpu"))


@contextlib.contextmanager
def patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def test_sound_runs_are_correct(root):
    assert _run("tiny-train", root)["correct"]
    assert _run("tiny-view", root)["correct"]


def test_a_step_that_returns_its_state_unchanged(root):
    import gstpu_torch.trainer as trainer

    whole = trainer.train_step

    def unchanged(settings, config, model, adam, *args):
        _, _, loss, grad, counts, it = whole(settings, config, model, adam, *args)
        return model, adam, loss, grad, counts, it
    with patched(trainer, "train_step", unchanged):
        result = _run("tiny-train", root)
    assert not result["correct"]
    assert result["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(root):
    import gstpu_torch.trainer as trainer

    whole = trainer.combined_loss

    def half(image, target, lambda_dssim=0.0):
        rows = image.shape[0] // 2
        return whole(image[:rows], target[:rows], lambda_dssim)
    with patched(trainer, "combined_loss", half):
        assert not _run("tiny-train", root)["correct"]


def test_half_of_a_frame_left_out_and_an_answer_altered(root):
    import gstpu_torch.render as render

    whole = render.render_gaussians

    def half(*args, **kwargs):
        image, depth, aux = whole(*args, **kwargs)
        image = image.clone()
        image[image.shape[0] // 2:] = 0.0
        return image, depth, aux

    def altered(*args, **kwargs):
        image, depth, aux = whole(*args, **kwargs)
        return image + 0.01, depth, aux
    for fault in (half, altered):
        with patched(render, "render_gaussians", fault):
            assert not _run("tiny-view", root)["correct"]
