"""On the card, at a size a test run holds: the program passes each
driver's comparison, under the limits of the cell that drives it at full
size, and the control (the reference with TF32 on in the program's place)
fails it.  Skips without a card."""

import json

import pytest
import torch

from conftest import DATA
from harness import manifest


def _small():
    cfg = json.loads((DATA / "gsbench/configs/tiny.json").read_text())
    cfg.update(name="small", gaussians=60000, width=400, height=300, views=24)
    cfg["assumed"]["scale_factor"] = 4.0
    return cfg


@pytest.mark.card
@pytest.mark.parametrize("mix, limits", [("train-late", "mip360-train"),
                                         ("eval-orbit", "mip360-view")])
def test_program_passes_and_control_fails(card, mix, limits):
    traffic = manifest.traffic(mix)
    limits = manifest.limits(limits)
    cfg = _small()
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        run = manifest.module("drivers", traffic["driver"]).Driver(
            cfg, traffic, seed, card, 0.0, manifest.module("scenes", cfg["scene"]))
        run.setup()
        run.window(1.0)
        got, want = run.readings()
        sound = run.compare(got, want)
        assert all(sound[k] <= limits[k] for k in sound), sound
        control = run.compare(run.reference_readings(got, tf32=True), want)
        assert any(control[k] > limits[k] for k in control), control
        torch.cuda.empty_cache()
