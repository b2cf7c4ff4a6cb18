"""Loss curves of the port's Trainer against gstpu's Trainer (CPU).

Both trainers run on ``scripts/make_tiny_nerf.py``'s dataset at 32x32 from
the same initial model (gstpu's random init, carried over with
``gstpu_torch.convert``) and take their cameras in the same
``default_rng(seed)`` order.  Their pair capacities are held at one value
(``_round_capacity`` replaced), so gstpu compiles one step; both
trainers' checkpoints and evals are switched off, since only their losses
and events are read.

- Densify off: the per-step losses agree within rtol 1e-4.
- Densify on, both packages' noise hooks pinned to the index-keyed hash of
  ``scripts/compare_ref_training.py``: the densify events have equal
  clone, split, prune and live counts, then the losses agree within the
  same tolerance.
- Overflow: both start at a pair capacity far below the first view's need,
  so the first flush rolls the window back, refits the capacities (the
  kept need extrapolated from the truncated list) and replays it.  Every
  capacity the refit asks ``_round_capacity`` for is recorded and answered
  with the one compiled capacity; the requests, the ``pair_overflow`` and
  ``pair_capacity_*`` events and the losses must agree.
"""

import json

import numpy as np
import pytest
import torch

from gstpu.config import GSConfig as JaxConfig
from gstpu.trainer import Trainer as JaxTrainer
from gstpu_torch import convert
from gstpu_torch.config import GSConfig
from gstpu_torch.optim import init_adam_state
from gstpu_torch.trainer import Trainer
from scripts.make_tiny_nerf import make_dataset
from tests.test_torch_densify import pin_noise

LOSS_RTOL = 1e-4
CAPACITY = 1 << 14
STEPS = 10
MODEL_FIELDS = ("positions", "scales", "rotations", "opacities", "shs",
                "alive", "n_alive")


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


def _fixed_capacities(trainer, start: int = CAPACITY) -> list:
    """Start the pair and kept capacities at ``start`` and answer every
    request to ``_round_capacity`` with CAPACITY; returns the list that
    records the requests."""
    requests = []
    trainer._round_capacity = lambda pairs: requests.append(pairs) or CAPACITY
    trainer._pair_capacity = trainer._kept_capacity = start
    trainer._eval_pair_capacity = trainer._eval_kept_capacity = CAPACITY
    return requests


def _run_both(dataset, out, start: int = CAPACITY, **cfg):
    """Train gstpu's and the port's Trainer from gstpu's initial model,
    from the pair capacity ``start``; returns (gstpu trainer, port
    trainer), each with the capacity requests of its refits as
    ``requests``."""
    kw = dict(num_points=64, num_iterations=STEPS, save_interval=1 << 30,
              min_valid_points=1, capacity_headroom=3.0, **cfg)
    jt = JaxTrainer(str(dataset), str(out / "gstpu"), JaxConfig(**kw))
    jt.requests = _fixed_capacities(jt, start)
    init = {k: np.asarray(getattr(jt.model, k)) for k in MODEL_FIELDS}

    pt = Trainer(str(dataset), str(out / "port"), GSConfig(**kw),
                 device="cpu")
    pt.requests = _fixed_capacities(pt, start)
    pt.model = convert.model_from_numpy(init, "cpu")
    pt.adam = init_adam_state(pt.model.param_dict())
    for t in (jt, pt):
        t.val_data = t.test_data = None
        t.save_checkpoint = lambda *a, **k: None
    jt.train()
    pt.train()
    return jt, pt


def _events(out, *names):
    with open(out / "metrics.jsonl") as f:
        return [m for m in map(json.loads, f) if m.get("event") in names]


def test_loss_curve_densify_off(tiny_dataset, tmp_path):
    jt, pt = _run_both(tiny_dataset, tmp_path, densify_from_iter=10_000)
    assert len(pt.losses) == len(jt.losses) == STEPS
    np.testing.assert_allclose(pt.losses, jt.losses, rtol=LOSS_RTOL)
    assert not _events(tmp_path / "port", "densify")


def test_loss_curve_densify_on(tiny_dataset, tmp_path, monkeypatch):
    pin_noise(monkeypatch)
    jt, pt = _run_both(tiny_dataset, tmp_path, densify_from_iter=1,
                       densification_interval=3, densify_grad_threshold=5e-5)
    want = _events(tmp_path / "gstpu", "densify")
    got = _events(tmp_path / "port", "densify")
    assert [e["iteration"] for e in want] == [3, 6, 9]
    assert got == want
    assert any(e["cloned"] or e["split"] for e in want)
    assert len(pt.losses) == len(jt.losses) == STEPS
    np.testing.assert_allclose(pt.losses, jt.losses, rtol=LOSS_RTOL)


def test_overflow_rollback_and_refit_match(tiny_dataset, tmp_path):
    jt, pt = _run_both(tiny_dataset, tmp_path, start=32,
                       densify_from_iter=10_000)
    capacity_events = ("pair_overflow", "pair_capacity_grow",
                       "pair_capacity_shrink")
    want = _events(tmp_path / "gstpu", *capacity_events)
    got = _events(tmp_path / "port", *capacity_events)
    assert want[0]["event"] == "pair_capacity_grow"
    overflow = want[1]
    assert overflow["event"] == "pair_overflow" and overflow["rolled_back"]
    assert overflow["max_pairs"] > 32       # the kept need was extrapolated
    assert got == want
    assert len(jt.requests) >= 2 and pt.requests == jt.requests
    assert len(pt.losses) == len(jt.losses) == STEPS
    np.testing.assert_allclose(pt.losses, jt.losses, rtol=LOSS_RTOL)
