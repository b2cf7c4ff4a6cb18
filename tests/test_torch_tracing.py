"""The port's spans and counters (``gstpu_torch/utils/tracing.py``) on the
CPU: off without a profiler, nested as the layers are under one, on
autograd's thread in the backward, and adding no host read; the counters
that the render, the wrappers and the Trainer's flush record."""

import collections
import gzip
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from gstpu_torch import convert, scenes
from gstpu_torch import train as train_cli
from gstpu_torch.config import GSConfig, RenderSettings
from gstpu_torch.optim import init_adam_state
from gstpu_torch.render import render_gaussians
from gstpu_torch.trainer import Trainer, train_step
from gstpu_torch.utils import tracing
from scripts.make_tiny_nerf import make_dataset

SIZE = 32
FORWARD = ["forward.preprocess", "forward.binning", "forward.composite",
           "forward.image"]
STEP = FORWARD + ["loss", "backward.composite", "backward.adjoint", "adam"]


def _scene(n=24):
    rng = np.random.default_rng(7)
    cam = scenes.example_camera(width=SIZE, height=SIZE)
    pts, shs, scales, rotations, opacities = scenes.random_scene(
        rng, n=n, scale_range=(0.05, 0.4))
    params = dict(positions=pts, scales=scales, rotations=rotations,
                  opacities=opacities, shs=shs)
    target = rng.uniform(0, 1, (SIZE, SIZE, 3)).astype(np.float32)
    return params, cam, target


def _render(params, cam, pair_capacity=None):
    return render_gaussians(
        background=np.zeros(3, np.float32), means3D=params["positions"],
        opacity=params["opacities"], scales=params["scales"],
        rotations=params["rotations"], sh=params["shs"],
        viewmatrix=cam["view"], projmatrix=cam["proj"],
        campos=cam["campos"], tan_fovx=cam["tan_fovx"],
        tan_fovy=cam["tan_fovy"], image_height=SIZE, image_width=SIZE,
        pair_capacity=pair_capacity, device="cpu")


def _step(params, cam, target):
    n = len(params["positions"])
    model = convert.model_from_numpy(dict(params, alive=np.ones(n, bool)),
                                     "cpu")
    settings = RenderSettings(width=SIZE, height=SIZE, pair_capacity=1 << 12)
    return train_step(settings, GSConfig(), model,
                      init_adam_state(model.param_dict()),
                      *(torch.tensor(cam[k]) for k in ("view", "proj",
                                                       "campos")),
                      cam["tan_fovx"], cam["tan_fovy"], torch.tensor(target),
                      0)


def _events(prof, tmp_path):
    path = tmp_path / "trace.json.gz"
    prof.export_chrome_trace(str(path))
    with gzip.open(path, "rt") as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _spans(events):
    """The ``gstpu.*`` spans in start order: (name, start, end, tid,
    names of the spans that enclose it)."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"][len(tracing.PREFIX):], e["tid"])
                   for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith(tracing.PREFIX))
    return [(name, a, b, tid,
             [o for a2, b2, o, t2 in spans if t2 == tid and (a2, b2) != (a, b)
              and a2 <= a and b <= b2])
            for a, b, name, tid in spans]


def test_a_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    traced = dict(tracing.TRACED)
    counters = dict(tracing.COUNTERS)
    assert not torch.autograd._profiler_enabled()
    first, second = tracing.span("forward.binning"), tracing.span("loss")
    assert first is second is tracing._OFF
    with first:
        pass
    assert tracing.TRACED == traced and tracing.COUNTERS == counters


def test_a_train_step_gives_the_layers_spans_in_order(tmp_path):
    """One render forward and backward through ``train_step``: each layer
    once, none inside another, in the order of the step; the backward's
    inside the render's autograd node on the thread that runs it, and
    the plain compositing's ops inside the composite spans."""
    params, cam, target = _scene()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(params, cam, target)
    events = _events(prof, tmp_path)
    spans = _spans(events)
    assert [s[0] for s in spans] == STEP
    assert all(not s[4] for s in spans)
    node = next(e for e in events if e.get("cat") == "cpu_op"
                and e["name"].startswith("autograd::engine::evaluate_function")
                and "_RenderBackward" in e["name"])
    a, b = float(node["ts"]), float(node["ts"]) + float(node["dur"])
    for name, s0, s1, tid, _ in spans:
        if name.startswith("backward."):
            assert tid == node["tid"] and a <= s0 and s1 <= b, name
    composite = {s[0]: s for s in spans}["forward.composite"]
    cumprods = [e for e in events if e.get("cat") == "cpu_op"
                and e["name"] == "aten::cumprod"]
    assert cumprods
    fwd = [e for e in cumprods if composite[1] <= float(e["ts"])
           <= composite[2]]
    assert fwd, "the plain K1's cumprod outside forward.composite"


def test_render_spans_and_counters_through_a_regrow(tmp_path):
    """A render whose pair list overflows: the inputs, the forward, then
    the regrow holding the second forward; ``render.*`` count both renders,
    and ``TRACED``, what the counters gained under the profiler, holds
    them."""
    params, cam, _ = _scene()
    _, _, aux = _render(params, cam)
    need = int(aux.num_pairs)
    cap = 16
    assert need > cap
    before = dict(tracing.COUNTERS)
    tracing.TRACED.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, aux = _render(params, cam, pair_capacity=cap)
    grown = 1 << int(np.ceil(np.log2(need)))
    changed = {k: v - before[k] for k, v in tracing.COUNTERS.items()
               if v != before[k]}
    assert changed == {"render.pairs": 2 * need,
                       "render.pair_slots": cap + grown}
    assert tracing.TRACED == changed
    assert tracing.traced("render.pairs") == 2 * need
    spans = _spans(_events(prof, tmp_path))
    assert [(s[0], s[4]) for s in spans] == (
        [("render.inputs", [])] + [(n, []) for n in FORWARD]
        + [("render.regrow", [])] + [(n, ["render.regrow"]) for n in FORWARD])
    tracing.TRACED.clear()


def test_render_counters_are_the_pairs_and_the_capacity():
    params, cam, _ = _scene()
    before = dict(tracing.COUNTERS)
    _, _, aux = _render(params, cam, pair_capacity=1 << 12)
    assert tracing.COUNTERS["render.pairs"] - before["render.pairs"] \
        == int(aux.num_pairs)
    assert tracing.COUNTERS["render.pair_slots"] \
        - before["render.pair_slots"] == 1 << 12
    # the plain compositing on the CPU launches no kernel
    assert all(tracing.COUNTERS[k] == before[k]
               for k in ("k1.launches", "k1.ctas", "k2.launches", "k2.ctas"))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("what", ["render", "train_step"])
def test_tracing_adds_no_host_read_and_no_device_op(what):
    """The same ATen ops with the spans live as without: no
    ``_local_scalar_dense`` (a read of a device value), no copy, nothing
    launched."""
    params, cam, target = _scene()

    def run():
        if what == "render":
            _render(params, cam, pair_capacity=16)
        else:
            _step(params, cam, target)

    counts = []
    for traced in (False, True):
        with _Ops() as ops:
            if traced:
                with profile(activities=[ProfilerActivity.CPU]):
                    run()
            else:
                run()
        counts.append({k: v for k, v in ops.count.items()
                       if k.startswith("aten.")})
    assert counts[0]["aten._local_scalar_dense"] >= 1
    assert counts[1] == counts[0]
    tracing.TRACED.clear()


def test_the_trainers_flush_counts_pairs_slots_and_replays(tmp_path):
    """A run whose first window overflows and is replayed: ``train.*``
    hold every fetched step's pairs and culled pairs against the
    capacities, the replayed steps and the rolled-back window; ``TRACED``
    holds them under the profiler, beside the step's spans, and the train
    CLI's summary reports the counters."""
    path = tmp_path / "tiny"
    make_dataset(path, size=SIZE, n_train=2, n_val=1)
    cfg = GSConfig(num_points=1024, num_iterations=6, save_interval=5,
                   initial_scale=1.0, pair_capacity_per_gaussian=1.0,
                   densify_from_iter=2, densification_interval=3,
                   min_valid_points=1, eval_views=1)
    tr = Trainer(str(path), str(tmp_path / "out"), cfg, device="cpu")
    tr._round_capacity = lambda pairs: max(-(-int(pairs) // 1024) * 1024,
                                           1024)
    tr._pair_capacity = tr._kept_capacity = 2048
    steps = []
    step = tr._step

    def recorded(settings, rng, it):
        loss, pos_grads, counts = step(settings, rng, it)
        steps.append((counts.tolist(), settings.pair_capacity,
                      settings.kept_capacity))
        return loss, pos_grads, counts
    tr._step = recorded
    before = dict(tracing.COUNTERS)
    tracing.TRACED.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train()
    changed = {k: v - before[k] for k, v in tracing.COUNTERS.items()
               if k.startswith("train.")}
    assert changed["train.rollbacks"] >= 1
    assert changed["train.replays"] == tr.steps_run - cfg.num_iterations
    assert len(steps) == tr.steps_run
    assert changed["train.pairs"] == sum(c[0] for c, _, _ in steps)
    assert changed["train.kept"] == sum(c[1] for c, _, _ in steps)
    assert changed["train.pair_slots"] == sum(p for _, p, _ in steps)
    assert changed["train.kept_slots"] == sum(k for _, _, k in steps)
    assert {k: v for k, v in tracing.TRACED.items()
            if k.startswith("train.")} == {k: v for k, v in changed.items()
                                           if v}
    names = {s[0] for s in _spans(_events(prof, tmp_path))}
    assert set(STEP) <= names
    assert train_cli.summary(tr, None)["counters"] == tracing.COUNTERS
    tracing.TRACED.clear()
