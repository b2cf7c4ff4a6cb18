"""The yardstick's arithmetic on hand-made inputs: the window rate, the
95th percentile, the walk counts, the operation counts and the trace."""

import gzip
import json
import math
import time

import pytest
import torch

from harness import base, counts, manifest, trace
from reference import splat

TRAIN = manifest.module("drivers", "train").Driver


def test_p95_over_all_frames():
    frames = [float(i) for i in range(1, 201)]       # 200 frames, 10 past it
    assert base.p95(frames) == 190.0
    assert base.p95([5.0]) == 5.0
    assert base.p95([3.0, 1.0, 2.0] * 7) == 3.0


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_train_window_rate_counts_every_step(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    run = TRAIN.__new__(TRAIN)
    run.device = torch.device("cpu")
    run.traffic = {"flush_interval": 4}
    run.pair_cap, run.kept_cap = 100, 50
    run.pending, run.kept_pairs, run.failed = [], [], 0
    cnt = iter([(10, 5), (10, 60), (200, 5), (10, 5)] * 3)

    def step(_):
        clock.t += 0.25
        p, k = next(cnt)
        return torch.tensor(1.0), torch.tensor([p, k], dtype=torch.int32)
    run.step = step
    run.draw = lambda: 0
    out = run.window(2.0)
    assert run.attempted == 8
    assert out["train_step_ms"] == pytest.approx(250.0)
    assert run.failed == 4                 # over the kept, then the pair capacity
    assert len(run.kept_pairs) == 8


def _one_tile_scene():
    """Two Gaussians centred on a 16x16 tile, the front one opaque."""
    prep = {"xy": torch.tensor([[7.5, 7.5], [7.5, 7.5]]),
            "conic": torch.tensor([[1e-4, 0.0, 1e-4], [1e-4, 0.0, 1e-4]]),
            "opacity": torch.tensor([0.99, 0.5]),
            "rgb": torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]),
            "depth": torch.tensor([1.0, 2.0])}
    pairs = splat.Pairs(gid=torch.tensor([0, 1]), tile_start=torch.tensor([0]),
                        tile_count=torch.tensor([2]), num_pairs=2, num_kept=2)
    cam = splat.Camera(torch.eye(4), torch.eye(4), torch.zeros(3), 1.0, 1.0, 16, 16)
    return prep, pairs, cam


def test_walk_counts_on_a_hand_made_tile():
    prep, pairs, cam = _one_tile_scene()
    out = splat.composite(prep, pairs, cam, torch.zeros(3))
    # every pixel composites both pairs: T = 0.01 * 0.5... > 1e-4 after the
    # second (alpha 0.5 * exp(-tiny) ~ 0.4995), so nothing stops
    assert out["evaluated"] == 2 * 256 and out["kept"] == 2 * 256
    # alphas 0.9, 0.99, 0.99, 0.99: T 0.1, then 1e-3, then the third would
    # take it to 1e-5, under 1e-4: each pixel stops there, the fourth unseen
    prep = {"xy": torch.full((3, 2), 7.5), "conic": torch.zeros(3, 3),
            "opacity": torch.tensor([0.9, 0.99, 0.99]), "rgb": torch.ones(3, 3),
            "depth": torch.ones(3)}
    pairs4 = splat.Pairs(gid=torch.tensor([0, 1, 2, 2]), tile_start=torch.tensor([0]),
                         tile_count=torch.tensor([4]), num_pairs=4, num_kept=4)
    out = splat.composite(prep, pairs4, cam, torch.zeros(3))
    assert out["kept"] == 2 * 256 and out["evaluated"] == 3 * 256


def test_kernel_and_step_operation_counts():
    ops, nbytes = counts.k1_work(1000, 10, 40, 2, 0)
    assert ops == 20_000 and nbytes == 10 * 40 + 40 * 4 + 2 * 8 + 2 * 256 * 24
    ops, _ = counts.k2_work(1000, 300, 10, 40, 2, 3)
    assert ops == 20_000 + 300 * 56
    assert counts.bound_s(67e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.segments(torch.tensor([0, 1, 256, 257])) == 0 + 1 + 1 + 2
    step = counts.step_flops(gaussians=10, pixels=4, num_pairs=100, kept_pairs=50,
                             evaluated=1000, kept=300, lambda_dssim=0.2)
    per_gaussian = 430 + 560 + 12 + 14 * 59
    assert step == (10 * per_gaussian + 100 * 12 + 1000 * 40 + 300 * 56 + 50 * 10
                    + 4 * 3 * 2 + 4 * 3 * (4 + 720))
    assert counts.frame_flops(10, 4, 100, 1000) == 10 * 430 + 1000 * 20 + 4 * 3 * 2
    assert counts.round_capacity(0) == 16384
    assert counts.round_capacity(1) == 32768
    assert counts.round_capacity(32769) == 65536
    assert counts.eval_capacity(100_000) == 163840


def test_mfu_and_roofline_readers():
    from harness import readers

    class Run:
        kind, traced_items, gaussians = "train", 2, 10
        walks = [{"evaluated": 67e10, "kept": 0, "kept_slots": 0, "tiles": 0,
                  "segments": 0, "num_pairs": 0, "num_kept": 0}] * 2
        trace = trace.Trace(window_s=4.0, busy_s=3.0, sync_s=1.0,
                            kernels={"ns::rasterize_fwd_kernel(x)": [1.0, 2],
                                     "elementwise": [1.0, 6]},
                            device_ops=[], idle_gaps=[])

        def flops(self, w):
            return 67e12

    run = Run()
    assert readers.mfu(run, "train") == pytest.approx(50.0)
    assert readers.idle_pct(run, "train") == pytest.approx(25.0)
    assert readers.launches(run, "train") == 4
    assert readers.host_ms(run, "train") == pytest.approx(1500.0)
    # 2 x 67e10 x 20 operations at 67e12 per second: 0.4 s of K1's 1 s
    assert readers.roofline(run, "train", readers.K1) == pytest.approx(40.0)
    assert readers.roofline(run, "view", readers.K1) is None
    assert readers.roofline(run, "train", readers.K2) is None


def test_trace_reduction(tmp_path):
    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": 1, "args": args}
    events = [
        x("user_annotation", trace.WINDOW, 0, 100),
        x("cpu_op", "aten::mul", 5, 10),
        x("cuda_runtime", "cudaLaunchKernel", 8, 2, correlation=1),
        x("kernel", "mul_kernel", 20, 30, correlation=1),
        x("cpu_op", "aten::add", 40, 20),
        x("cuda_runtime", "cudaLaunchKernel", 55, 2, correlation=2),
        x("kernel", "add_kernel", 60, 10, correlation=2),
        x("cuda_runtime", "cudaStreamSynchronize", 70, 25),
        x("gpu_memcpy", "Memcpy DtoH", 75, 5, correlation=3),
    ]
    path = tmp_path / "t.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    t = trace.read(path)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(45e-6)
    assert t.idle_pct == pytest.approx(55.0)
    assert t.sync_s == pytest.approx(25e-6)
    assert t.kernel("add") == (pytest.approx(10e-6), 1) and t.launches == 2
    gaps = dict(t.idle_gaps)
    assert gaps["aten::mul"] == pytest.approx(20e-6)
    assert gaps["aten::add"] == pytest.approx(10e-6)
    assert gaps["_no_host_op_"] == pytest.approx(5e-6)
    assert gaps["_window_end_"] == pytest.approx(20e-6)
    assert t.device_ops[0] == ["mul_kernel", pytest.approx(30e-6)]
    assert math.isclose(sum(v for _, v in t.idle_gaps) + t.busy_s, t.window_s)


def test_pair_counts_agree_with_the_binning():
    import json

    from conftest import DATA

    scene = manifest.module("scenes", "surfaces")
    cfg = json.loads((DATA / "gsbench/configs/tiny.json").read_text())
    p = splat.activate(scene.make_cloud(cfg, 3, torch.device("cpu")))
    for c in scene.cameras(cfg)[:4]:
        cam = base.camera(c, cfg, torch.device("cpu"))
        prep = splat.preprocess(p, cam, tight=True)
        pairs = splat.bin_pairs(prep, cam)
        assert splat.pair_counts(prep, cam) == (pairs.num_pairs, pairs.num_kept)
