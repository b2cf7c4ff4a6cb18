"""A configuration with a scene of its own, a traffic mix with a driver of
its own and a per-layer metric, each added as files alone, are picked up
and run, with no existing file edited."""

import json

import torch

from conftest import DATA, make_root
from harness import manifest
import run

SCENE = '''"""Half the Gaussians of the configuration's seeded surfaces."""
from pathlib import Path

from harness import manifest

_surfaces = manifest.module("scenes", "surfaces", Path(__file__).resolve().parents[2])
cameras, split, targets = _surfaces.cameras, _surfaces.split, _surfaces.targets


def make_cloud(cfg, seed, device):
    return _surfaces.make_cloud(dict(cfg, gaussians=cfg["gaussians"] // 2), seed, device)
'''

DRIVER = '''"""The held-out views from the first one, whatever the seed."""
from pathlib import Path

from harness import manifest

View = manifest.module("drivers", "view", Path(__file__).resolve().parents[2]).Driver


class Driver(View):
    def setup(self):
        super().setup()
        self.start = 0
'''


def test_new_files_are_found_and_run(tmp_path):
    root = make_root(tmp_path)
    bench = json.loads((DATA / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (root / "gsbench").rglob("*") if p.is_file()}

    cfg = json.loads((DATA / "gsbench/configs/tiny.json").read_text())
    cfg.update(name="tiny-half", width=90, scene="surfaces-half")
    (root / "gsbench/configs/tiny-half.json").write_text(json.dumps(cfg))
    (root / "gsbench/scenes/surfaces-half.py").write_text(SCENE)
    mix = json.loads((DATA / "gsbench/traffic/eval-orbit.json").read_text())
    mix.update(name="eval-from-first", driver="view-from-first", sampled_views=2)
    (root / "gsbench/traffic/eval-from-first.json").write_text(json.dumps(mix))
    (root / "gsbench/drivers/view-from-first.py").write_text(DRIVER)
    (root / "gsbench/metrics/frames_per_s.view.py").write_text(
        "def read(run):\n    return run.attempted / run.window_s if run.kind == 'view' else None\n")
    (root / "gsbench/limits/half-view.json").write_text(
        (DATA / "gsbench/limits/tiny-view.json").read_text())
    bench["configs"].append({"name": "tiny-half", "source": "https://arxiv.org/abs/2308.04079",
                             "file": "gsbench/configs/tiny-half.json", "reduced": [],
                             "why": "a second cut"})
    bench["workloads"].append({"name": "half-view", "config": "tiny-half",
                               "traffic": "eval-from-first", "chips": 1,
                               "why": "added by files"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "tiny-view" in m["workloads"]:
            m["workloads"].append("half-view")
    bench["end_to_end"].append({"name": "frame_ms.small", "unit": "ms", "better": "lower",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["half-view"]})
    bench["per_layer"].append({"name": "frames_per_s.view", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "render entry, host",
                               "moves": "frame_ms", "workloads": ["half-view"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = {p: p.read_bytes() for p in before}
    assert after == before
    loaded = manifest.load(root)
    assert manifest.config(loaded, "tiny-half", root)["width"] == 90
    cpu = torch.device("cpu")
    driver = manifest.driver(loaded, "half-view", 3, cpu, 0.0, root)
    driver.setup()
    assert driver.start == 0 and driver.gaussians == cfg["gaussians"] // 2

    args = run.parse(["--workload", "half-view", "--seed", "3", "--seconds", "0.3",
                      "--trace", "1"])
    result = run.execute(args, root=root, device=cpu)
    assert result["correct"] and result["attempted"] > 0
    assert "frames_per_s.view" in result["metrics"]
    assert result["checks"]["pairs_gap"]["value"] == 0.0
    args.trace = 0
    result = run.execute(args, root=root, device=cpu)
    assert set(result["metrics"]) == {"frame_ms", "frame_ms.small", "frame_p95_ms",
                                      "peak_mem_gib", "setup_s"}
    assert result["metrics"]["frame_ms.small"] == result["metrics"]["frame_ms"]
