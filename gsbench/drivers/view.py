"""Driver ``view``: the held-out views rendered back to back through
``gstpu_torch.render.render_gaussians``, each frame synchronized, the pair
capacity regrown and carried from view to view as the eval CLI does.

A seeded sample of the window's frames, and its last frame, are held
against the plain reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import base, counts, trace
from reference import splat


class Driver(base.Driver):
    kind = "view"

    def setup(self) -> None:
        from gstpu_torch.render import render_gaussians

        cfg, tr, dev, scene = self.cfg, self.traffic, self.device, self.scene
        phases = {"start": time.perf_counter() - self.t0}
        self._render = render_gaussians
        p = splat.activate(scene.make_cloud(cfg, self.seed, dev))
        self.gaussians = len(p["positions"])
        self.inputs = dict(means3D=p["positions"], opacity=p["opacities"],
                           scales=p["scales"], rotations=p["rotations"], sh=p["shs"],
                           background=torch.zeros(3, device=dev))
        del p
        cams = scene.cameras(cfg)
        _, test_ids = scene.split(cfg)
        self.cams = [cams[i] for i in test_ids]
        self.stacked = base.camera_tensors(self.cams, dev)
        self.capacity = tr["first_pair_capacity"]
        rng = np.random.default_rng(self.seed)
        self.sampled = sorted(int(x) for x in rng.choice(len(self.cams),
                                                          tr["sampled_views"], replace=False))
        self.start = int(rng.integers(0, len(self.cams)))
        self.frame_pairs: list[int] = []
        base.sync(dev)
        phases["inputs"] = time.perf_counter() - self.t0
        for v in range(len(self.cams)):        # warm-up: every view once
            self.frame(v)
        base.note(warm_up_pairs=self.frame_pairs, capacity=self.capacity)
        self.frame_pairs = []
        base.sync(dev)
        self.setup_s = time.perf_counter() - self.t0
        base.note(setup_phases_s=dict(phases, warm_up=self.setup_s))

    def frame(self, v: int):
        c = self.cams[v]
        out = self._render(
            **self.inputs, viewmatrix=self.stacked["view"][v],
            projmatrix=self.stacked["proj"][v], campos=self.stacked["campos"][v],
            tan_fovx=c["tan_fovx"], tan_fovy=c["tan_fovy"],
            image_height=self.cfg["height"], image_width=self.cfg["width"],
            degree=self.cfg["sh_degree"], pair_capacity=self.capacity,
            device=self.device)
        pairs = int(out[2].num_pairs)
        if pairs > self.capacity:          # carried to the next view
            self.capacity = counts.eval_capacity(pairs)
        self.frame_pairs.append(pairs)
        return out

    def window(self, seconds: float) -> dict:
        """Frames back to back; each sampled frame is copied to the host
        after its time is taken, so the card holds only what a viewer
        holds."""
        n = len(self.cams)
        self.kept_frames: dict = {}
        times = []
        base.sync(self.device)
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            v = (self.start + i) % n
            a = time.perf_counter()
            image, depth, aux = self.frame(v)
            base.sync(self.device)
            times.append(time.perf_counter() - a)
            if v in self.sampled and v not in self.kept_frames:
                self.kept_frames[v] = (image.cpu(), depth.cpu(), int(aux.num_pairs))
            last = (v, image, depth, int(aux.num_pairs))
            i += 1
        self.window_s = time.perf_counter() - t0
        self.last = last
        self.attempted = i
        return {"frame_ms": self.window_s * 1e3 / i,
                "frame_p95_ms": base.p95(times) * 1e3}

    def traced(self, items: int, name: str) -> None:
        n = len(self.cams)
        views = [(self.start + self.attempted + k) % n for k in range(items)]

        def run():
            for v in views:
                self.frame(v)
                base.sync(self.device)
        self.trace = trace.profiled(run, name)
        self.traced_items = items
        inp = self.inputs
        p = {"positions": inp["means3D"], "opacities": inp["opacity"],
             "scales": inp["scales"], "rotations": inp["rotations"], "shs": inp["sh"]}
        for v in views:
            cam = base.camera(self.cams[v], self.cfg, self.device)
            prep = splat.preprocess(p, cam, tight=False)
            pairs = splat.bin_pairs(prep, cam, cull=False)
            out = splat.composite(prep, pairs, cam, torch.zeros(3, device=self.device))
            self.walks.append(dict(base.walk_of(pairs, out), kept_slots=pairs.num_pairs,
                                   segments=0))
            base.note(walk=dict(self.walks[-1], view=v))
            del prep, pairs, out

    def flops(self, walk: dict) -> float:
        return counts.frame_flops(self.gaussians,
                                  self.cfg["width"] * self.cfg["height"],
                                  walk["num_pairs"], walk["evaluated"])

    def program_readings(self) -> dict:
        frames = dict(self.kept_frames)
        v, image, depth, pairs = self.last
        frames.setdefault(v, (image, depth, pairs))
        return frames

    def free(self) -> None:
        self.inputs = None

    def reference_readings(self, got: dict, tf32: bool = False) -> dict:
        """The reference's frames of the views in ``got``, from the seed's
        cloud."""
        splat.precision(tf32)
        try:
            stored = self.scene.make_cloud(self.cfg, self.seed, self.device)
            out = {}
            for v in got:
                cam = base.camera(self.cams[v], self.cfg, self.device)
                r = splat.render(stored, cam, torch.zeros(3, device=self.device),
                                 tight=False, cull=False)
                out[v] = (r["image"], r["depth"], r["num_pairs"])
            return out
        finally:
            splat.precision(False)

    def compare(self, got: dict, want: dict) -> dict:
        """The worst compared frame's mean absolute error of the image and
        of the inverse depth (against the reference's mean), and its
        relative gap in pairs."""
        img = dep = pairs = 0.0
        for v, (image, depth, n) in got.items():
            r_image, r_depth, r_n = want[v]
            image, depth = image.to(r_image.device), depth.to(r_depth.device)
            img = max(img, float((image - r_image).abs().mean()))
            dep = max(dep, float((depth - r_depth).abs().mean() / r_depth.abs().mean()))
            pairs = max(pairs, base.relative_gap(n, r_n, r_n))
        return {"image_mean_abs_err": img, "depth_mean_rel_err": dep,
                "pairs_gap": pairs}
