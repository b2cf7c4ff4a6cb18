"""Driver ``train``: training steps of the Trainer's loop through
``gstpu_torch.trainer.train_step``.

Views come in the Trainer's seeded order; losses and pair counts are
fetched once per ``flush_interval`` steps, with no other host sync;
capacities are fitted in set-up by the Trainer's rule over every training
view.  The first ``compared_steps`` steps are taken in set-up through the
window's own call, on distinct views, and are held against the plain
reference.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import numpy as np
import torch

from harness import base, counts, trace
from reference import splat

CHUNK_ROWS = 1 << 18


def _change_norm(x: torch.Tensor, start: torch.Tensor) -> float:
    """The norm of ``x - start`` for a snapshot kept on the host, a block
    of rows at a time on ``x``'s device (so the check holds no copy of the
    cloud on the card)."""
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, len(x), CHUNK_ROWS):
        d = x[i:i + CHUNK_ROWS] - start[i:i + CHUNK_ROWS].to(x.device)
        total += d.double().square().sum()
    return float(total.sqrt())


@contextlib.contextmanager
def half_batch():
    """The fault of half the batch left out: the reference's loss over the
    top half of the image's rows."""
    whole = splat.loss

    def half(image, target, lambda_dssim):
        rows = image.shape[0] // 2
        return whole(image[:rows], target[:rows], lambda_dssim)
    splat.loss = half
    try:
        yield
    finally:
        splat.loss = whole


class Driver(base.Driver):
    kind = "train"
    faults = {"half_batch": half_batch}

    def setup(self) -> None:
        from gstpu_torch.config import GSConfig
        from gstpu_torch.models.gaussians import GaussianModel
        from gstpu_torch.optim import init_adam_state
        from gstpu_torch.trainer import train_settings, train_step

        cfg, tr, dev, scene = self.cfg, self.traffic, self.device, self.scene
        phases = {"start": time.perf_counter() - self.t0}
        self._train_step = train_step
        lr, adam = tr["learning_rates"], tr["adam"]
        self.gs = GSConfig(
            num_iterations=tr["num_iterations"], lambda_dssim=tr["lambda_dssim"],
            parameterization="activated", sh_degree=cfg["sh_degree"],
            lr_pos=lr["positions"], lr_scale=lr["scales"], lr_rot=lr["rotations"],
            lr_opac=lr["opacities"], lr_sh=lr["shs"], final_lr_factor=tr["final_lr_factor"],
            schedule_opac=tr["schedule_opacities"], adam_beta1=adam["beta1"],
            adam_beta2=adam["beta2"], adam_epsilon=adam["epsilon"])
        stored = scene.make_cloud(cfg, self.seed, dev)
        cams = scene.cameras(cfg)
        train_ids, _ = scene.split(cfg)
        self.cams = [cams[i] for i in train_ids]
        self.stacked = base.camera_tensors(self.cams, dev)
        self.targets = scene.targets(cfg, self.seed, len(train_ids), dev)
        base.sync(dev)
        phases["inputs"] = time.perf_counter() - self.t0

        # capacities: the Trainer's refit rule over every training view,
        # counted by the reference; its memory is the benchmark's, so the
        # peak starts again after it
        p = splat.activate(stored)
        sigma = splat.covariance(p)
        need = np.array([splat.pair_counts(splat.preprocess(
            p, base.camera(c, cfg, dev), tight=True, sigma=sigma, colour=False),
            base.camera(c, cfg, dev)) for c in self.cams])
        del p, sigma
        self.pair_cap = counts.round_capacity(need[:, 0].max() * counts.REFIT)
        self.kept_cap = min(counts.round_capacity(need[:, 1].max() * counts.REFIT),
                            self.pair_cap)
        fit = {"views": len(need), "pairs_mean": float(need[:, 0].mean()),
               "pairs_max": int(need[:, 0].max()), "kept_mean": float(need[:, 1].mean()),
               "kept_max": int(need[:, 1].max())}
        if dev.type == "cuda":
            fit["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
            torch.cuda.reset_peak_memory_stats(dev)
        base.note(capacity_fit=fit)
        self.settings = train_settings(self.gs, cfg["width"], cfg["height"],
                                       self.pair_cap, self.kept_cap)
        n = self.gaussians = len(stored["positions"])
        self.model = GaussianModel(**stored, alive=torch.ones(n, dtype=torch.bool, device=dev),
                                   n_alive=torch.tensor(n, dtype=torch.int32, device=dev))
        self.adam = init_adam_state(self.model.param_dict())
        self.iteration = tr["first_iteration"]
        self.rng = np.random.default_rng(self.seed)
        self.pending: list = []
        self.kept_pairs: list[int] = []
        base.sync(dev)
        phases["capacity_fit"] = time.perf_counter() - self.t0

        # the compared steps: the window's own call on distinct views; the
        # snapshot for the change is kept on the host
        start = {k: v.cpu() for k, v in stored.items()}
        del stored
        views = []
        while len(views) < tr["compared_steps"]:
            v = self.draw()
            if v not in views:
                views.append(v)
        self.compared_views = views
        losses, step_counts = [], []
        b1 = tr["adam"]["beta1"]
        for j, v in enumerate(views):
            loss, cnt = self.step(v)
            losses.append(loss)
            step_counts.append(cnt)
            if j == 0:
                grads = {k: m.norm() / (1.0 - b1) for k, m in self.adam.m.items()}
        change = {k: _change_norm(x, start[k]) for k, x in self.model.param_dict().items()}
        del start
        fetched = torch.stack(step_counts).cpu().tolist()
        base.note(compared_steps=views, counts=fetched,
                  capacities=[self.pair_cap, self.kept_cap])
        self.program = {
            "loss": torch.stack(losses).double().cpu().tolist(),
            "kept": [c[1] for c in fetched],
            "grad": {k: float(x) for k, x in grads.items()},
            "change": change}
        base.sync(dev)
        self.setup_s = time.perf_counter() - self.t0
        base.note(setup_phases_s=dict(phases, compared_steps=self.setup_s))

    def draw(self) -> int:
        return int(self.rng.integers(0, len(self.cams)))

    def step(self, v: int):
        c = self.cams[v]
        (self.model, self.adam, loss, _, cnt, self.iteration) = self._train_step(
            self.settings, self.gs, self.model, self.adam, self.stacked["view"][v],
            self.stacked["proj"][v], self.stacked["campos"][v], c["tan_fovx"],
            c["tan_fovy"], self.targets[v], self.iteration)
        return loss, cnt

    def flush(self) -> None:
        if not self.pending:
            return
        rows = torch.stack([torch.cat([loss.reshape(1).double(), cnt.double()])
                            for loss, cnt in self.pending]).cpu().numpy()
        bad = ((rows[:, 1] > self.pair_cap) | (rows[:, 2] > self.kept_cap)
               | ~np.isfinite(rows[:, 0]))
        self.failed += int(bad.sum())
        self.kept_pairs.extend(int(x) for x in rows[:, 2])
        self.pending = []

    def window(self, seconds: float) -> dict:
        base.sync(self.device)
        t0 = time.perf_counter()
        steps = 0
        every = self.traffic["flush_interval"]
        flushes = []
        while time.perf_counter() - t0 < seconds:
            self.pending.append(self.step(self.draw()))
            steps += 1
            if len(self.pending) >= every:
                self.flush()
                flushes.append(time.perf_counter() - t0)
        self.flush()
        base.sync(self.device)
        self.window_s = time.perf_counter() - t0
        self.attempted = steps
        base.note(step_ms_per_flush=[round((b - a) * 1e3 / every, 3) for a, b
                                     in zip([0.0] + flushes, flushes)])
        return {"train_step_ms": self.window_s * 1e3 / steps}

    def traced(self, items: int, name: str) -> None:
        """Profile ``items`` steps in the loop's rhythm.  The reference then
        walks each traced view from the state the sub-window left, which is
        at most ``items`` steps on from the state each step saw; holding each
        step's state would make the profiled steps allocate as the window's
        never do."""
        views = []

        def run():
            for _ in range(items):
                views.append(self.draw())
                self.pending.append(self.step(views[-1]))
        self.trace = trace.profiled(run, name)
        program_kept = [int(cnt[1]) for _, cnt in self.pending[-items:]]
        self.flush()
        self.traced_items = items
        p = splat.activate(self.model.param_dict())
        for v, kept in zip(views, program_kept):
            cam = base.camera(self.cams[v], self.cfg, self.device)
            prep = splat.preprocess(p, cam, tight=True)
            pairs = splat.bin_pairs(prep, cam, cull=True)
            out = splat.composite(prep, pairs, cam, torch.zeros(3, device=self.device))
            self.walks.append(dict(base.walk_of(pairs, out), kept_slots=pairs.num_kept))
            base.note(walk=dict(self.walks[-1], view=v, program_num_kept=kept))
            del prep, pairs, out

    def flops(self, walk: dict) -> float:
        return counts.step_flops(self.gaussians,
                                 self.cfg["width"] * self.cfg["height"],
                                 walk["num_pairs"], walk["num_kept"],
                                 walk["evaluated"], walk["kept"],
                                 self.traffic["lambda_dssim"])

    def program_readings(self) -> dict:
        return self.program

    def free(self) -> None:
        self.model = self.adam = self.targets = None
        self.pending = []

    def reference_readings(self, got: dict, tf32: bool = False) -> dict:
        """The reference's readings of the compared steps, from the seed's
        cloud and Adam moments at zero."""
        dev = self.device
        splat.precision(tf32)
        try:
            stored = self.scene.make_cloud(self.cfg, self.seed, dev)
            targets = self.scene.targets(self.cfg, self.seed, len(self.cams), dev)
            start = {k: v.clone() for k, v in stored.items()}
            m = {k: torch.zeros_like(v) for k, v in stored.items()}
            v2 = {k: torch.zeros_like(v) for k, v in stored.items()}
            losses, kept, grads = [], [], None
            it = self.traffic["first_iteration"]
            for j, v in enumerate(self.compared_views):
                target = targets[v].clone()
                cam = base.camera(self.cams[v], self.cfg, dev)
                loss, g, cnt = splat.loss_and_grads(stored, cam, torch.zeros(3, device=dev),
                                                    target, self.traffic["lambda_dssim"])
                losses.append(loss)
                kept.append(cnt["num_kept"])
                if j == 0:
                    grads = {k: float(x.norm()) for k, x in g.items()}
                stored, m, v2 = splat.adam(stored, g, m, v2, self._lrs(it), it,
                                           *self.traffic["adam"].values())
                it += 1
            change = {k: float((stored[k] - start[k]).double().norm()) for k in stored}
            return {"loss": losses, "kept": kept, "grad": grads, "change": change}
        finally:
            splat.precision(False)

    def _lrs(self, it: int) -> dict:
        """The recipe's learning rates at iteration ``it``: every group's
        decays, the opacities' only if the mix says so."""
        tr = self.traffic
        f, total = tr["final_lr_factor"], tr["num_iterations"]
        lr = {k: splat.exp_lr(v, f, it, total) for k, v in tr["learning_rates"].items()}
        if not tr["schedule_opacities"]:
            lr["opacities"] = float(torch.tensor(tr["learning_rates"]["opacities"],
                                                 dtype=torch.float32))
        return lr

    def compare(self, got: dict, want: dict) -> dict:
        """The numbers compared: the worst step's relative loss gap and
        kept-pair gap, and the worst leaf's gaps in the first gradient's
        norm and in the change's norm, each against that leaf's reference
        norm.  Both leave out leaves whose reference gradient is under a
        thousandth of the median leaf's: nought to rounding."""
        median = statistics.median(want["grad"].values())
        quiet = [k for k in want["grad"] if want["grad"][k] < 1e-3 * median]
        base.note(leaf_norms={k: {"grad": [got["grad"][k], want["grad"][k]],
                                  "change": [got["change"][k], want["change"][k]]}
                              for k in want["grad"]}, quiet_leaves=quiet)
        steps = list(zip(got["loss"], want["loss"], got["kept"], want["kept"]))
        return {
            "loss_gap": max(base.relative_gap(a, b, abs(b)) for a, b, _, _ in steps),
            "kept_pairs_gap": max(base.relative_gap(a, b, b) for _, _, a, b in steps),
            "grad_norm_gap": base.norm_gaps(got["grad"], want["grad"], skip=quiet),
            "change_norm_gap": base.norm_gaps(got["change"], want["change"], skip=quiet)}
