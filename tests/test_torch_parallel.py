"""The port's multi-rank path on the CPU: gloo process groups of spawned
processes against the port's single-device render, step and Trainer.

The cases of ``tests/test_sharded.py``, on (n_data, n_model) meshes of
(1, 2) and (2, 2) ranks at 64x64 (one case 64x72, so the tile grid pads a
row): the sharded render against the single-device render (atol 1e-5);
N = 61, which the sharded render pads with dead Gaussians without the
fallback warning; strided rows at 48x72 (grid_y 5, a band row past the
grid); the step's loss, position gradients (atol 1e-6) and Adam-stepped
parameters (atol 3e-6); DSSIM (band-local SSIM through the 5-row halo
exchange) and depth supervision (loss within 1e-5, position gradients
within 2e-5 of their scale); two distinct cameras and two focals on the
data axis (the loss is the mean over the batch).  All cases of one mesh run
in one process group; every rank's results are checked.

Then ``pad_targets_to_grid`` and ``band_settings`` against gstpu's, and
the mesh Trainer (``--n-model 2``, densify on) whose losses stay within
rtol 1e-4 of the single-device Trainer's.  Each group has its own
``file://`` rendezvous under the test's directory and a join timeout;
a rank that fails or hangs fails the test.
"""

import multiprocessing
import traceback
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gstpu_torch import scenes
from gstpu_torch.config import GSConfig, RenderSettings
from gstpu_torch.ops.losses import combined_loss, depth_loss, l1_loss
from gstpu_torch.ops.rasterize import render
from gstpu_torch.optim import adam_step, init_adam_state, schedule_lrs

MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
JOIN_TIMEOUT = 240.0
BG = np.zeros(3, np.float32)

# name: (seed, N, width, height, config fields, target seed); the cases of
# tests/test_sharded.py
CASES = {
    "render": (0, 64, 64, 64, {}, None),
    "odd_n": (3, 61, 64, 64, {}, None),
    "strided_rows": (4, 64, 48, 72, {}, None),
    "step": (1, 64, 64, 64, {}, 2),
    "dssim": (7, 48, 64, 72, {"lambda_dssim": 0.2}, 8),
    "depth": (9, 48, 64, 64, {"lambda_depth": 0.5, "depth_scale": 2.0}, 10),
    "two_cameras": (3, 32, 64, 64, {}, 4),
    "two_focals": (5, 32, 64, 64, {}, 6),
}
RENDER_CASES = ("render", "odd_n", "strided_rows")
BATCH_CASES = ("two_cameras", "two_focals")   # two cameras: n_data 2 only


def run_ranks(fn, world: int, tmp_path, *args, timeout=JOIN_TIMEOUT):
    """Run ``fn(rank, world, url, *args)`` in ``world`` spawned processes
    with a ``file://`` rendezvous ``url`` under ``tmp_path``; returns each
    rank's return value, by rank.  Fails if a rank raises, exits otherwise
    than with 0, or is still running after ``timeout`` seconds (then every
    rank is killed)."""
    ctx = multiprocessing.get_context("spawn")
    url = f"file://{tmp_path}/rendezvous"
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, rank, world, url, queue, args))
             for rank in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in procs:
            rank, ok, value = queue.get(timeout=timeout)
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    except Exception as exc:           # queue.Empty: a rank hung
        errors.append(f"no result within {timeout} s: {exc!r}")
    finally:
        for p in procs:
            p.join(timeout=10 if not errors else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert not errors, "\n".join(errors)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [results[r] for r in range(world)]


def _numpy(x):
    """Tensors (in dicts, lists and tuples) as arrays: a tensor sent
    through a queue would live in the exiting rank's shared memory."""
    if torch.is_tensor(x):
        return x.detach().numpy()
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_numpy(v) for v in x)
    return x


def _rank_entry(fn, rank, world, url, queue, args):
    torch.set_num_threads(1)
    try:
        queue.put((rank, True, _numpy(fn(rank, world, url, *args))))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise


def _scene(seed: int, n: int, width: int, height: int):
    rng = np.random.default_rng(seed)
    cam = scenes.example_camera(width=width, height=height)
    pts, shs, scales, rotations, opacities = scenes.random_scene(rng, n=n)
    params = {"positions": pts, "scales": scales, "rotations": rotations,
              "opacities": opacities, "shs": shs}
    return cam, {k: torch.tensor(v) for k, v in params.items()}


def _targets(case: str):
    """(targets (B, H, W, 3), depth targets, depth masks, tangents (B, 2))
    of a step case; B = 2 for the batch cases, else 1."""
    seed, n, width, height, cfg, tseed = CASES[case]
    cam = scenes.example_camera(width=width, height=height)
    rng = np.random.default_rng(tseed)
    tans = [(cam["tan_fovx"], cam["tan_fovy"])]
    if case in BATCH_CASES:
        t = rng.uniform(0, 1, (2, height, width, 3)).astype(np.float32)
        if case == "two_focals":
            tans.append((cam["tan_fovx"] * 1.4, cam["tan_fovy"] * 0.8))
        else:
            tans.append(tans[0])
    else:
        t = rng.uniform(0, 1, (1, height, width, 3)).astype(np.float32)
    depth = mask = None
    if "lambda_depth" in cfg:
        depth = rng.uniform(0, 1, (1, height, width)).astype(np.float32)
        mask = (rng.uniform(0, 1, (1, height, width)) > 0.3).astype(
            np.float32)
        depth, mask = torch.tensor(depth), torch.tensor(mask)
    return torch.tensor(t), depth, mask, tans


def _cam_tensors(cam):
    return tuple(torch.tensor(cam[k]) for k in ("view", "proj", "campos"))


def _mesh_cases(n_data: int):
    return [c for c in CASES if c not in BATCH_CASES or n_data == 2]


def _sharded_cases(rank, world, url, n_data, n_model):
    """Every case of one mesh on this rank: renders (the image) and steps
    (loss, whole position gradients, whole stepped parameters, counts)."""
    from gstpu_torch.parallel import make_mesh
    from gstpu_torch.parallel import collectives
    from gstpu_torch.parallel.multihost import shard_rows
    from gstpu_torch.parallel.sharded import (make_sharded_render,
                                              make_sharded_train_step,
                                              pad_targets_to_grid)

    dist.init_process_group("gloo", init_method=url, world_size=world,
                            rank=rank)
    try:
        mesh = make_mesh(n_data=n_data, n_model=n_model)
        out = {"coords": mesh.coords}
        for case in _mesh_cases(n_data):
            seed, n, width, height, cfg, _ = CASES[case]
            cam, params = _scene(seed, n, width, height)
            settings = RenderSettings(width=width, height=height,
                                      pair_capacity=1 << 13)
            alive = torch.ones(n, dtype=torch.bool)
            view, proj, campos = _cam_tensors(cam)
            if case in RENDER_CASES:
                run = make_sharded_render(settings, mesh, cam["tan_fovx"],
                                          cam["tan_fovy"])
                with warnings.catch_warnings():
                    # the padding keeps the sliced chains on
                    warnings.simplefilter("error", RuntimeWarning)
                    out[case] = run(params, alive, view, proj, campos,
                                    torch.tensor(BG))
                continue
            config = GSConfig(**cfg)
            targets, depth, mask, tans = _targets(case)
            b = n_data
            if targets.shape[0] != b:
                targets = targets.expand(b, -1, -1, -1)
            if len(tans) != b:
                tans = tans * b
            extra = ()
            if depth is not None:
                extra = tuple(pad_targets_to_grid(x.expand(b, -1, -1),
                                                  settings, n_model)
                              for x in (depth, mask))
            step = make_sharded_train_step(settings, config, mesh)
            shard = {k: shard_rows(x, mesh) for k, x in params.items()}
            new_p, _, loss, pos_grads, counts, it = step(
                shard, init_adam_state(shard), shard_rows(alive, mesh),
                view[None].expand(b, -1, -1), proj[None].expand(b, -1, -1),
                campos[None].expand(b, -1), [t[0] for t in tans],
                [t[1] for t in tans],
                pad_targets_to_grid(targets, settings, n_model), 0, *extra)
            whole = collectives.all_gather_many(
                [pos_grads] + list(new_p.values()), mesh.model)
            out[case] = {"loss": float(loss), "pos_grads": whole[0],
                         "params": dict(zip(new_p, whole[1:])),
                         "counts": counts.tolist(), "iteration": it}
        return out
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded_results(tmp_path_factory):
    """{mesh name: every rank's results}, one process group per mesh."""
    out = {}
    for name, (n_data, n_model) in MESHES.items():
        out[name] = run_ranks(_sharded_cases, n_data * n_model,
                              tmp_path_factory.mktemp(name), n_data, n_model)
    return out


def _single_render(case, tans=None):
    seed, n, width, height, _, _ = CASES[case]
    cam, params = _scene(seed, n, width, height)
    tx, ty = tans or (cam["tan_fovx"], cam["tan_fovy"])
    settings = RenderSettings(width=width, height=height,
                              pair_capacity=1 << 13)
    params = {k: x.requires_grad_(True) for k, x in params.items()}
    image, depth, _ = render(settings, tx, ty, 1.0, *params.values(),
                             *_cam_tensors(cam), torch.tensor(BG),
                             torch.ones(n, dtype=torch.bool))
    return params, image, depth


def _single_step(case):
    """(loss, gradients, Adam-stepped parameters) of the single-device step;
    for the batch cases the mean loss over the two cameras."""
    config = GSConfig(**CASES[case][4])
    targets, depth, mask, tans = _targets(case)
    losses, grads = [], None
    for i, tan in enumerate(tans):
        params, image, rdepth = _single_render(case, tan)
        loss = combined_loss(image, targets[i], config.lambda_dssim)
        if depth is not None:
            loss = loss + config.lambda_depth * depth_loss(
                rdepth, config.depth_scale * depth[0], mask[0])
        g = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
    grads = {k: g / len(tans) for k, g in zip(params, grads)}
    params = {k: x.detach() for k, x in params.items()}
    stepped, _ = adam_step(params, grads, init_adam_state(params),
                           schedule_lrs(config, 0), 0, config)
    return float(np.mean(losses)), grads, stepped


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", RENDER_CASES)
def test_sharded_render_matches_single_device(sharded_results, mesh, case):
    _, want, _ = _single_render(case)
    for rank in sharded_results[mesh]:
        np.testing.assert_allclose(rank[case],
                                   want.detach().numpy(), atol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_step_matches_single_device(sharded_results, mesh):
    want_loss, want_grads, want_params = _single_step("step")
    for rank in sharded_results[mesh]:
        got = rank["step"]
        assert got["iteration"] == 1
        assert abs(got["loss"] - want_loss) < 1e-6
        np.testing.assert_allclose(got["pos_grads"],
                                   want_grads["positions"].numpy(), atol=1e-6)
        for k, x in want_params.items():
            # 3e-6: the reduce-scatter reassociates the gradient sums
            np.testing.assert_allclose(got["params"][k], x.numpy(),
                                       atol=3e-6, err_msg=k)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", ["dssim", "depth"])
def test_sharded_step_dssim_and_depth_match_single_device(sharded_results,
                                                          mesh, case):
    want_loss, want_grads, _ = _single_step(case)
    want = want_grads["positions"].numpy()
    scale = max(float(np.abs(want).max()), 1e-8)
    for rank in sharded_results[mesh]:
        got = rank[case]
        assert abs(got["loss"] - want_loss) < 1e-5
        np.testing.assert_allclose(got["pos_grads"] / scale,
                                   want / scale, atol=2e-5)


@pytest.mark.parametrize("case", BATCH_CASES)
def test_sharded_batch_loss_is_the_camera_mean(sharded_results, case):
    want_loss, _, _ = _single_step(case)
    if case == "two_focals":
        targets, _, _, tans = _targets(case)
        # the second focal changes the render
        _, a, _ = _single_render(case, tans[1])
        _, b, _ = _single_render(case)
        gap = (l1_loss(a, targets[1]) - l1_loss(b, targets[1])).detach()
        assert abs(float(gap)) > 1e-5
    for rank in sharded_results["2x2"]:
        assert abs(rank[case]["loss"] - want_loss) < 2e-6


def test_mesh_coordinates_follow_jax_reshape(sharded_results):
    for name, (n_data, n_model) in MESHES.items():
        coords = [r["coords"] for r in sharded_results[name]]
        assert coords == [divmod(r, n_model)
                          for r in range(n_data * n_model)]


@pytest.mark.parametrize("n_model", [1, 2, 3])
@pytest.mark.parametrize("channels", [None, 3])
def test_pad_targets_and_band_settings_match_gstpu(n_model, channels):
    """``pad_targets_to_grid`` (built from ``target_band``, the Trainer's
    band of one target) and ``band_settings`` equal gstpu's."""
    import jax.numpy as jnp

    from gstpu.config import RenderSettings as JaxSettings
    from gstpu.parallel.sharded import band_settings as jax_band_settings
    from gstpu.parallel.sharded import pad_targets_to_grid as jax_pad
    from gstpu_torch.parallel.sharded import (band_settings,
                                              pad_targets_to_grid)

    settings = RenderSettings(width=80, height=72, pair_capacity=1 << 10)
    shape = (2, 72, 80) + ((channels,) if channels else ())
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = pad_targets_to_grid(torch.tensor(x), settings, n_model).numpy()
    want = np.asarray(jax_pad(jnp.asarray(x), JaxSettings(
        width=80, height=72, pair_capacity=1 << 10), n_model))
    np.testing.assert_array_equal(got, want)
    b = band_settings(settings, n_model)
    jb = jax_band_settings(JaxSettings(width=80, height=72,
                                       pair_capacity=1 << 10), n_model)
    for f in ("tile_rows", "row_stride", "shard_axis", "band_rows",
              "band_tiles"):
        assert getattr(b, f) == getattr(jb, f), f


def _mesh_trainer(rank, world, url, dataset, out, config):
    from gstpu_torch.parallel import make_mesh
    from gstpu_torch.parallel.multihost import init_distributed
    from gstpu_torch.trainer import Trainer

    assert init_distributed(url, world, rank, device="cpu") == "gloo"
    try:
        trainer = Trainer(dataset, out, config, device="cpu",
                          mesh=make_mesh(n_data=1, n_model=world))
        trainer.train()
        return {"losses": trainer.losses, "digests": trainer.densify_digests,
                "steps_run": trainer.steps_run,
                "step_ms": trainer.step_ms(),
                "shard": trainer.model.capacity}
    finally:
        dist.destroy_process_group()


def test_mesh_trainer_matches_single_device_trainer(tmp_path):
    import json

    from gstpu_torch.trainer import Trainer
    from scripts.make_tiny_nerf import make_dataset

    dataset = tmp_path / "tiny"
    make_dataset(dataset, size=32, n_train=3, n_val=2)
    config = GSConfig(num_points=64, num_iterations=10, save_interval=1 << 30,
                      densify_from_iter=1, densification_interval=3,
                      densify_grad_threshold=5e-5, min_valid_points=1,
                      eval_views=1)
    single = Trainer(str(dataset), str(tmp_path / "single"), config,
                     device="cpu")
    single.train()
    ranks = run_ranks(_mesh_trainer, 2, tmp_path, str(dataset),
                      str(tmp_path / "mesh"), config)

    def events(name, kind):
        with open(tmp_path / name / "metrics.jsonl") as f:
            return [e for e in map(json.loads, f) if e.get("event") == kind]

    want = events("single", "densify")
    assert [e["iteration"] for e in want] == [3, 6, 9]
    assert any(e["split"] or e["cloned"] for e in want)
    assert events("mesh", "densify") == want
    assert len(events("mesh", "eval_full")) == 1
    for r in ranks:
        assert r["steps_run"] == single.steps_run
        assert len(r["step_ms"]) == r["steps_run"]
        assert all(t > 0 for t in r["step_ms"])
        assert r["shard"] * 2 == single.model.capacity
        assert r["digests"] == ranks[0]["digests"] and len(r["digests"]) == 3
        np.testing.assert_allclose(r["losses"], single.losses, rtol=1e-4)


# name: every rank's (host, cards), the backend, every rank's card index
HOST_TABLES = {
    "one_host_4_cards": ([("a", 4)] * 4, "nccl", [0, 1, 2, 3]),
    "two_hosts_4_cards": ([("a", 4)] * 4 + [("b", 4)] * 4, "nccl",
                          [0, 1, 2, 3, 0, 1, 2, 3]),
    "hosts_interleaved": ([("a", 4), ("b", 4)] * 4, "nccl",
                          [0, 0, 1, 1, 2, 2, 3, 3]),
    "shared_card": ([("a", 1)] * 2, "gloo", [0, 0]),
    "one_host_short": ([("a", 4)] * 4 + [("b", 2)] * 4, "gloo",
                       [0, 1, 2, 3, 0, 1, 0, 1]),
    "cpu": ([("a", 0)] * 2, "gloo", None),
}


@pytest.mark.parametrize("case", HOST_TABLES)
def test_backend_and_card_follow_each_hosts_ranks(case):
    """Each rank publishes its (host, cards) through one store, in its own
    thread; every rank reads the same table, and the backend and each
    rank's card follow the ranks of its own host, not the world size."""
    import threading

    from gstpu_torch.parallel.multihost import (choose_backend, host_table,
                                                local_index)

    hosts, backend, cards = HOST_TABLES[case]
    store = dist.HashStore()
    tables = [None] * len(hosts)

    def publish(rank):
        tables[rank] = host_table(store, rank, len(hosts), *hosts[rank])

    threads = [threading.Thread(target=publish, args=(r,))
               for r in range(len(hosts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert tables == [hosts] * len(hosts)
    assert choose_backend(hosts) == backend
    if cards is not None:
        assert [local_index(hosts, r) % n
                for r, (_, n) in enumerate(hosts)] == cards


def vs_gstpu_inputs():
    """The inputs of the step held against gstpu's sharded step: 40
    Gaussians before the example camera at 32x32, two cameras' targets,
    L1 + 0.2 DSSIM."""
    cam, params = _scene(21, 40, 32, 32)
    rng = np.random.default_rng(22)
    targets = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    config = GSConfig(lambda_dssim=0.2)
    settings = RenderSettings(width=32, height=32, pair_capacity=1 << 12)
    return cam, {k: x.numpy() for k, x in params.items()}, targets, config, \
        settings


def _vs_gstpu_step(rank, world, url):
    """One sharded step of the port on a 2x2 mesh (vs_gstpu_inputs)."""
    from gstpu_torch.parallel import make_mesh
    from gstpu_torch.parallel import collectives
    from gstpu_torch.parallel.multihost import shard_rows
    from gstpu_torch.parallel.sharded import (make_sharded_train_step,
                                              pad_targets_to_grid)

    dist.init_process_group("gloo", init_method=url, world_size=world,
                            rank=rank)
    try:
        mesh = make_mesh(n_data=2, n_model=2)
        cam, params, targets, config, settings = vs_gstpu_inputs()
        shard = {k: shard_rows(torch.tensor(x), mesh)
                 for k, x in params.items()}
        view, proj, campos = _cam_tensors(cam)
        step = make_sharded_train_step(settings, config, mesh)
        new_p, _, loss, pos_grads, counts, _ = step(
            shard, init_adam_state(shard),
            torch.ones(len(shard["positions"]), dtype=torch.bool),
            view[None].expand(2, -1, -1), proj[None].expand(2, -1, -1),
            campos[None].expand(2, -1), [cam["tan_fovx"]] * 2,
            [cam["tan_fovy"]] * 2,
            pad_targets_to_grid(torch.tensor(targets), settings, 2), 0)
        whole = collectives.all_gather_many(
            [pos_grads] + list(new_p.values()), mesh.model)
        return {"loss": float(loss), "pos_grads": whole[0],
                "params": dict(zip(new_p, whole[1:])),
                "counts": counts.tolist()}
    finally:
        dist.destroy_process_group()
