"""Train a 3D Gaussian Splatting model on a NeRF-synthetic or COLMAP dataset.

    python -m gstpu_torch.train --dataset ./data/lego --output ./output

The flags of the JAX package's ``train.py`` without ``--pallas`` (the
device picks the kernels); ``--save-interval``, ``--densify-from-iter`` and
``--densification-interval`` set the schedule, and ``--device cpu`` runs the
plain PyTorch path on the CPU (default: the CUDA card).

Several ranks: one process per rank, each started with the same flags and
its own ``--process-id``, for example on one host

    python -m gstpu_torch.train --n-model 2 --n-data 2 \
        --coordinator 127.0.0.1:29500 --num-processes 4 --process-id $i

for i = 0..3; ``--n-data * --n-model`` must equal ``--num-processes``.  The
last line of standard output is a JSON summary of this rank's run.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch.distributed as dist

from gstpu_torch.config import GSConfig
from gstpu_torch.parallel.multihost import distributed_config, init_distributed
from gstpu_torch.trainer import Trainer
from gstpu_torch.utils import tracing


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Train 3D Gaussian Splatting (PyTorch and CUDA)")
    parser.add_argument("--dataset", type=str, default="./data/lego",
                        help="NeRF-synthetic or COLMAP dataset directory")
    parser.add_argument("--output", type=str, default="./output")
    parser.add_argument("--iterations", type=int, default=None)
    parser.add_argument("--num-points", type=int, default=None)
    parser.add_argument("--lambda-dssim", type=float, default=None,
                        help="SSIM loss weight (official 3DGS uses 0.2; the "
                             "reference's effective value is 0)")
    parser.add_argument("--lambda-depth", type=float, default=None,
                        help="masked inverse-depth L1 weight (needs "
                             "*_depth_*.png files in the split; 0 = off)")
    parser.add_argument("--sh-warmup", type=int, default=None,
                        help="grow the active SH degree every N iterations "
                             "(official 3DGS uses 1000; 0/off = reference)")
    parser.add_argument("--opacity-reset-until", type=int, default=None,
                        help="stop the every-3000-step opacity reset at this "
                             "iteration (official 3DGS: 15000; default = the "
                             "reference's unconditional resets)")
    parser.add_argument("--activated", action="store_true",
                        help="official-3DGS parameterization (exp scales, "
                             "sigmoid opacities) instead of the reference's "
                             "raw-clamp scheme; required for --lambda-dssim "
                             "to train")
    parser.add_argument("--no-cull", action="store_true",
                        help="disable the exact per-tile pair cull "
                             "(RenderSettings.pair_cull; on by default)")
    parser.add_argument("--resume", type=int, default=None,
                        help="resume from the state saved at this iteration")
    parser.add_argument("--n-model", type=int, default=0,
                        help="shard Gaussians/tiles over this many ranks "
                             "(0 = single device)")
    parser.add_argument("--n-data", type=int, default=1,
                        help="camera-batch data parallelism (ranks used = "
                             "n_model * n_data)")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="multi-process: torch.distributed rendezvous "
                             "address host:port (or GSTPU_COORDINATOR env); "
                             "run one process per rank with matching "
                             "--num-processes/--process-id")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="multi-process: total process count "
                             "(GSTPU_NUM_PROCESSES env)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="multi-process: this process's id "
                             "(GSTPU_PROCESS_ID env)")
    parser.add_argument("--resolution", "-r", type=int, default=1,
                        help="train at 1/N of the capture resolution "
                             "(official 3DGS -r; FoV unchanged)")
    parser.add_argument("--official-split", action="store_true",
                        help="sample split children from the parent "
                             "Gaussian (official 3DGS) instead of the "
                             "reference's +-0.01 uniform jitter")
    parser.add_argument("--eval-holdout", type=int, default=None,
                        help="COLMAP captures: hold out every N-th image as "
                             "the test split (default 8, 0 trains on all)")
    parser.add_argument("--eval-views", type=int, default=None,
                        help="views per mid-training eval (default 8; <=0 "
                             "evaluates the full val split each time)")
    parser.add_argument("--random-init", action="store_true",
                        help="ignore a COLMAP dataset's SfM points and "
                             "initialize at random (the reference's Q8)")
    parser.add_argument("--save-interval", type=int, default=None,
                        help="iterations between checkpoints (default 500)")
    parser.add_argument("--densify-from-iter", type=int, default=None,
                        help="first densify iteration (exclusive; default "
                             "500)")
    parser.add_argument("--densification-interval", type=int, default=None,
                        help="iterations between densify events (default "
                             "100)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "runs the plain PyTorch path)")
    return parser.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> GSConfig:
    config = GSConfig()
    for flag, field in (("iterations", "num_iterations"),
                        ("num_points", "num_points"),
                        ("lambda_dssim", "lambda_dssim"),
                        ("lambda_depth", "lambda_depth"),
                        ("sh_warmup", "sh_degree_interval"),
                        ("opacity_reset_until", "opacity_reset_until_iter"),
                        ("eval_holdout", "eval_holdout"),
                        ("eval_views", "eval_views"),
                        ("save_interval", "save_interval"),
                        ("densify_from_iter", "densify_from_iter"),
                        ("densification_interval",
                         "densification_interval")):
        if getattr(args, flag) is not None:
            config = config.replace(**{field: getattr(args, flag)})
    if args.activated:
        # the official-3DGS opacity recipe rides with the sigmoid scheme:
        # LR 0.05 and no decay, so opacities recover from the 0.01 resets
        config = config.replace(parameterization="activated",
                                lr_opac=0.05, schedule_opac=False)
    if args.random_init:
        config = config.replace(init_from_points=False)
    if args.resolution != 1:
        config = config.replace(downscale=args.resolution)
    if args.official_split:
        config = config.replace(official_split_sampling=True)
    return config


def summary(trainer: Trainer, backend: str | None) -> dict:
    """This rank's run: its place, the steps it took and their median time
    (``Trainer.step_ms``: CUDA events on the card), this process's counters
    (``tracing.COUNTERS``: kernel launches, the bytes its collectives handed
    to the backend, pairs against pair slots, replays), and the model's
    digest after each densify event (under a mesh)."""
    mesh = trainer.mesh
    step_ms = trainer.step_ms()
    return {"rank": mesh.rank if mesh else 0,
            "mesh": mesh.shape if mesh else None, "backend": backend,
            "device": str(trainer.device), "iteration": trainer.iteration,
            "steps_run": trainer.steps_run,
            "step_ms_median": (statistics.median(step_ms)
                               if step_ms else None),
            "counters": dict(tracing.COUNTERS),
            "densify_digests": trainer.densify_digests}


def main(argv=None) -> Trainer:
    """Parse ``argv`` (default: the command line), train, print this rank's
    ``summary`` as the last line, and return the trainer."""
    args = parse_args(argv)
    config = distributed_config(args.coordinator, args.num_processes,
                                args.process_id)
    ranks = config[1] if config else 1
    if args.n_model and args.n_model * args.n_data != ranks:
        raise SystemExit(
            f"--n-data {args.n_data} x --n-model {args.n_model} = "
            f"{args.n_data * args.n_model} ranks, but {ranks} process(es) "
            "(--num-processes): one process is one rank")
    backend = init_distributed(args.coordinator, args.num_processes,
                               args.process_id, device=args.device)
    try:
        mesh = None
        if args.n_model:
            from gstpu_torch.parallel import make_mesh
            mesh = make_mesh(n_data=args.n_data, n_model=args.n_model)
        trainer = Trainer(args.dataset, args.output, config_from_args(args),
                          pair_cull=not args.no_cull, device=args.device,
                          mesh=mesh)
        if args.resume is not None:
            trainer.restore(args.resume)
        trainer.train()
        print(json.dumps(summary(trainer, backend)), flush=True)
    finally:
        if backend is not None:
            dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
