"""Train a 3D Gaussian Splatting model on a NeRF-synthetic or COLMAP dataset.

    python -m gstpu_torch.train --dataset ./data/lego --output ./output

The flags of the JAX package's ``train.py``, without ``--pallas`` (the
device picks the kernels) and the multi-device flags; ``--save-interval``,
``--densify-from-iter`` and ``--densification-interval`` set the schedule,
and ``--device cpu`` runs the plain PyTorch path on the CPU (default: the
CUDA card).
"""

from __future__ import annotations

import argparse

from gstpu_torch.config import GSConfig
from gstpu_torch.trainer import Trainer


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


def main(argv=None) -> Trainer:
    """Parse ``argv`` (default: the command line), train, and return the
    trainer."""
    args = parse_args(argv)
    trainer = Trainer(args.dataset, args.output, config_from_args(args),
                      pair_cull=not args.no_cull, device=args.device)
    if args.resume is not None:
        trainer.restore(args.resume)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
