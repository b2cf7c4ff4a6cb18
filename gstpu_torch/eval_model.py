"""Evaluate a trained point cloud against a dataset split.

Port of ``scripts/eval_model.py``, the counterpart of the official 3DGS
``render.py`` + ``metrics.py``:

    python -m gstpu_torch.eval_model --ply out/point_cloud/iteration_6999/point_cloud.ply \\
        --dataset ./data/lego [--split test] [-r 2] [--save-renders DIR]

Prints one JSON line with the mean PSNR and SSIM over the split (and writes
the rendered views if asked).  NeRF-synthetic datasets and COLMAP captures
are told apart by the port's loaders; any 3DGS-schema PLY is read through
``utils/ply.render_space_params``.  A view whose pair list exceeds the
capacity is rendered again at a larger one, never scored on dropped tiles.
``--device cpu`` runs the plain PyTorch path (default: the CUDA card).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from gstpu_torch.config import RenderSettings
from gstpu_torch.data.colmap import ColmapDataset, is_colmap_dataset
from gstpu_torch.data.nerf import NerfSyntheticDataset
from gstpu_torch.ops.losses import psnr, ssim
from gstpu_torch.ops.rasterize import render_forward
from gstpu_torch.render import resolve_device
from gstpu_torch.utils.image import imwrite
from gstpu_torch.utils.ply import load_ply, render_space_params

FIRST_PAIR_CAPACITY = 1 << 20


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Mean PSNR and SSIM of a point cloud over a split")
    ap.add_argument("--ply", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--split", default="test")
    ap.add_argument("--resolution", "-r", type=int, default=1)
    ap.add_argument("--max-views", type=int, default=None)
    ap.add_argument("--save-renders", default=None,
                    help="directory for the rendered PNGs")
    ap.add_argument("--white-background", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path)")
    ap.add_argument("--activated", action="store_true",
                    help="the PLY stores log-scales/logit-opacities "
                         "(official 3DGS / gstpu --activated exports)")
    return ap.parse_args(argv)


def regrown_capacity(num_pairs: int) -> int:
    """The capacity after an overflow: 1.5 x the pairs, up to 32768."""
    return -(-num_pairs * 3 // 2 // 32768) * 32768


def main(argv=None) -> dict:
    """Evaluate, print the JSON line and return it as a dict."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    ds_cls = (ColmapDataset if is_colmap_dataset(args.dataset)
              else NerfSyntheticDataset)
    ds = ds_cls(args.dataset, args.split, downscale=args.resolution,
                white_background=args.white_background)

    params = load_ply(args.ply)
    if args.activated:  # explicit override for comment-less foreign PLYs
        params["parameterization"] = "activated"
    params = render_space_params(params)
    n = params["positions"].shape[0]

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    arrs = (t(params["positions"]), t(params["scales"]),
            t(params["rotations"]), t(params["opacities"]),
            t(params["shs"]).reshape(n, 16, 3))
    bg = torch.full((3,), 1.0 if args.white_background else 0.0,
                    dtype=torch.float32, device=device)
    pair_capacity = FIRST_PAIR_CAPACITY

    def render_checked(cam):
        """The view clipped to [0, 1], rendered again at a regrown capacity
        until its pair list fits (the Trainer's ``_render_full`` contract);
        the capacity carries over to the next views."""
        nonlocal pair_capacity
        view, proj, campos = (t(cam[k]) for k in (
            "world_to_camera", "full_proj_matrix", "camera_center"))
        while True:
            settings = RenderSettings(width=ds.width, height=ds.height,
                                      pair_capacity=pair_capacity,
                                      tight_radius=True)
            with torch.no_grad():
                img, _, aux = render_forward(
                    settings, cam["tan_fovx"], cam["tan_fovy"], 1.0, *arrs,
                    view, proj, campos, bg)
            num_pairs = int(aux.num_pairs)
            if num_pairs <= pair_capacity:
                return torch.clamp(img, 0.0, 1.0)
            pair_capacity = regrown_capacity(num_pairs)

    if args.save_renders:
        os.makedirs(args.save_renders, exist_ok=True)
    n_views = len(ds) if args.max_views is None \
        else min(args.max_views, len(ds))
    psnrs, ssims = [], []
    for i in range(n_views):
        img = render_checked(ds.camera(i))
        target = t(ds.image(i))
        psnrs.append(float(psnr(img, target)))
        ssims.append(float(ssim(img, target, clamp_sigma=True)))
        if args.save_renders:
            imwrite(os.path.join(args.save_renders, f"{i:05d}.png"),
                    (img.cpu().numpy() * 255).astype(np.uint8))

    result = {
        "ply": args.ply, "split": args.split, "views": n_views,
        "n_gaussians": n, "resolution": f"{ds.width}x{ds.height}",
        "psnr": round(float(np.mean(psnrs)), 4),
        "ssim": round(float(np.mean(ssims)), 4),
        "psnr_per_view_min": round(float(np.min(psnrs)), 4),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
