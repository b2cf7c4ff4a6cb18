"""User-facing render API mirroring the reference ``render_gaussians``, and
the example render.

Port of ``gstpu/render.py`` and of the repo's ``render.py``.  The reference
quirks are kept: ``colors``, ``prefiltered`` and ``antialiasing`` are
accepted and never used (colors always come from SH evaluation), and
``clamped`` must be True.

    python -m gstpu_torch.render [--device cpu] [--out example_render.png]

renders the reference's three-Gaussian scene at 1800x1800 and writes the
PNG (default device: the CUDA card).
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import numpy as np
import torch

from gstpu_torch.config import RenderSettings
from gstpu_torch.convert import pad_shs
from gstpu_torch.ops.rasterize import render_forward
from gstpu_torch.utils import tracing
from gstpu_torch.utils.camera import projection_matrix, world_to_view


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a CUDA device without CUDA raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return device


def default_pair_capacity(n: int) -> int:
    """24 pairs per Gaussian, rounded up to a power of two, at least 4096."""
    return max(1 << 12, int(2 ** np.ceil(np.log2(max(n * 24, 1)))))


def render_gaussians(background, means3D, colors=None, opacity=None,
                     scales=None, rotations=None, scale_modifier=1.0,
                     viewmatrix=None, projmatrix=None,
                     tan_fovx=0.5, tan_fovy=0.5,
                     image_height=256, image_width=256,
                     sh=None, degree=3, campos=None,
                     prefiltered=False, antialiasing=False, clamped=True,
                     debug=False, pair_capacity=None, alive=None,
                     device=None):
    """Render 3D Gaussians; returns (image (H,W,3), depth (H,W), aux).

    Inputs may be NumPy arrays or tensors; they are moved to ``device``
    (default: the CUDA card).  On CUDA the compositing runs the hand-written
    kernel, on the CPU its plain PyTorch version.  If the pair list
    overflows ``pair_capacity`` the frame is rendered again with the next
    power of two above the pair count.
    """
    del colors, prefiltered, antialiasing  # dead reference arguments
    if not clamped:
        raise NotImplementedError("clamped=False is unused by the reference "
                                  "training path and is not supported")
    device = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    with tracing.span("render.inputs"):
        means3D = f32(means3D)
        n = means3D.shape[0]
        shs = pad_shs(f32(sh))
        if alive is not None:
            alive = torch.as_tensor(alive, dtype=torch.bool, device=device)
        args = (means3D, f32(scales), f32(rotations), f32(opacity).reshape(n),
                shs, f32(viewmatrix), f32(projmatrix), f32(campos),
                f32(background), alive)
    if pair_capacity is None:
        pair_capacity = default_pair_capacity(n)
    settings = RenderSettings(width=int(image_width), height=int(image_height),
                              sh_degree=int(degree),
                              pair_capacity=int(pair_capacity))

    def frame():
        return render_forward(settings, float(tan_fovx), float(tan_fovy),
                              float(scale_modifier), *args)

    image, depth, aux = frame()
    with tracing.span("render.regrow"):
        while True:
            num_pairs = int(aux.num_pairs)
            tracing.COUNTERS.add("render.pairs", num_pairs)
            tracing.COUNTERS.add("render.pair_slots", settings.pair_capacity)
            if num_pairs <= settings.pair_capacity:
                break
            # the pair list overflowed: grow to the next power of two and
            # render again
            settings = dataclasses.replace(
                settings, pair_capacity=int(2 ** np.ceil(np.log2(num_pairs))))
            image, depth, aux = frame()
    if debug:
        print(f"gstpu_torch render: {image_width}x{image_height}, {n} "
              f"gaussians, pairs={num_pairs}/{settings.pair_capacity}")
    return image, depth, aux


EXAMPLE_SIZE = 1800


def setup_example_scene(image_width=EXAMPLE_SIZE, image_height=EXAMPLE_SIZE,
                        fovx=45.0, fovy=45.0, znear=0.01, zfar=100.0):
    """The reference smoke-test scene: three Gaussians in a row before the
    camera, with its quirk of passing the field of view in radians-as-degrees
    (45.0) straight into tan().  Returns (points, shs, scales, rotations,
    opacities, camera dict)."""
    T = np.array([0, 0, 5], dtype=np.float32)
    R = np.array([[1, 0, 0], [0, 1, 0], [0, 0, -1]], dtype=np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = R
    w2c[:3, 3] = T
    w2c = w2c.T

    view_matrix = world_to_view(R=R, t=T)
    proj = projection_matrix(fovx=fovx, fovy=fovy, znear=znear, zfar=zfar).T
    full_proj = w2c @ proj
    camera_center = np.linalg.inv(w2c)[3, :3]
    tan_fovx = math.tan(fovx * 0.5)
    tan_fovy = math.tan(fovy * 0.5)

    pts = np.array([[-5, 0, -10], [0, 0, -10], [5, 0, -10]], dtype=np.float32)
    n = len(pts)
    shs = np.array([[0.71734341, 0.91905449, 0.49961076],
                    [0.08068483, 0.82132256, 0.01301602],
                    [0.8335743, 0.31798138, 0.19709007],
                    [0.82589597, 0.28206231, 0.790489],
                    [0.24008527, 0.21312673, 0.53132892],
                    [0.19493135, 0.37989934, 0.61886235],
                    [0.98106522, 0.28960672, 0.57313965],
                    [0.92623716, 0.46034381, 0.5485369],
                    [0.81660616, 0.7801104, 0.27813915],
                    [0.96114063, 0.69872817, 0.68313804],
                    [0.95464185, 0.21984855, 0.92912192],
                    [0.23503135, 0.29786121, 0.24999751],
                    [0.29844887, 0.6327788, 0.05423596],
                    [0.08934335, 0.11851827, 0.04186001],
                    [0.59331831, 0.919777, 0.71364335],
                    [0.83377388, 0.40242542, 0.8792624]] * n,
                   dtype=np.float32).reshape(n, 16, 3)
    opacities = np.ones((n, 1), dtype=np.float32)
    scales = np.ones((n, 3), dtype=np.float32)
    rotations = np.zeros((n, 4), dtype=np.float32)
    rotations[:, 3] = 1.0
    camera = {
        "view_matrix": view_matrix, "full_proj_matrix": full_proj,
        "camera_center": camera_center, "tan_fovx": tan_fovx,
        "tan_fovy": tan_fovy, "width": image_width, "height": image_height,
    }
    return pts, shs, scales, rotations, opacities, camera


def render_example(size: int = EXAMPLE_SIZE, device=None, debug=False):
    """(image, depth, aux) of the example scene at ``size`` x ``size``."""
    pts, shs, scales, rotations, opacities, cam = setup_example_scene(
        size, size)
    return render_gaussians(
        background=np.zeros(3, np.float32), means3D=pts, opacity=opacities,
        scales=scales, rotations=rotations, viewmatrix=cam["view_matrix"],
        projmatrix=cam["full_proj_matrix"], tan_fovx=cam["tan_fovx"],
        tan_fovy=cam["tan_fovy"], image_height=size, image_width=size,
        sh=shs, degree=3, campos=cam["camera_center"], debug=debug,
        device=device)


def main(argv=None) -> np.ndarray:
    """Render the example scene and write it as a PNG; returns the 8-bit
    image."""
    from gstpu_torch.utils.image import imwrite

    parser = argparse.ArgumentParser(
        description="Render the three-Gaussian example scene")
    parser.add_argument("--out", default="example_render.png")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "runs the plain PyTorch path)")
    args = parser.parse_args(argv)
    print("Created example scene with 3 Gaussians")
    image, _, _ = render_example(EXAMPLE_SIZE, args.device, debug=True)
    print("Rendering completed")
    img8 = (np.clip(image.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
    imwrite(args.out, img8)
    print(f"Rendered image saved to {args.out}")
    return img8


if __name__ == "__main__":
    main()
