"""Preprocess through the hand-written CUDA kernel of ``csrc/preprocess.cu``.

``preprocess`` is the one entry that the render's forward
(``ops/rasterize.py::_render_fwd``) goes through.  For tensors on the CPU
it runs the plain version, ``ops/preprocess.py::preprocess``; for CUDA
tensors it launches the kernel, one thread a Gaussian (copying a
non-contiguous input first), or raises.  Both give the same
``PreprocessOut``: the same fields, dtypes, shapes and bits
(the kernel's rgb and clamped of an invisible Gaussian are +0 without its
SH row being read, which is the plain version's value for finite inputs).
``ops/cuda_build.py`` builds and loads the library.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gstpu_torch.ops import cuda_build
from gstpu_torch.ops import preprocess as plain
from gstpu_torch.ops.preprocess import PreprocessOut
from gstpu_torch.utils import tracing


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("preprocess")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gstpu_preprocess.argtypes = [ptr] * 9 + [i32] * 3 + [f32] * 7 \
        + [i32] * 2 + [ptr] * 11 + [i32, ptr]
    lib.gstpu_preprocess.restype = i32
    return lib


def preprocess(means: torch.Tensor, scales: torch.Tensor,
               rotations: torch.Tensor, opacities: torch.Tensor,
               shs: torch.Tensor, view: torch.Tensor, proj: torch.Tensor,
               campos: torch.Tensor, width: int, height: int,
               tan_fovx: float, tan_fovy: float, grid_x: int, grid_y: int,
               sh_degree: int, scale_modifier: float = 1.0,
               alive: torch.Tensor | None = None,
               tight_radius: bool = False) -> PreprocessOut:
    """``ops/preprocess.py::preprocess``'s ``PreprocessOut`` from the same
    arguments: the plain version for CPU tensors, the kernel for CUDA
    tensors."""
    args = (means, scales, rotations, opacities, shs, view, proj, campos,
            width, height, tan_fovx, tan_fovy, grid_x, grid_y, sh_degree)
    kw = dict(scale_modifier=scale_modifier, alive=alive,
              tight_radius=tight_radius)
    if means.device.type == "cpu":
        return plain.preprocess(*args, **kw)
    return _preprocess_cuda(*args, **kw)


def _preprocess_cuda(means, scales, rotations, opacities, shs, view, proj,
                     campos, width: int, height: int, tan_fovx, tan_fovy,
                     grid_x: int, grid_y: int, sh_degree: int,
                     scale_modifier=1.0, alive=None,
                     tight_radius: bool = False) -> PreprocessOut:
    dev = means.device
    if dev.type != "cuda":
        raise ValueError(f"no preprocess kernel for device {dev}")
    n = means.shape[0] if means.dim() == 2 else -1
    if n < 1:
        raise ValueError("means must be (N, 3) with at least one Gaussian, "
                         f"got shape {tuple(means.shape)}")
    if sh_degree not in (0, 1, 2, 3):
        raise ValueError(f"sh_degree {sh_degree} outside 0-3")
    # the plain version reads any layout; the kernel reads rows, so a
    # non-contiguous input (a column of the sharded path's gathered
    # parameters, a transposed view matrix) is copied first
    means, scales, rotations, opacities, shs, view, proj, campos = (
        x.contiguous() for x in (means, scales, rotations, opacities, shs,
                                 view, proj, campos))
    check = cuda_build.check_tensor
    f32 = torch.float32
    check("means", means, f32, dev, (n, 3), align=4)
    check("scales", scales, f32, dev, (n, 3), align=4)
    check("rotations", rotations, f32, dev, (n, 4), align=16)
    check("opacities", opacities, f32, dev, (n,), align=4)
    check("shs", shs, f32, dev, (n, 16, 3), align=16)
    check("view", view, f32, dev, (4, 4), align=4)
    check("proj", proj, f32, dev, (4, 4), align=4)
    check("campos", campos, f32, dev, (3,), align=4)
    if alive is not None:
        alive = alive.contiguous()
        check("alive", alive, torch.bool, dev, (n,))

    # the plain version's Python scalars, from the same double expressions
    # (math3d.compute_cov2d), rounded to float32 as PyTorch rounds them
    width_f, height_f = float(width), float(height)
    focal_x = width_f / (2.0 * tan_fovx)
    focal_y = height_f / (2.0 * tan_fovy)
    lim_x, lim_y = 1.3 * tan_fovx, 1.3 * tan_fovy

    def empty(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = PreprocessOut(
        radii=empty(n, dtype=torch.int32), xy=empty(n, 2), depth=empty(n),
        cov3d=empty(n, 6), rgb=empty(n, 3), conic=empty(n, 3),
        opacity=empty(n), tiles_touched=empty(n, dtype=torch.int32),
        rect=empty(n, 4, dtype=torch.int32), clamped=empty(n, 3),
        visible=empty(n, dtype=torch.bool))
    lib = _library()
    c_float = ctypes.c_float
    cuda_build.raise_on_error(lib, "preprocess", lib.gstpu_preprocess(
        means.data_ptr(), scales.data_ptr(), rotations.data_ptr(),
        opacities.data_ptr(), shs.data_ptr(),
        None if alive is None else alive.data_ptr(), view.data_ptr(),
        proj.data_ptr(), campos.data_ptr(), n, int(sh_degree),
        int(bool(tight_radius)), c_float(width_f), c_float(height_f),
        c_float(float(focal_x)), c_float(float(focal_y)),
        c_float(float(lim_x)), c_float(float(lim_y)),
        c_float(float(scale_modifier)), int(grid_x), int(grid_y),
        *(x.data_ptr() for x in out), cuda_build.device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream))
    tracing.COUNTERS.add("preprocess.launches")
    return out
