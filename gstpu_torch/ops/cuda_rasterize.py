"""Forward and backward compositing through the hand-written CUDA kernels.

Counterparts of ``gstpu/ops/pallas_rasterize.py``'s two TPU kernels:

- K1, ``csrc/rasterize_fwd.cu`` (``_fwd_kernel``), behind
  ``composite_forward``;
- K2, ``csrc/rasterize_bwd.cu`` (``_bwd_kernel``), behind
  ``composite_backward``, whose epilogue (``rasterize.segment_sum_pair_rows``)
  stays PyTorch as the JAX package's does.

Both include ``csrc/composite_common.cuh``; ``ops/cuda_build.py`` builds
and loads them.

The wrappers take the arguments and return the outputs of the plain
versions in ``ops/rasterize.py``.  For tensors on the CPU they run those
plain versions; for CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gstpu_torch.config import RenderSettings, TILE_PIXELS
from gstpu_torch.ops import cuda_build, rasterize
from gstpu_torch.ops.binning import Pairs
from gstpu_torch.ops.preprocess import PreprocessOut

# Kernel launches made by the wrappers (one per call on CUDA tensors).
LAUNCHES = {"rasterize_fwd": 0, "rasterize_bwd": 0}


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = cuda_build.library(name)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "rasterize_fwd":
        lib.gstpu_rasterize_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                            i32, ptr, ptr, ptr, ptr, i32, ptr]
        lib.gstpu_rasterize_fwd.restype = i32
    else:
        lib.gstpu_rasterize_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32,
                                            i32, i32, ptr, i32, ptr]
        lib.gstpu_rasterize_bwd.restype = i32
    return lib


def _gaussian_table(prep: PreprocessOut) -> torch.Tensor:
    """Packed (N, 10) f32 records: x, y, conic a/b/c, opacity, r, g, b and
    inverse depth (``depth == 0 -> 1`` guard, as the plain version)."""
    inv_depth = 1.0 / torch.where(prep.depth == 0.0, 1.0, prep.depth)
    return torch.cat([prep.xy, prep.conic, prep.opacity[:, None], prep.rgb,
                      inv_depth[:, None]], dim=1).contiguous()


def _check(name: str, x: torch.Tensor, dtype, device, shape=None) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(prep: PreprocessOut, pairs: Pairs,
                  settings: RenderSettings) -> torch.device:
    """Device of the inputs of a kernel launch; raises on a tensor it does
    not take."""
    dev = prep.xy.device
    if dev.type != "cuda":
        raise ValueError(f"no compositing kernel for device {dev}")
    t = settings.band_tiles
    n = prep.xy.shape[0]
    for name in ("xy", "conic", "opacity", "rgb", "depth"):
        x = getattr(prep, name)
        if x.device != dev or x.dtype != torch.float32 or x.shape[0] != n:
            raise ValueError(f"prep.{name}: expected {n} float32 rows on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    _check("pairs.gauss_id", pairs.gauss_id, torch.int32, dev)
    if pairs.gauss_id.dim() != 1:
        raise ValueError("pairs.gauss_id must be 1-D")
    _check("pairs.tile_start", pairs.tile_start, torch.int32, dev, (t,))
    _check("pairs.tile_count", pairs.tile_count, torch.int32, dev, (t,))
    return dev


def composite_forward(prep: PreprocessOut, pairs: Pairs,
                      settings: RenderSettings, row0: int = 0):
    """Forward compositing; same contract as ``rasterize.composite_forward``.

    Returns color (T,256,3), inverse depth (T,256), final transmittance
    (T,256) and n_contrib (T,256) int32 for the T tiles of the band.
    """
    if prep.xy.device.type == "cpu":
        return rasterize.composite_forward(prep, pairs, settings, row0=row0)
    dev = _check_inputs(prep, pairs, settings)
    t = settings.band_tiles
    table = _gaussian_table(prep)
    color = torch.empty((t, TILE_PIXELS, 3), dtype=torch.float32, device=dev)
    dacc = torch.empty((t, TILE_PIXELS), dtype=torch.float32, device=dev)
    final_t = torch.empty((t, TILE_PIXELS), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((t, TILE_PIXELS), dtype=torch.int32, device=dev)
    if t == 0:
        return color, dacc, final_t, n_contrib
    lib = _library("rasterize_fwd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.gstpu_rasterize_fwd(
        table.data_ptr(), pairs.gauss_id.data_ptr(),
        pairs.tile_start.data_ptr(), pairs.tile_count.data_ptr(),
        t, settings.grid_x, int(row0), settings.row_stride,
        color.data_ptr(), dacc.data_ptr(), final_t.data_ptr(),
        n_contrib.data_ptr(), cuda_build.device_index(dev), stream)
    cuda_build.raise_on_error(lib, "rasterize_fwd", err)
    LAUNCHES["rasterize_fwd"] += 1
    return color, dacc, final_t, n_contrib


def backward_rows(prep: PreprocessOut, pairs: Pairs, settings: RenderSettings,
                  color_pre_bg, final_t, dl_dpix, bg, row0: int = 0,
                  depth_acc=None, dl_ddepth=None) -> torch.Tensor:
    """Launch K2 on CUDA tensors: the (K2 + 1, 10) per-pair gradient rows
    (fields ``rasterize.PAIR_ROW_FIELDS``) that ``composite_backward`` sums
    per Gaussian.  Rows of pairs past a tile's early exit, of slots of no
    tile, and the last row, are zero.  Arguments as ``composite_backward``.
    """
    dev = _check_inputs(prep, pairs, settings)
    t = settings.band_tiles
    if dl_ddepth is None:
        dl_ddepth = torch.zeros_like(final_t)
        depth_acc = torch.zeros_like(final_t)
    for name, x, shape in (
            ("color_pre_bg", color_pre_bg, (t, TILE_PIXELS, 3)),
            ("dl_dpix", dl_dpix, (t, TILE_PIXELS, 3)),
            ("final_t", final_t, (t, TILE_PIXELS)),
            ("depth_acc", depth_acc, (t, TILE_PIXELS)),
            ("dl_ddepth", dl_ddepth, (t, TILE_PIXELS)),
            ("bg", bg, (3,))):
        _check(name, x, torch.float32, dev, shape)

    ctot_dot = torch.sum(color_pre_bg * dl_dpix, dim=-1) + depth_acc * dl_ddepth
    bg_dot = torch.sum(bg[None, None, :] * dl_dpix, dim=-1)
    pix_in = torch.stack([ctot_dot, bg_dot, final_t, dl_dpix[:, :, 0],
                          dl_dpix[:, :, 1], dl_dpix[:, :, 2], dl_ddepth],
                         dim=1).contiguous()                   # (T, 7, 256)
    table = _gaussian_table(prep)
    k2 = pairs.gauss_id.shape[0]
    rows = torch.zeros((k2 + 1, len(rasterize.PAIR_ROW_FIELDS)),
                       dtype=torch.float32, device=dev)
    if t == 0:
        return rows
    lib = _library("rasterize_bwd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.gstpu_rasterize_bwd(
        table.data_ptr(), pairs.gauss_id.data_ptr(),
        pairs.tile_start.data_ptr(), pairs.tile_count.data_ptr(),
        pix_in.data_ptr(), t, settings.grid_x, int(row0),
        settings.row_stride, rows.data_ptr(), cuda_build.device_index(dev), stream)
    cuda_build.raise_on_error(lib, "rasterize_bwd", err)
    LAUNCHES["rasterize_bwd"] += 1
    return rows


def composite_backward(prep: PreprocessOut, pairs: Pairs,
                       settings: RenderSettings, color_pre_bg, final_t,
                       dl_dpix, bg, row0: int = 0, depth_acc=None,
                       dl_ddepth=None):
    """Backward compositing; same contract as
    ``rasterize.composite_backward``: K2 (``backward_rows``), then the
    epilogue ``rasterize.segment_sum_pair_rows``.

    Returns (dL_dcolor (N,3), dL_dmean2d_ndc (N,2), dL_dconic (N,3),
    dL_dopacity (N,), dL_dinvdepth (N,)).
    """
    if prep.xy.device.type == "cpu":
        return rasterize.composite_backward(
            prep, pairs, settings, color_pre_bg, final_t, dl_dpix, bg,
            row0=row0, depth_acc=depth_acc, dl_ddepth=dl_ddepth)
    rows = backward_rows(prep, pairs, settings, color_pre_bg, final_t,
                         dl_dpix, bg, row0=row0, depth_acc=depth_acc,
                         dl_ddepth=dl_ddepth)
    return rasterize.segment_sum_pair_rows(rows, pairs, settings)
