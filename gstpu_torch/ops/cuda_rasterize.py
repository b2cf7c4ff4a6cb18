"""Forward and backward compositing through the hand-written CUDA kernels.

Counterparts of ``gstpu/ops/pallas_rasterize.py``'s two TPU kernels:

- K1, ``csrc/rasterize_fwd.cu`` (``_fwd_kernel``), behind
  ``composite_forward`` and ``composite_forward_checkpointed``;
- K2, ``csrc/rasterize_bwd.cu`` (``_bwd_kernel``), behind
  ``composite_backward``, whose epilogue (``rasterize.segment_sum_pair_rows``)
  stays PyTorch as the JAX package's does.

Both include ``csrc/composite_common.cuh``; ``ops/cuda_build.py`` builds
and loads them.

Work order and checkpoints.  A pixel's walk over its tile's pairs is
serial, so the deepest tile would set the time of a launch.  Both kernels
take the tiles deepest first (``WorkList.order``).  K2 runs one CTA per work
item (tile, segment of at most ``SEGMENT`` pairs); each item starts from the
state that K1 checkpointed at the segment's first pair (``Checkpoints``),
and K1 writes the item list beside the checkpoints.  ``_Render`` (the
differentiable render) asks K1 for checkpoints and hands them to K2.
Callers that pass none (the kernel gate, render-only calls) get the JAX
contract: K2 then walks every tile whole from T = 1, with the same kernel.

The wrappers take the arguments and return the outputs of the plain
versions in ``ops/rasterize.py``.  For tensors on the CPU they run those
plain versions, which make and read no checkpoints; for CUDA tensors they
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from gstpu_torch.config import RenderSettings, TILE_PIXELS
from gstpu_torch.ops import cuda_build, rasterize
from gstpu_torch.ops.binning import Pairs
from gstpu_torch.ops.preprocess import PreprocessOut
from gstpu_torch.utils import tracing

# Pairs per K2 work item when K1 checkpoints; a multiple of K1's batch
# (256 ran faster than 512 and 1,024 on the H100, PERF.md).
SEGMENT = 256
# K1 stages this many pairs per batch (kFwdBatch in composite_common.cuh).
FWD_BATCH = 256
# The segment of a work list with one item per tile (larger than any tile).
WHOLE_TILE = 1 << 30
# Planes of one checkpoint, in order (CkptField in composite_common.cuh).
CHECKPOINT_FIELDS = ("T", "color_r", "color_g", "color_b", "invdepth", "done")


class WorkList(NamedTuple):
    """The order of a pair list's tiles in K1 and K2, and K2's work items.

    ``order`` (T,) int32: every tile index by ``tile_count``, descending and
    stable; K1's CTAs take the tiles in this order, and K2's too when it
    walks whole tiles (``ends`` and ``items`` None, ``segment``
    ``WHOLE_TILE``).  ``ends`` (T,) int32: the inclusive prefix sum, in that
    order, of the tiles' segment counts ceil(tile_count / segment), so the
    tile of rank r owns the slots ``ends[r] - nseg + k``, k < nseg.
    ``items`` (M, 2) int32: slot b's work item (tile, k), the pairs
    ``[k * segment, min((k + 1) * segment, tile_count))``; K1 writes them
    (``work_items`` is their plain version).  M = T + K2 // segment bounds
    the number of segments (the sum of ceil(c / s) is at most T + K2 // s),
    so no count is read back to the host; K2 launches M CTAs, and those
    past ``ends[-1]`` return at once.
    """
    order: torch.Tensor
    ends: torch.Tensor | None
    items: torch.Tensor | None
    segment: int


class Checkpoints(NamedTuple):
    """K1's state at the first pair of every segment of ``work``: ``state``
    (M, 6, 256) f32, slot b holding the planes ``CHECKPOINT_FIELDS`` (done
    is 0 or 1) of the tile's pixels before the pairs of item b."""
    work: WorkList
    state: torch.Tensor


def work_capacity(num_tiles: int, pair_slots: int, segment: int) -> int:
    """M: no pair list of ``pair_slots`` slots over ``num_tiles`` tiles
    has more segments of ``segment`` pairs."""
    return num_tiles + pair_slots // segment


def build_work_list(tile_count: torch.Tensor, pair_slots: int,
                    segment: int = WHOLE_TILE) -> WorkList:
    """The work list of ``tile_count`` (T,) int32 on its device: a sort and,
    for segments, a prefix sum; ``items`` is allocated for K1 to fill.
    ``pair_slots`` bounds the sum of the counts (the pair list's length)."""
    counts, order = torch.sort(tile_count, descending=True, stable=True)
    order = order.to(torch.int32)
    if segment == WHOLE_TILE:
        return WorkList(order, None, None, segment)
    ends = torch.cumsum((counts + (segment - 1)) // segment, 0,
                        dtype=torch.int32)
    items = torch.empty((work_capacity(len(order), pair_slots, segment), 2),
                        dtype=torch.int32, device=tile_count.device)
    return WorkList(order, ends, items, segment)


def work_items(work: WorkList, tile_count: torch.Tensor) -> torch.Tensor:
    """The (M, 2) int32 items that K1 writes for ``work``, with PyTorch ops
    (the plain version); the pads past ``ends[-1]``, which K1 leaves
    unwritten, are (-1, 0)."""
    t = len(work.order)
    seg = work.segment
    i = torch.arange(len(work.items), device=work.order.device)
    rank = torch.searchsorted(work.ends, i, right=True)
    real = rank < t
    rank = torch.clamp(rank, max=t - 1)
    tile = work.order.long()[rank]
    nseg = (tile_count.long()[tile] + seg - 1) // seg
    k = i - (work.ends.long()[rank] - nseg)
    return torch.stack([torch.where(real, tile, -1),
                        torch.where(real, k, 0)], dim=1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = cuda_build.library(name)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "rasterize_fwd":
        lib.gstpu_rasterize_fwd.argtypes = (
            [ptr] * 5 + [i32] * 5 + [ptr] * 7 + [ctypes.POINTER(i32), i32,
                                                ptr])
        lib.gstpu_rasterize_fwd.restype = i32
    else:
        lib.gstpu_rasterize_bwd.argtypes = (
            [ptr] * 7 + [i32] * 2 + [ptr] * 2 + [i32] * 3 + [ptr, i32, ptr])
        lib.gstpu_rasterize_bwd.restype = i32
    return lib


def _gaussian_table(prep: PreprocessOut) -> torch.Tensor:
    """Packed (N, 12) f32 records (``Record`` in composite_common.cuh): x,
    y, conic a/b/c, opacity, r, g, b, inverse depth (``depth == 0 -> 1``
    guard, as the plain version) and two zeros, so a row is three aligned
    16-byte loads."""
    inv_depth = 1.0 / torch.where(prep.depth == 0.0, 1.0, prep.depth)
    return torch.cat([prep.xy, prep.conic, prep.opacity[:, None], prep.rgb,
                      inv_depth[:, None], prep.xy.new_zeros((len(prep.xy), 2))],
                     dim=1).contiguous()


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
    check = cuda_build.check_tensor
    check("pairs.gauss_id", pairs.gauss_id, torch.int32, dev)
    if pairs.gauss_id.dim() != 1:
        raise ValueError("pairs.gauss_id must be 1-D")
    check("pairs.tile_start", pairs.tile_start, torch.int32, dev, (t,))
    check("pairs.tile_count", pairs.tile_count, torch.int32, dev, (t,))
    return dev


def _check_checkpoints(ckpt: Checkpoints, num_tiles: int, pair_slots: int,
                       dev: torch.device) -> None:
    """Raise ValueError unless ``ckpt`` has the form that
    ``composite_forward_checkpointed`` gives for this pair list."""
    work, state = ckpt
    seg = work.segment
    if not isinstance(seg, int) or seg <= 0 or seg % FWD_BATCH:
        raise ValueError(f"work list segment {seg!r}: expected a positive "
                         f"multiple of {FWD_BATCH}")
    m = work_capacity(num_tiles, pair_slots, seg)
    for name, x, dtype, shape in (
            ("work list order", work.order, torch.int32, (num_tiles,)),
            ("work list ends", work.ends, torch.int32, (num_tiles,)),
            ("work list items", work.items, torch.int32, (m, 2)),
            ("checkpoint state", state, torch.float32,
             (m, len(CHECKPOINT_FIELDS), TILE_PIXELS))):
        if (not torch.is_tensor(x) or x.device != dev or x.dtype != dtype
                or tuple(x.shape) != shape or not x.is_contiguous()):
            got = (f"{x.dtype} {tuple(x.shape)} on {x.device}"
                   if torch.is_tensor(x) else type(x).__name__)
            raise ValueError(f"{name}: expected a contiguous {dtype} "
                             f"{shape} on {dev}, got {got}")
    if work.items.data_ptr() % 8:
        raise ValueError("work list items must be 8-byte aligned")


def _forward(prep: PreprocessOut, pairs: Pairs, settings: RenderSettings,
             row0: int, checkpoints: bool):
    """Launch K1; with ``checkpoints``, also write and return them every
    ``SEGMENT`` pairs."""
    dev = _check_inputs(prep, pairs, settings)
    t = settings.band_tiles
    table = _gaussian_table(prep)
    color = torch.empty((t, TILE_PIXELS, 3), dtype=torch.float32, device=dev)
    dacc = torch.empty((t, TILE_PIXELS), dtype=torch.float32, device=dev)
    final_t = torch.empty((t, TILE_PIXELS), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((t, TILE_PIXELS), dtype=torch.int32, device=dev)
    if t == 0:
        return color, dacc, final_t, n_contrib, None
    work = build_work_list(pairs.tile_count, pairs.gauss_id.shape[0],
                           SEGMENT if checkpoints else WHOLE_TILE)
    ckpt = Checkpoints(work, torch.empty(
        (len(work.items), len(CHECKPOINT_FIELDS), TILE_PIXELS),
        dtype=torch.float32, device=dev)) if checkpoints else None
    lib = _library("rasterize_fwd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ctas = ctypes.c_int(0)
    err = lib.gstpu_rasterize_fwd(
        table.data_ptr(), pairs.gauss_id.data_ptr(),
        pairs.tile_start.data_ptr(), pairs.tile_count.data_ptr(),
        work.order.data_ptr(), t, settings.grid_x, int(row0),
        settings.row_stride, work.segment if checkpoints else 0,
        work.ends.data_ptr() if checkpoints else None,
        work.items.data_ptr() if checkpoints else None,
        ckpt.state.data_ptr() if checkpoints else None,
        color.data_ptr(), dacc.data_ptr(), final_t.data_ptr(),
        n_contrib.data_ptr(), ctypes.byref(ctas),
        cuda_build.device_index(dev), stream)
    cuda_build.raise_on_error(lib, "rasterize_fwd", err)
    # one launch per call on CUDA tensors, and the CTAs it started (K1's C
    # launcher reports its grid)
    tracing.COUNTERS.add("k1.launches")
    tracing.COUNTERS.add("k1.ctas", ctas.value)
    return color, dacc, final_t, n_contrib, ckpt


def composite_forward(prep: PreprocessOut, pairs: Pairs,
                      settings: RenderSettings, row0: int = 0):
    """Forward compositing; same contract as ``rasterize.composite_forward``.

    Returns color (T,256,3), inverse depth (T,256), final transmittance
    (T,256) and n_contrib (T,256) int32 for the T tiles of the band.
    """
    if prep.xy.device.type == "cpu":
        return rasterize.composite_forward(prep, pairs, settings, row0=row0)
    return _forward(prep, pairs, settings, row0, False)[:4]


def composite_forward_checkpointed(prep: PreprocessOut, pairs: Pairs,
                                   settings: RenderSettings, row0: int = 0):
    """``composite_forward``'s four outputs and the ``Checkpoints`` that K1
    wrote every ``SEGMENT`` pairs of each tile, for ``composite_backward``;
    None in their place for CPU tensors (the plain version makes none)."""
    if prep.xy.device.type == "cpu":
        return rasterize.composite_forward(prep, pairs, settings,
                                           row0=row0) + (None,)
    return _forward(prep, pairs, settings, row0, True)


def pixel_inputs(color_pre_bg, final_t, dl_dpix, bg, depth_acc, dl_ddepth):
    """K2's (T, 7, 256) per-pixel planes: ctot_dot, bg_dot, final T,
    dL/dpix r, g, b and dL/ddepth."""
    ctot_dot = torch.sum(color_pre_bg * dl_dpix, dim=-1) + depth_acc * dl_ddepth
    bg_dot = torch.sum(bg[None, None, :] * dl_dpix, dim=-1)
    return torch.stack([ctot_dot, bg_dot, final_t, dl_dpix[:, :, 0],
                        dl_dpix[:, :, 1], dl_dpix[:, :, 2], dl_ddepth],
                       dim=1).contiguous()


def backward_rows(prep: PreprocessOut, pairs: Pairs, settings: RenderSettings,
                  color_pre_bg, final_t, dl_dpix, bg, row0: int = 0,
                  depth_acc=None, dl_ddepth=None,
                  checkpoints: Checkpoints | None = None) -> torch.Tensor:
    """Launch K2 on CUDA tensors: the (K2 + 1, 10) per-pair gradient rows
    (fields ``rasterize.PAIR_ROW_FIELDS``) that ``composite_backward`` sums
    per Gaussian.  Rows of pairs past a tile's early exit, of slots of no
    tile, and the last row, are zero.  Arguments as ``composite_backward``;
    ``checkpoints`` from ``composite_forward_checkpointed`` on the same
    inputs split the tiles into segments, without them every tile is one
    work item.
    """
    dev = _check_inputs(prep, pairs, settings)
    t = settings.band_tiles
    k2 = pairs.gauss_id.shape[0]
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
        cuda_build.check_tensor(name, x, torch.float32, dev, shape)
    rows = torch.zeros((k2 + 1, len(rasterize.PAIR_ROW_FIELDS)),
                       dtype=torch.float32, device=dev)
    if t == 0:
        return rows
    if checkpoints is None:
        work, state = build_work_list(pairs.tile_count, k2), None
        ctas = t
    else:
        _check_checkpoints(checkpoints, t, k2, dev)
        work, state = checkpoints
        ctas = len(work.items)

    pix_in = pixel_inputs(color_pre_bg, final_t, dl_dpix, bg, depth_acc,
                          dl_ddepth)
    table = _gaussian_table(prep)
    lib = _library("rasterize_bwd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    segmented = state is not None
    err = lib.gstpu_rasterize_bwd(
        table.data_ptr(), pairs.gauss_id.data_ptr(),
        pairs.tile_start.data_ptr(), pairs.tile_count.data_ptr(),
        work.order.data_ptr(), work.items.data_ptr() if segmented else None,
        work.ends[-1:].data_ptr() if segmented else None, ctas, work.segment,
        state.data_ptr() if segmented else None, pix_in.data_ptr(),
        settings.grid_x, int(row0), settings.row_stride, rows.data_ptr(),
        cuda_build.device_index(dev), stream)
    cuda_build.raise_on_error(lib, "rasterize_bwd", err)
    tracing.COUNTERS.add("k2.launches")
    tracing.COUNTERS.add("k2.ctas", ctas)
    return rows


def composite_backward(prep: PreprocessOut, pairs: Pairs,
                       settings: RenderSettings, color_pre_bg, final_t,
                       dl_dpix, bg, row0: int = 0, depth_acc=None,
                       dl_ddepth=None, checkpoints: Checkpoints | None = None):
    """Backward compositing; same contract as
    ``rasterize.composite_backward``: K2 (``backward_rows``, from K1's
    ``checkpoints`` when given), then the epilogue
    ``rasterize.segment_sum_pair_rows``.

    Returns (dL_dcolor (N,3), dL_dmean2d_ndc (N,2), dL_dconic (N,3),
    dL_dopacity (N,), dL_dinvdepth (N,)).
    """
    if prep.xy.device.type == "cpu":
        if checkpoints is not None:
            raise ValueError("the plain backward reads no checkpoints")
        return rasterize.composite_backward(
            prep, pairs, settings, color_pre_bg, final_t, dl_dpix, bg,
            row0=row0, depth_acc=depth_acc, dl_ddepth=dl_ddepth)
    rows = backward_rows(prep, pairs, settings, color_pre_bg, final_t,
                         dl_dpix, bg, row0=row0, depth_acc=depth_acc,
                         dl_ddepth=dl_ddepth, checkpoints=checkpoints)
    return rasterize.segment_sum_pair_rows(rows, pairs, settings)
