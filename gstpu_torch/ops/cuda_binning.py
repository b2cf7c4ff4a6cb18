"""Tile binning through the hand-written CUDA kernels of ``csrc/binning.cu``.

``build_pairs`` is the one entry that the port's callers of binning go
through.  For tensors on the CPU it runs the plain version,
``ops/binning.py::build_pairs``; for CUDA tensors it launches the duplicate
kernel, CUB's radix sort and the finish kernel, or raises.  Both give the
same ``Pairs``, field for field and bit for bit.  ``ops/cuda_build.py``
builds and loads the library.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gstpu_torch.ops import binning, cuda_build
from gstpu_torch.ops.binning import Pairs
from gstpu_torch.utils import tracing

_INT32_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("binning")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gstpu_binning_duplicate.argtypes = [ptr] * 6 + [i32] * 6 + [ptr] * 4 \
        + [i32, ptr]
    lib.gstpu_binning_sort_bytes.argtypes = [
        i32, i32, ctypes.POINTER(ctypes.c_size_t), i32]
    lib.gstpu_binning_sort.argtypes = [ptr] * 5 + [ctypes.c_size_t, i32, i32,
                                                   ctypes.POINTER(i32), i32,
                                                   ptr]
    lib.gstpu_binning_finish.argtypes = [ptr] * 4 + [i32] * 5 + [ptr] * 7 \
        + [i32, ptr]
    for fn in (lib.gstpu_binning_duplicate, lib.gstpu_binning_sort_bytes,
               lib.gstpu_binning_sort, lib.gstpu_binning_finish):
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _sort_bytes(capacity: int, end_bit: int, device: int) -> int:
    lib = _library()
    size = ctypes.c_size_t(0)
    err = lib.gstpu_binning_sort_bytes(capacity, end_bit, ctypes.byref(size),
                                       device)
    cuda_build.raise_on_error(lib, "binning sort", err)
    return size.value


def build_pairs(tiles_touched: torch.Tensor, rect: torch.Tensor,
                depth: torch.Tensor, grid_x: int, num_tiles: int,
                pair_capacity: int, cull_xy: torch.Tensor | None = None,
                cull_tcut: torch.Tensor | None = None, row0: int = 0,
                row_stride: int = 1,
                kept_capacity: int | None = None) -> Pairs:
    """``binning.build_pairs``'s ``Pairs`` from the same arguments: the plain
    version for CPU tensors, the kernels for CUDA tensors."""
    args = (tiles_touched, rect, depth, grid_x, num_tiles, pair_capacity)
    kw = dict(cull_xy=cull_xy, cull_tcut=cull_tcut, row0=row0,
              row_stride=row_stride, kept_capacity=kept_capacity)
    if tiles_touched.device.type == "cpu":
        return binning.build_pairs(*args, **kw)
    return _build_pairs_cuda(*args, **kw)


def _build_pairs_cuda(tiles_touched, rect, depth, grid_x: int,
                      num_tiles: int, pair_capacity: int, cull_xy=None,
                      cull_tcut=None, row0: int = 0, row_stride: int = 1,
                      kept_capacity: int | None = None) -> Pairs:
    dev = tiles_touched.device
    if dev.type != "cuda":
        raise ValueError(f"no binning kernel for device {dev}")
    n = tiles_touched.shape[0] if tiles_touched.dim() == 1 else -1
    if n < 1:
        raise ValueError("tiles_touched must be 1-D with at least one "
                         f"Gaussian, got shape {tuple(tiles_touched.shape)}")
    k = int(pair_capacity)
    if not 1 <= k <= _INT32_MAX:
        raise ValueError(f"pair_capacity {k} outside [1, 2^31 - 1]")
    k2 = k if kept_capacity is None else min(int(kept_capacity), k)
    if k2 < 0:
        raise ValueError(f"kept_capacity {kept_capacity} is negative")
    if (cull_xy is None) != (cull_tcut is None):
        raise ValueError("cull_xy and cull_tcut are given together or not "
                         "at all")
    check = cuda_build.check_tensor
    check("tiles_touched", tiles_touched, torch.int32, dev, (n,), align=4)
    check("rect", rect, torch.int32, dev, (n, 4), align=16)
    check("depth", depth, torch.float32, dev, (n,), align=4)
    cull = cull_xy is not None
    if cull:
        check("cull_xy", cull_xy, torch.float32, dev, (n, 2), align=8)
        check("cull_tcut", cull_tcut, torch.float32, dev, (n,), align=4)

    lib = _library()
    index = cuda_build.device_index(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cum, keys, slots, gauss, gauss_cum = duplicate(
        tiles_touched, rect, depth, grid_x, num_tiles, k, cull_xy, cull_tcut,
        row0, row_stride)

    # the tile field's bits above the 32 depth bits, the sentinel num_tiles
    # included
    end_bit = 32 + int(num_tiles).bit_length()
    temp = torch.empty(max(_sort_bytes(k, end_bit, index), 1),
                       dtype=torch.uint8, device=dev)
    selector = ctypes.c_int(-1)
    cuda_build.raise_on_error(lib, "binning sort", lib.gstpu_binning_sort(
        keys[0].data_ptr(), keys[1].data_ptr(), slots[0].data_ptr(),
        slots[1].data_ptr(), temp.data_ptr(), temp.numel(), k, end_bit,
        ctypes.byref(selector), index, stream))
    sel = selector.value

    i32 = dict(dtype=torch.int32, device=dev)
    gm_pos = torch.empty(k, **i32)
    tile_id = torch.empty(k2, **i32)
    gauss_id = torch.empty(k2, **i32)
    bounds = torch.empty(num_tiles + 1, **i32)
    tile_count = torch.empty(num_tiles, **i32)
    num_pairs = torch.empty((), **i32)
    num_kept = torch.empty((), **i32)
    cuda_build.raise_on_error(lib, "binning finish", lib.gstpu_binning_finish(
        keys[sel].data_ptr(), slots[sel].data_ptr(), gauss.data_ptr(),
        cum.data_ptr(), n, k, k2, num_tiles, int(cull), gm_pos.data_ptr(),
        tile_id.data_ptr(), gauss_id.data_ptr(), bounds.data_ptr(),
        tile_count.data_ptr(), num_pairs.data_ptr(), num_kept.data_ptr(),
        index, stream))
    tracing.COUNTERS.add("binning.launches")
    return Pairs(gauss_id=gauss_id, tile_id=tile_id, tile_start=bounds[:-1],
                 tile_count=tile_count, num_pairs=num_pairs,
                 num_kept=num_kept, gm_pos=gm_pos, gauss_cum=gauss_cum)


def duplicate(tiles_touched, rect, depth, grid_x: int, num_tiles: int,
              capacity: int, cull_xy, cull_tcut, row0: int, row_stride: int):
    """The duplicate kernel on checked inputs: (cum (N,) int64, keys (2, K)
    int64 whose row 0 holds every slot's key, slots (2, K) int32 whose row 0
    holds every slot's index, gauss (K,) int32 each pair slot's Gaussian,
    gauss_cum (N,) int32); rows 1 are the sort's second buffers."""
    dev = tiles_touched.device
    n = tiles_touched.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    cum = torch.cumsum(tiles_touched, 0, dtype=torch.int64)
    keys = torch.empty((2, capacity), dtype=torch.int64, device=dev)
    slots = torch.empty((2, capacity), **i32)
    gauss = torch.empty(capacity, **i32)
    gauss_cum = torch.empty(n, **i32)
    lib = _library()
    cull = cull_xy is not None
    cuda_build.raise_on_error(lib, "binning duplicate",
                              lib.gstpu_binning_duplicate(
        cum.data_ptr(), tiles_touched.data_ptr(), rect.data_ptr(),
        depth.data_ptr(), cull_xy.data_ptr() if cull else None,
        cull_tcut.data_ptr() if cull else None, n, grid_x, num_tiles,
        capacity, row0, row_stride, keys.data_ptr(), slots.data_ptr(),
        gauss.data_ptr(), gauss_cum.data_ptr(), cuda_build.device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream))
    return cum, keys, slots, gauss, gauss_cum
