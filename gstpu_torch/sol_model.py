"""Speed-of-light model of the rasterize fwd+bwd frame on the CUDA card.

Port of ``scripts/sol_model.py``.  Each irreducible stage of the frame is
timed alone at the bench scene's volumes (100k Gaussians, 800x800, 413,741
live pairs over 2,500 tiles), with perfect balance and no plumbing:

- ``fwd_compositing_ms`` and ``bwd_compositing_ms``: kernel K3
  (``csrc/sol_compositing.cu``, replaces the TPU kernel
  ``scripts/sol_model.py::sol_compositing.kernel``), the compositing
  arithmetic alone on one block resident in shared memory, at
  ``ceil(413741 / 2500 / 128) = 2`` chunks of 128 pairs per tile;
- ``pair_sort_ms``: the stable sort on the two keys (tile, depth bits)
  carrying the Gaussian id, at 2^19 pairs;
- ``binning_scans_ms``: the cumsum and cummax of one int32 key array;
- ``hbm_traffic_ms``: the bytes the compositing kernels must move, at the
  copy bandwidth measured by ``x + 1.0`` over a (16, 2^19) float32 array.

Each stage is timed by the slope method (3 warm-up calls, then 5 and 25
calls, each run ending in ``torch.cuda.synchronize()``).  The floor is
relative to this algorithm (tile splatting, f32 compositing), not an
absolute bound on rendering.

    python -m gstpu_torch.sol_model [--out PATH]

prints the model as one JSON line and writes it to ``PATH`` when given;
``python -m gstpu_torch.bench --sol PATH`` then reports ``vs_sol``.  It
needs the CUDA card and raises without it.

``sol_compositing`` launches K3 for a feature block on the card (counted in
``LAUNCHES``) and runs ``sol_compositing_plain``, its plain PyTorch version,
for a block on the CPU.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gstpu_torch.ops import cuda_build

# Bench-scene volumes (scripts/sol_model.py:38-45)
N_GAUSSIANS = 100_000
WIDTH = HEIGHT = 800
LIVE_PAIRS = 413_741
TILES = (WIDTH // 16) * (HEIGHT // 16)
CHUNK = 128
PIX = 256
FEAT_ROWS = 16
N_CHUNKS = int(np.ceil(LIVE_PAIRS / TILES / CHUNK))
SORT_PAIRS = 1 << int(np.ceil(np.log2(LIVE_PAIRS)))
TIE = np.float32(1e-7)     # the loop-counter tie, rounded as the JAX code does
WARMUP, ITERS_LO, ITERS_HI = 3, 5, 25    # calls of the slope method
TIMED_CALLS = WARMUP + ITERS_LO + ITERS_HI
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4

# fp32 operations per (pixel, lane) step of K3, counted from the body as
# written (a compare, select, min or exp counts one; the per-lane scaling of
# the block is shared by the 256 pixels and not counted).  Forward: the
# pixel offsets (2), power (9), min and exp (2), alpha (4), 1 - alpha, the
# running product, p_incl and t_ex (4), kept and w (3), the live
# accumulator (2) and the carry's min (1).  Backward adds cdot and u (2),
# the running sum of u (1), 1/(1-alpha) and dL/dalpha (8), dL/dg, g*dx and
# g*dy (3), the six gradient terms and their sum (26), the four pixel terms
# and their sum (8) and the two sums over pixels (2), and drops the
# accumulator.
FWD_OPS_PER_STEP = 27
BWD_OPS_PER_STEP = FWD_OPS_PER_STEP - 2 + 50

# Kernel launches made by ``sol_compositing`` (one per call on the card
# with at least one tile), and the CTAs those launches started (one per
# tile).
LAUNCHES = {"sol_compositing_fwd": 0, "sol_compositing_bwd": 0}
CTAS = {"sol_compositing_fwd": 0, "sol_compositing_bwd": 0}


def feature_block(device) -> torch.Tensor:
    """The (1, 16, 128) f32 block of the JAX model:
    ``default_rng(0).uniform(0.3, 0.9)``."""
    return torch.tensor(np.random.default_rng(0).uniform(
        0.3, 0.9, (1, FEAT_ROWS, CHUNK)).astype(np.float32), device=device)


def sol_compositing_plain(feat: torch.Tensor, n_chunks: int, tiles: int,
                          backward: bool) -> torch.Tensor:
    """Plain PyTorch version of K3: (tiles, 2, 256) forward, (tiles, 2, 128)
    backward, every tile computed from the same (1, 16, 128) block."""
    dev = feat.device
    blk = feat[0].expand(tiles, FEAT_ROWS, CHUNK)
    pixf_x = (torch.arange(PIX, dtype=torch.int32, device=dev)
              .to(torch.float32) * 0.0625)[None, :, None]    # (1, 256, 1)
    pixf_y = pixf_x * 0.5
    f32 = dict(dtype=torch.float32, device=dev)
    trans = torch.ones((tiles, PIX, 1), **f32)
    prefix_u = torch.zeros((tiles, PIX, 1), **f32)
    if backward:
        acc = [torch.zeros((tiles, CHUNK), **f32) for _ in range(2)]
    else:
        acc = [torch.zeros((tiles, PIX, CHUNK), **f32) for _ in range(4)]
    for c in range(n_chunks):
        fc = blk * (np.float32(1.0) + np.float32(c) * TIE)
        x, y, ca, cb, cc, op = (fc[:, k:k + 1] for k in range(6))
        dx = x - pixf_x                                          # (T, 256, 128)
        dy = y - pixf_y
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        # exp in float64, rounded to float32 (as rasterize._chunk_alpha):
        # the same bits in every process on the CPU
        g = torch.exp(torch.clamp(power, max=0.0).double()).float()
        alpha = torch.clamp(op * g, max=ALPHA_MAX)
        alpha = torch.where(alpha >= ALPHA_MIN, alpha, 0.0)
        one_m = 1.0 - alpha
        p_incl = trans * torch.cumprod(one_m, dim=-1)
        t_ex = p_incl / one_m
        kept = p_incl >= T_EPS
        w = torch.where(kept, alpha * t_ex, 0.0)
        if not backward:
            acc = [a + w * fc[:, 6 + i:7 + i] for i, a in enumerate(acc)]
        else:
            cdot = (fc[:, 6:7] + fc[:, 7:8] + fc[:, 8:9] + fc[:, 9:10]) * w
            u = w * cdot
            cum_u = torch.cumsum(u, dim=-1)
            inv_one_m = 1.0 / one_m
            dl_da = torch.where(kept, cdot * t_ex
                                - (prefix_u + cum_u) * inv_one_m
                                - inv_one_m * 0.25, 0.0)
            dl_dg = op * dl_da
            gdx = g * dx
            gdy = g * dy
            r = (torch.sum(dl_dg * (-gdx * ca - gdy * cb), dim=1)
                 + torch.sum(dl_dg * (-gdy * cc - gdx * cb), dim=1)
                 + torch.sum(-0.5 * gdx * dx * dl_dg, dim=1)
                 + torch.sum(-0.5 * gdx * dy * dl_dg, dim=1)
                 + torch.sum(-0.5 * gdy * dy * dl_dg, dim=1)
                 + torch.sum(torch.where(kept, g, 0.0) * dl_da, dim=1))
            r2 = (torch.sum(w * pixf_x, dim=1) + torch.sum(w * pixf_y, dim=1)
                  + torch.sum(w * (pixf_x + 1.0), dim=1)
                  + torch.sum(w * cdot, dim=1))
            acc = [acc[0] + r, acc[1] + r2]
            prefix_u = prefix_u + torch.sum(u, dim=-1, keepdim=True)
        p_last = torch.amin(torch.where(kept, p_incl, torch.inf), dim=-1,
                            keepdim=True)
        trans = torch.where(torch.isfinite(p_last), p_last, trans)
    if backward:
        return torch.stack(acc, dim=1)
    return torch.stack([acc[0].sum(dim=-1), trans[..., 0]], dim=1)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.library("sol_compositing")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gstpu_sol_compositing.argtypes = [ptr, i32, i32, i32, ptr, i32, ptr]
    lib.gstpu_sol_compositing.restype = i32
    return lib


def sol_compositing(feat: torch.Tensor, n_chunks: int, tiles: int,
                    backward: bool) -> torch.Tensor:
    """K3 on the block ``feat`` (1, 16, 128) f32: (tiles, 2, 256) forward or
    (tiles, 2, 128) backward.  Runs ``sol_compositing_plain`` for a block on
    the CPU; on the card launches the kernel or raises."""
    if feat.device.type == "cpu":
        return sol_compositing_plain(feat, n_chunks, tiles, backward)
    if feat.device.type != "cuda":
        raise ValueError(f"no K3 kernel for device {feat.device}")
    if feat.dtype != torch.float32:
        raise TypeError(f"feat has dtype {feat.dtype}, expected float32")
    if tuple(feat.shape) != (1, FEAT_ROWS, CHUNK) or not feat.is_contiguous():
        raise ValueError(f"feat must be a contiguous (1, {FEAT_ROWS}, {CHUNK}) "
                         f"block, got {tuple(feat.shape)}")
    if tiles < 0 or n_chunks < 0:
        raise ValueError(f"tiles {tiles} and n_chunks {n_chunks} must be >= 0")
    out = torch.empty((tiles, 2, CHUNK if backward else PIX),
                      dtype=torch.float32, device=feat.device)
    if tiles == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = lib.gstpu_sol_compositing(feat.data_ptr(), tiles, n_chunks,
                                    int(backward), out.data_ptr(),
                                    cuda_build.device_index(feat.device),
                                    stream)
    cuda_build.raise_on_error(lib, "sol_compositing", err)
    form = "sol_compositing_bwd" if backward else "sol_compositing_fwd"
    LAUNCHES[form] += 1
    CTAS[form] += tiles
    return out


def k3_bound(tiles: int, n_chunks: int, backward: bool,
             peak_flops: float, peak_bytes_per_s: float) -> dict:
    """Least time of one K3 launch on a card of these peaks: the larger of
    its operations over ``peak_flops`` and its bytes (the block read once,
    the output written once) over ``peak_bytes_per_s``."""
    steps = tiles * PIX * CHUNK * n_chunks
    ops = steps * (BWD_OPS_PER_STEP if backward else FWD_OPS_PER_STEP)
    nbytes = FEAT_ROWS * CHUNK * 4 + tiles * 2 * (CHUNK if backward
                                                  else PIX) * 4
    flop_ms = ops / peak_flops * 1e3
    byte_ms = nbytes / peak_bytes_per_s * 1e3
    return {"steps": steps, "operations": ops, "bytes": nbytes,
            "flop_bound_ms": flop_ms, "byte_bound_ms": byte_ms,
            "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}


def pair_sort(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """``jax.lax.sort((a, b, c), num_keys=2, is_stable=True)`` for int32
    ``a``, ``b`` >= 0: one stable sort of the int64 key ``a << 32 | b``,
    then a gather of ``c``."""
    key = (a.to(torch.int64) << 32) | b.to(torch.int64)
    key, perm = torch.sort(key, stable=True)
    return ((key >> 32).to(torch.int32), (key & 0xFFFFFFFF).to(torch.int32),
            c[perm])


def binning_scans(b: torch.Tensor):
    """``(jnp.cumsum(b), lax.cummax(b))`` of an int32 array, in int32 (an
    int32 cumsum wraps as XLA's does)."""
    return torch.cumsum(b, dim=0, dtype=b.dtype), torch.cummax(b, dim=0)[0]


def sort_inputs(device, k: int = SORT_PAIRS, seed: int = 0):
    """(a, b, c, rng) as the JAX model draws them from
    ``default_rng(seed)``: tile ids, 30-bit depth keys, Gaussian ids."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, TILES, k).astype(np.int32)
    b = rng.integers(0, 1 << 30, k).astype(np.int32)
    c = rng.integers(0, N_GAUSSIANS, k).astype(np.int32)
    return (*(torch.tensor(x, device=device) for x in (a, b, c)), rng)


def timeit(fn) -> float:
    """Seconds per call of ``fn`` on the card by the slope method
    (``TIMED_CALLS`` calls in all)."""
    def run(k):
        for _ in range(k):
            fn()
        torch.cuda.synchronize()

    run(WARMUP)
    t0 = time.perf_counter()
    run(ITERS_LO)
    t1 = time.perf_counter()
    run(ITERS_HI)
    t2 = time.perf_counter()
    return ((t2 - t1) - (t1 - t0)) / (ITERS_HI - ITERS_LO)


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    name, limit = (s.strip() for s in smi.stdout.strip().splitlines()[0]
                   .rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def run(device=None) -> dict:
    """Time every stage on the card; returns the model's dict (the JAX
    model's keys, ``device`` in place of ``backend``)."""
    from gstpu_torch.render import resolve_device

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the speed-of-light model times the CUDA card")
    feat = feature_block(device)
    fwd_s = timeit(lambda: sol_compositing(feat, N_CHUNKS, TILES, False))
    bwd_s = timeit(lambda: sol_compositing(feat, N_CHUNKS, TILES, True))

    k = SORT_PAIRS
    a, b, c, rng = sort_inputs(device, k)
    sort_s = timeit(lambda: pair_sort(a, b, c))
    scan_s = timeit(lambda: binning_scans(b))

    # HBM bytes at the measured copy bandwidth: feature write+read (fwd) +
    # read (bwd) + grad write+read + per-Gaussian grads write
    big = torch.tensor(rng.uniform(size=(16, k)).astype(np.float32),
                       device=device)
    copy_s = timeit(lambda: big + 1.0)
    bw = 2 * big.numel() * 4 / copy_s            # bytes/s (read + write)
    feat_bytes = 5 * 16 * k * 4 + 2 * N_GAUSSIANS * 16 * 4
    dma_s = feat_bytes / bw

    stages = {
        "fwd_compositing_ms": fwd_s * 1e3,
        "bwd_compositing_ms": bwd_s * 1e3,
        "pair_sort_ms": sort_s * 1e3,
        "binning_scans_ms": scan_s * 1e3,
        "hbm_traffic_ms": dma_s * 1e3,
    }
    return {
        "sol_ms": sum(stages.values()),
        "stages": stages,
        "volumes": {"n_gaussians": N_GAUSSIANS, "live_pairs": LIVE_PAIRS,
                    "tiles": TILES, "chunks_per_tile": N_CHUNKS,
                    "resolution": f"{WIDTH}x{HEIGHT}"},
        "hbm_bandwidth_gbps": bw / 1e9,
        "device": card(),
        "note": "algorithm-relative floor: isolated-stage microbenchmarks "
                "at bench volumes, perfect balance, zero plumbing",
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the model as JSON to this path")
    args = ap.parse_args(argv)
    out = run()
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
