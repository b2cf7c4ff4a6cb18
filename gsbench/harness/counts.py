"""The yardstick's arithmetic: peaks, the work each kernel and each step
needs, and the capacity rule.

Frozen copies: the walk's operation and byte counts of K1 and K2 are those
of the port's chip check (``chip_smoke.py``: 20 operations per evaluated
(pixel, pair) step in both kernels, K2 adding 56 per composited step);
``round_capacity`` and the refit factor are the Trainer's.  The counts of
the other stages are written down here with their reasons; they count
floating-point operations the algorithm needs, an FMA as two, as the
float32 peak does.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense): float32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

FLOPS_PER_STEP = 20       # per evaluated (pixel, pair) step, K1 and K2
BWD_FLOPS_PER_KEPT = 56   # K2's gradient terms (46) and sums (10) per kept step
RECORD_BYTES = 40         # one Gaussian's record (10 float32)
OUT_BYTES_PER_PIXEL = 24  # K1: colour 12, inverse depth 4, final T 4, n_contrib 4
PIX_IN_BYTES = 28         # K2's per-pixel inputs (7 float32)
ROW_BYTES = 40            # K2's per-pair output row (10 float32)
CHECKPOINT_BYTES = 6 * 256 * 4 + 8  # K1's state per segment, and its item
SEGMENT = 256             # pairs per K2 work item under training

# Per Gaussian (the whole capacity is processed):
# - preprocess 430: two point transforms (48), the projection to pixels
#   (13), quaternion to matrix (40), the 3D covariance (54), the EWA
#   projection (80), conic, eigenvalues and radius (25), tile rect (19),
#   SH of degree 3 (direction 11, basis 25, 16 x 3 multiply-adds 96, offset
#   and clamp 8), masked writes (11);
PREPROCESS_FLOPS = 430
# - the adjoint chain 560: the EWA backward (200), the projection's (20),
#   SH's (coefficients 96, the direction's 3 x 32 multiply-adds and the
#   normalisation's adjoint 104), the covariance's (100), the depth chain
#   and the sum of the four position gradients (17), the activations' (23);
ADJOINT_FLOPS = 560
# - Adam 14 per stored float (two moments 7, bias corrections 2, root,
#   epsilon, division, rate and update 5) and 12 per Gaussian to renormalise
#   its quaternion.
ADAM_FLOPS_PER_FLOAT = 14
ADAM_FLOPS_PER_GAUSSIAN = 12
FLOATS_PER_GAUSSIAN = 59
# Per pair before the cull: the distance of the tile's rect to the centre
# (12).  Per composited pair: the epilogue's 10 sums.
CULL_FLOPS_PER_PAIR = 12
EPILOGUE_FLOPS_PER_KEPT_PAIR = 10
# Per pixel and channel: image assembly 2; L1 4 forward and backward;
# SSIM 240 forward (five maps, two 11-tap passes of 2 operations each, and
# the ratio), twice that backward.
ASSEMBLY_FLOPS = 2
L1_FLOPS = 4
SSIM_FLOPS = 3 * 240


def round_capacity(pairs: float) -> int:
    """The Trainer's pair capacity: up to a multiple of 32768, at least
    16384."""
    return max(-(-int(pairs) // 32768) * 32768, 1 << 14)


REFIT = 1.5               # the Trainer refits a capacity to 1.5x the need


def eval_capacity(num_pairs: int) -> int:
    """eval_model's capacity after an overflow: 1.5x the pairs, up to a
    multiple of 32768."""
    return -(-num_pairs * 3 // 2 // 32768) * 32768


def k1_work(evaluated: int, gaussians: int, slots: int, tiles: int,
            segments: int = 0) -> tuple[float, float]:
    """(operations, bytes) of one K1 launch; ``segments`` are the
    checkpoints it writes under training."""
    ops = evaluated * FLOPS_PER_STEP
    nbytes = (gaussians * RECORD_BYTES + slots * 4 + tiles * 8
              + tiles * 256 * OUT_BYTES_PER_PIXEL + segments * CHECKPOINT_BYTES)
    return ops, nbytes


def k2_work(evaluated: int, kept: int, gaussians: int, slots: int,
            tiles: int, segments: int) -> tuple[float, float]:
    """(operations, bytes) of one K2 launch from K1's checkpoints."""
    ops = evaluated * FLOPS_PER_STEP + kept * BWD_FLOPS_PER_KEPT
    nbytes = (gaussians * RECORD_BYTES + slots * 4 + tiles * 8
              + tiles * 256 * PIX_IN_BYTES + slots * ROW_BYTES
              + segments * CHECKPOINT_BYTES)
    return ops, nbytes


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the chip could take: operations or bytes at peak."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def segments(tile_count) -> int:
    """K2's work items: every tile's pairs in segments of ``SEGMENT``."""
    return int(((tile_count + SEGMENT - 1) // SEGMENT).sum())


def frame_flops(gaussians: int, pixels: int, num_pairs: int,
                evaluated: int) -> float:
    """Operations of one rendered frame: preprocess, K1, image assembly."""
    return (gaussians * PREPROCESS_FLOPS + evaluated * FLOPS_PER_STEP
            + pixels * 3 * ASSEMBLY_FLOPS)


def step_flops(gaussians: int, pixels: int, num_pairs: int, kept_pairs: int,
               evaluated: int, kept: int, lambda_dssim: float) -> float:
    """Operations of one training step: preprocess, the cull, K1, image
    assembly, the loss, K2 and its epilogue, the adjoint chain, Adam."""
    loss = pixels * 3 * (L1_FLOPS + (SSIM_FLOPS if lambda_dssim else 0))
    return (gaussians * (PREPROCESS_FLOPS + ADJOINT_FLOPS + ADAM_FLOPS_PER_GAUSSIAN
                         + ADAM_FLOPS_PER_FLOAT * FLOATS_PER_GAUSSIAN)
            + num_pairs * CULL_FLOPS_PER_PAIR
            + evaluated * FLOPS_PER_STEP * 2 + kept * BWD_FLOPS_PER_KEPT
            + kept_pairs * EPILOGUE_FLOPS_PER_KEPT_PAIR
            + pixels * 3 * ASSEMBLY_FLOPS + loss)
