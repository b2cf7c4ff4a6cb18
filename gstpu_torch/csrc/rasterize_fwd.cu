// Forward compositing of 16x16 pixel tiles for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gstpu/ops/pallas_rasterize.py::_fwd_kernel.  The
// plain PyTorch version of the same function is
// gstpu_torch/ops/rasterize.py::composite_forward; the wrapper that builds
// and launches this file is gstpu_torch/ops/cuda_rasterize.py.
//
// What it computes.  Each pixel walks its tile's depth-sorted pair range
// [tile_start, tile_start + tile_count) as the reference does:
//
//   power = -0.5*(a*dx*dx + c*dy*dy) - b*dx*dy,  dx = x - pixel_x
//   skip if power > 0;  alpha = min(0.99, op*exp(power));  skip if alpha < 1/255
//   test_T = T*(1-alpha);  if test_T < 1e-4: done, break
//   C += alpha*T*rgb;  D += alpha*T*invd;  T = test_T;  last = pos + 1
//
// and writes color, inverse depth, final T and n_contrib (= last).
//
// What bounds it on this card.  The fp32 ALU and the exp unit over the
// evaluated (pixel, pair) steps (about 20 operations each); the bytes (one
// 48-byte record and one 4-byte id per pair and tile, 24 bytes of output per
// pixel) are small beside them.  But the tiles are very uneven (on an
// 800x800 Lego orbit view the deepest tile holds 4,504 pairs, the mean
// occupied tile 746), and a pixel's walk is serial, so one deep tile's walk,
// not the total work, sets the time of a launch.  The design does three
// things about it:
//
// - One CTA per (tile, group of 64 pixels): a 16x4 strip of the tile, two
//   warps.  Pixels are independent in the forward, so the split is exact; a
//   deep tile's serial walk is spread over four CTAs, which the scheduler
//   places on four SMs, and each strip leaves as soon as its own 64 pixels
//   are done.
// - Deepest first: the wrapper hands the tiles in the order of their
//   tile_count, descending (`order`), so the longest walks start first and
//   the short ones fill in around them.
// - Alpha ahead of the chain: within a batch each thread computes the alpha
//   of kAhead = 8 pairs into registers, without branches (pair_alpha in
//   composite_common.cuh), before it runs their serial T/done/accumulate
//   updates, so the exp and multiply chains of independent pairs overlap
//   instead of each waiting for the previous pair's transmittance.  The
//   per-pair operations and their order are the one-pair-at-a-time walk's,
//   so every output is bit-identical to it.
//
// The records are staged in shared memory in batches of kFwdBatch = 256
// (each of the 64 threads loads four); the CTA leaves once
// __syncthreads_count(done) reaches its 64 pixels.
//
// Checkpoints for the backward kernel.  When `ckpt` is not null, the tile
// of rank r (the r-th of `order`) with nseg = ceil(tile_count / segment)
// segments owns the slots ends[r] - nseg + k, k < nseg (`ends` is the
// inclusive prefix sum of nseg in rank order).  Its CTAs write their
// pixels' state (T, color r/g/b, inverse depth, done) at pair position
// k*segment to slot ends[r] - nseg + k (positions past an early exit get
// the final state), and its first CTA writes items[slot] = (tile, k): the
// backward kernel's work list, deepest tile first.  `segment` is a multiple
// of kFwdBatch, so each position is a batch start.
//
// Numerics.  Built without fast math and with -fmad=false, so the per-pair
// arithmetic rounds like the reference's separate multiplies and adds; expf,
// not __expf.  The thresholds are the float32 roundings of the double
// constants that the JAX code compares against.  The per-(pixel, pair)
// alpha, skip and transmittance arithmetic lives in composite_common.cuh,
// which the backward kernel includes too, so both decide the same kept
// pairs bit for bit.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using gstpu::kFwdBatch;
using gstpu::kPixels;

constexpr int kGroupPixels = 64;                 // threads per CTA
constexpr int kGroups = kPixels / kGroupPixels;  // CTAs per tile
constexpr int kAhead = 8;                        // alphas ahead of the chain

__device__ __forceinline__ void write_checkpoint(
    float* ckpt, int slot, int p, float trans, float c_r, float c_g,
    float c_b, float d_acc, bool done) {
  float* c = ckpt + static_cast<size_t>(slot) * gstpu::kCkptFields * kPixels
             + p;
  c[gstpu::kCkptT * kPixels] = trans;
  c[gstpu::kCkptR * kPixels] = c_r;
  c[gstpu::kCkptG * kPixels] = c_g;
  c[gstpu::kCkptB * kPixels] = c_b;
  c[gstpu::kCkptD * kPixels] = d_acc;
  c[gstpu::kCkptDone * kPixels] = done ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(kGroupPixels)
rasterize_fwd_kernel(const float* __restrict__ table,
                     const int* __restrict__ gauss_id,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const int* __restrict__ order,
                     int grid_x, int row0, int row_stride, int segment,
                     const int* __restrict__ ends, int2* __restrict__ items,
                     float* __restrict__ ckpt,
                     float* __restrict__ color, float* __restrict__ dacc,
                     float* __restrict__ final_t, int* __restrict__ n_contrib) {
  // record j is read by every thread at once: three broadcast 16-byte
  // loads
  __shared__ gstpu::Record rec[kFwdBatch];

  const int rank = blockIdx.x / kGroups;
  const int tile = order[rank];
  const int p = (blockIdx.x % kGroups) * kGroupPixels + threadIdx.x;
  float pix_x, pix_y;
  gstpu::pixel_center(tile, p, grid_x, row0, row_stride, &pix_x, &pix_y);
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  // the tile's checkpoint slots, which are K2's work items: first, first+1,
  // ... in the order of the tiles' ranks
  int first = 0;
  if (ckpt != nullptr) {
    const int nseg = (count + segment - 1) / segment;
    first = ends[rank] - nseg;
    if (blockIdx.x % kGroups == 0) {
      for (int k = threadIdx.x; k < nseg; k += kGroupPixels)
        items[first + k] = make_int2(tile, k);
    }
  }

  float trans = 1.0f;
  float c_r = 0.0f, c_g = 0.0f, c_b = 0.0f, d_acc = 0.0f;
  int last = 0;
  bool done = false;
  int next_ckpt = 0;  // checkpoints of this tile written so far

  for (int base = 0; base < count; base += kFwdBatch) {
    if (ckpt != nullptr && base == next_ckpt * segment) {
      write_checkpoint(ckpt, first + next_ckpt, p, trans, c_r, c_g, c_b,
                       d_acc, done);
      ++next_ckpt;
    }
    const int batch = min(kFwdBatch, count - base);
    for (int i = threadIdx.x; i < batch; i += kGroupPixels)
      gstpu::load_record(table, gauss_id[start + base + i], &rec[i]);
    __syncthreads();

    for (int j0 = 0; j0 < batch && !done; j0 += kAhead) {
      // the alphas of the group first (independent of T) ...
      gstpu::PairAlpha pa[kAhead];
#pragma unroll
      for (int g = 0; g < kAhead; ++g) {
        pa[g] = gstpu::pair_alpha(rec[j0 + g], pix_x, pix_y);
        pa[g].pass = pa[g].pass && j0 + g < batch;
      }
      // ... then the serial chain: T, done, the sums, without branches
#pragma unroll
      for (int g = 0; g < kAhead; ++g) {
        const float test_t = gstpu::next_transmittance(trans, pa[g].alpha);
        const bool live = pa[g].pass && !done;
        const bool kept = live && test_t >= gstpu::kTEps;
        done = done || (live && test_t < gstpu::kTEps);
        if (kept) {
          const gstpu::Record& r = rec[j0 + g];
          const float w = pa[g].alpha * trans;
          c_r += w * r.q1.z;
          c_g += w * r.q1.w;
          c_b += w * r.q2.x;
          d_acc += w * r.q2.y;
          trans = test_t;
          last = base + j0 + g + 1;
        }
      }
    }
    // also the barrier before the next batch overwrites the records
    if (__syncthreads_count(done) == kGroupPixels) break;
  }
  if (ckpt != nullptr) {
    for (; next_ckpt * segment < count; ++next_ckpt)
      write_checkpoint(ckpt, first + next_ckpt, p, trans, c_r, c_g, c_b,
                       d_acc, done);
  }

  const size_t o = static_cast<size_t>(tile) * kPixels + p;
  color[3 * o + 0] = c_r;
  color[3 * o + 1] = c_g;
  color[3 * o + 2] = c_b;
  dacc[o] = d_acc;
  final_t[o] = trans;
  n_contrib[o] = last;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`, writes the number of CTAs it launched
// (one per 64-pixel strip of a tile) to the host int *ctas, and returns
// cudaGetLastError().  `order` holds the num_tiles tile indices in the
// order their CTAs start; `ckpt` (with `segment`, `ends` and `items`) may
// be null for no checkpoints.
int gstpu_rasterize_fwd(const float* table, const int* gauss_id,
                        const int* tile_start, const int* tile_count,
                        const int* order, int num_tiles, int grid_x, int row0,
                        int row_stride, int segment, const int* ends,
                        int* items, float* ckpt, float* color, float* dacc,
                        float* final_t, int* n_contrib, int* ctas, int device,
                        void* stream) {
  *ctas = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0) {
    const int grid = num_tiles * kGroups;
    rasterize_fwd_kernel<<<grid, kGroupPixels, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        table, gauss_id, tile_start, tile_count, order, grid_x, row0,
        row_stride, segment, ends, reinterpret_cast<int2*>(items), ckpt,
        color, dacc, final_t, n_contrib);
    *ctas = grid;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gstpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
