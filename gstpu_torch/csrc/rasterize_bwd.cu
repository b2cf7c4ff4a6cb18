// Backward compositing of 16x16 pixel tiles for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gstpu/ops/pallas_rasterize.py::_bwd_kernel (with
// the row layout that its epilogue reads).  The plain PyTorch version of the
// same function is gstpu_torch/ops/rasterize.py::composite_backward; the
// wrapper that builds and launches this file, and runs the epilogue, is
// gstpu_torch/ops/cuda_rasterize.py.
//
// What it computes.  For every pair slot q of a tile's depth-sorted range
// [tile_start, tile_start + tile_count) it writes one row of ten sums over
// the tile's 256 pixels: dL/dmean2d x and y (before the 0.5*W, 0.5*H NDC
// scale), dL/dconic a, b, c (b with the reference's half convention),
// dL/dopacity, dL/drgb r, g, b and dL/dinvdepth.  Rows of pairs past the
// tile's early exit, and slots of no tile, are not written: the wrapper
// allocates the rows zeroed.
//
// Design.  The same shape as the forward kernel: one CTA of 256 threads per
// tile of the band, one thread per pixel, the tile's Gaussian records staged
// in shared memory in batches of 128.  Each thread walks the pairs in
// forward order, as the TPU kernel does, keeping its pixel's transmittance,
// done flag and the running prefix of w*cdot (the JAX kernel's tdp rows):
//
//   cdot = rgb . dL/dpix + invdepth * dL/ddepth;   prefix += w*cdot
//   dL/dalpha = cdot*T - (ctot_dot - prefix)/(1-alpha)
//               - final_T*bg_dot/(1-alpha)
//
// where ctot_dot = color . dL/dpix + depth * dL/ddepth and bg_dot = bg .
// dL/dpix per pixel come in from the wrapper.  A forward-order walk needs no
// n_contrib and no division to undo T, and it reuses the forward's alpha and
// transmittance arithmetic from composite_common.cuh bit for bit, so the
// kept set is exactly the one the forward kernel composited.
//
// Per-pair sums without float atomics: the loop over a batch is warp-uniform
// (a done pixel or a skipped pair contributes exact zeros), each warp sums
// its 32 lanes' ten values with a fixed shuffle tree (skipped when no lane
// kept the pair), lane 0 writes the warp's partials to shared memory, and
// after the batch each (pair, field) is summed over the 8 warps in order by
// one thread and written once.  Two runs on the same inputs give
// bit-identical rows.
//
// Bound on this card: the fp32 ALU over the evaluated (pixel, pair) steps,
// as for the forward kernel, plus the gradient terms of the kept steps and
// the sums over pixels; the bytes (one 40-byte record and one 40-byte row
// per pair slot, 28 bytes per pixel) are small beside them.  This first
// version pays for determinism with 50 shuffles per warp for every pair that
// some lane of the warp kept, and with the same load imbalance across tiles
// as the forward kernel; reducing fewer fields per shuffle, a transposed
// reduction and balancing tiles are later work.
//
// Numerics as the forward kernel: no fast math, -fmad=false, expf.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using gstpu::kPixels;
using gstpu::kRecord;

constexpr int kBatch = 128;            // pairs staged per batch
constexpr int kRows = 10;              // gradient sums per pair
constexpr int kWarps = kPixels / 32;
constexpr int kPixIn = 7;              // per-pixel input planes
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kPixels)
rasterize_bwd_kernel(const float* __restrict__ table,
                     const int* __restrict__ gauss_id,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const float* __restrict__ pix_in,
                     int grid_x, int row0, int row_stride,
                     float* __restrict__ rows) {
  __shared__ float rec[kRecord][kBatch];               //  5,120 B
  __shared__ float part[kWarps][kBatch * kRows];       // 40,960 B

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  float pix_x, pix_y;
  gstpu::pixel_center(tile, p, grid_x, row0, row_stride, &pix_x, &pix_y);
  const int start = tile_start[tile];
  const int count = tile_count[tile];

  // (T, 7, 256) planes: ctot_dot, bg_dot, final_T, dL/dpix r g b, dL/ddepth
  const float* in = pix_in + static_cast<size_t>(tile) * kPixIn * kPixels + p;
  const float ctot_dot = in[0 * kPixels];
  const float bg_dot = in[1 * kPixels];
  const float final_t = in[2 * kPixels];
  const float ct_r = in[3 * kPixels];
  const float ct_g = in[4 * kPixels];
  const float ct_b = in[5 * kPixels];
  const float ct_d = in[6 * kPixels];

  float trans = 1.0f;
  float prefix = 0.0f;
  bool done = false;

  for (int base = 0; base < count; base += kBatch) {
    const int batch = min(kBatch, count - base);
    if (p < batch) {
      const float* r =
          table + static_cast<size_t>(gauss_id[start + base + p]) * kRecord;
#pragma unroll
      for (int f = 0; f < kRecord; ++f) rec[f][p] = r[f];
    }
    __syncthreads();

    for (int j = 0; j < batch; ++j) {  // uniform: every lane reaches the shuffles
      float v[kRows];
#pragma unroll
      for (int f = 0; f < kRows; ++f) v[f] = 0.0f;
      bool kept = false;
      gstpu::PairAlpha pa;
      if (!done &&
          gstpu::pair_alpha(&rec[0][0], kBatch, j, pix_x, pix_y, &pa)) {
        const float test_t = gstpu::next_transmittance(trans, pa.alpha);
        if (test_t < gstpu::kTEps) {
          done = true;
        } else {
          kept = true;
          const float w = pa.alpha * trans;
          const float cdot = rec[6][j] * ct_r + rec[7][j] * ct_g +
                             rec[8][j] * ct_b + rec[9][j] * ct_d;
          prefix += w * cdot;
          const float inv_one_m = 1.0f / (1.0f - pa.alpha);
          const float dl_dalpha = cdot * trans -
                                  (ctot_dot - prefix) * inv_one_m -
                                  (final_t * inv_one_m) * bg_dot;
          const float ca = rec[2][j], cb = rec[3][j], cc = rec[4][j];
          const float dl_dg = rec[5][j] * dl_dalpha;
          const float gdx = pa.g * pa.dx;
          const float gdy = pa.g * pa.dy;
          const float dg_ddelx = -gdx * ca - gdy * cb;
          const float dg_ddely = -gdy * cc - gdx * cb;
          v[0] = dl_dg * dg_ddelx;
          v[1] = dl_dg * dg_ddely;
          v[2] = -0.5f * gdx * pa.dx * dl_dg;
          v[3] = -0.5f * gdx * pa.dy * dl_dg;
          v[4] = -0.5f * gdy * pa.dy * dl_dg;
          v[5] = pa.g * dl_dalpha;
          v[6] = w * ct_r;
          v[7] = w * ct_g;
          v[8] = w * ct_b;
          v[9] = w * ct_d;
          trans = test_t;
        }
      }
      float* out = &part[warp][j * kRows];
      if (__any_sync(kFull, kept)) {
#pragma unroll
        for (int f = 0; f < kRows; ++f) {
          float s = v[f];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            s += __shfl_down_sync(kFull, s, off);
          if (lane == 0) out[f] = s;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int f = 0; f < kRows; ++f) out[f] = 0.0f;
      }
    }
    __syncthreads();

    // (pair, field) i of the batch: the 8 warp partials in order, one write
    float* dst = rows + static_cast<size_t>(start + base) * kRows;
    for (int i = p; i < batch * kRows; i += kPixels) {
      float s = part[0][i];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += part[w][i];
      dst[i] = s;
    }
    // also the barrier before the next batch overwrites rec and part
    if (__syncthreads_count(done) == kPixels) break;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError().
int gstpu_rasterize_bwd(const float* table, const int* gauss_id,
                        const int* tile_start, const int* tile_count,
                        const float* pix_in, int num_tiles, int grid_x,
                        int row0, int row_stride, float* rows, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0) {
    rasterize_bwd_kernel<<<num_tiles, kPixels, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        table, gauss_id, tile_start, tile_count, pix_in, grid_x, row0,
        row_stride, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gstpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
