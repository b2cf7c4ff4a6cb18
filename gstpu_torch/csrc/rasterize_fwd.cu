// Forward compositing of 16x16 pixel tiles for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gstpu/ops/pallas_rasterize.py::_fwd_kernel.  The
// plain PyTorch version of the same function is
// gstpu_torch/ops/rasterize.py::composite_forward; the wrapper that builds
// and launches this file is gstpu_torch/ops/cuda_rasterize.py.
//
// Design.  One CTA of 256 threads per tile of the band, one thread per pixel
// in the pixel order p = ly*16 + lx.  The CTA walks the tile's depth-sorted
// pair range [tile_start, tile_start + tile_count) in batches of 256: each
// thread loads one pair's packed Gaussian record (x, y, conic a/b/c, opacity,
// r, g, b, inverse depth) into shared memory (10 KB), then every thread runs
// the reference's sequential walk over the batch for its pixel:
//
//   power = -0.5*(a*dx*dx + c*dy*dy) - b*dx*dy,  dx = x - pixel_x
//   skip if power > 0;  alpha = min(0.99, op*exp(power));  skip if alpha < 1/255
//   test_T = T*(1-alpha);  if test_T < 1e-4: done, break
//   C += alpha*T*rgb;  D += alpha*T*invd;  T = test_T;  last = pos + 1
//
// and the CTA leaves the tile once __syncthreads_count(done) reaches 256.
// The TPU kernel's sorted-order feature gather, 128-lane head masking, DMA
// slot ping-pong and roll-based cumulative product exist for the TPU's
// layout and have no counterpart here.
//
// Bound on this card: the fp32 ALU and the exp unit over the evaluated
// (pixel, pair) steps (about 20 operations each).  The bytes are small beside
// them: one 40-byte record and one 4-byte id per pair and tile, plus 24 bytes
// of output per pixel.  This first version is right and simple; double
// buffering the shared-memory batches, warp-level culling of pairs that miss
// the whole tile, and load balance across the very uneven tiles are later
// work.
//
// Numerics.  Built without fast math and with -fmad=false, so the per-pair
// arithmetic rounds like the reference's separate multiplies and adds; expf,
// not __expf.  The thresholds are the float32 roundings of the double
// constants that the JAX code compares against.  The per-(pixel, pair) alpha,
// skip and transmittance arithmetic lives in composite_common.cuh, which the
// backward kernel (rasterize_bwd.cu) includes too, so both decide the same
// kept pairs bit for bit.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using gstpu::kPixels;
using gstpu::kRecord;

__global__ void __launch_bounds__(kPixels)
rasterize_fwd_kernel(const float* __restrict__ table,
                     const int* __restrict__ gauss_id,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     int grid_x, int row0, int row_stride,
                     float* __restrict__ color, float* __restrict__ dacc,
                     float* __restrict__ final_t, int* __restrict__ n_contrib) {
  // structure of arrays: the loads by thread p hit distinct banks, the reads
  // of record j are one broadcast
  __shared__ float rec[kRecord][kPixels];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  float pix_x, pix_y;
  gstpu::pixel_center(tile, p, grid_x, row0, row_stride, &pix_x, &pix_y);
  const int start = tile_start[tile];
  const int count = tile_count[tile];

  float trans = 1.0f;
  float c_r = 0.0f, c_g = 0.0f, c_b = 0.0f, d_acc = 0.0f;
  int last = 0;
  bool done = false;

  for (int base = 0; base < count; base += kPixels) {
    const int batch = min(kPixels, count - base);
    if (p < batch) {
      const float* r =
          table + static_cast<size_t>(gauss_id[start + base + p]) * kRecord;
#pragma unroll
      for (int f = 0; f < kRecord; ++f) rec[f][p] = r[f];
    }
    __syncthreads();

    for (int j = 0; j < batch && !done; ++j) {
      gstpu::PairAlpha pa;
      if (!gstpu::pair_alpha(&rec[0][0], kPixels, j, pix_x, pix_y, &pa))
        continue;
      const float alpha = pa.alpha;
      const float test_t = gstpu::next_transmittance(trans, alpha);
      if (test_t < gstpu::kTEps) {
        done = true;
        break;
      }
      const float w = alpha * trans;
      c_r += w * rec[6][j];
      c_g += w * rec[7][j];
      c_b += w * rec[8][j];
      d_acc += w * rec[9][j];
      trans = test_t;
      last = base + j + 1;
    }
    // also the barrier before the next batch overwrites the records
    if (__syncthreads_count(done) == kPixels) break;
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

// Launches the kernel on `stream` and returns cudaGetLastError().
int gstpu_rasterize_fwd(const float* table, const int* gauss_id,
                        const int* tile_start, const int* tile_count,
                        int num_tiles, int grid_x, int row0, int row_stride,
                        float* color, float* dacc, float* final_t,
                        int* n_contrib, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles > 0) {
    rasterize_fwd_kernel<<<num_tiles, kPixels, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        table, gauss_id, tile_start, tile_count, grid_x, row0, row_stride,
        color, dacc, final_t, n_contrib);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gstpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
