// Backward compositing of 16x16 pixel tiles for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gstpu/ops/pallas_rasterize.py::_bwd_kernel (with
// the row layout that its epilogue reads).  The plain PyTorch version of the
// same function is gstpu_torch/ops/rasterize.py::composite_backward; the
// wrapper that builds and launches this file, builds its work list and runs
// the epilogue, is gstpu_torch/ops/cuda_rasterize.py.
//
// What it computes.  For every pair slot q of a tile's depth-sorted range
// [tile_start, tile_start + tile_count) it writes one row of ten sums over
// the tile's 256 pixels: dL/dmean2d x and y (before the 0.5*W, 0.5*H NDC
// scale), dL/dconic a, b, c (b with the reference's half convention),
// dL/dopacity, dL/drgb r, g, b and dL/dinvdepth.  Rows of pairs past the
// tile's early exit, and slots of no tile, are not written: the wrapper
// allocates the rows zeroed.
//
// The walk.  Each thread walks its pixel's pairs in forward order, as the
// TPU kernel does, keeping the pixel's transmittance, done flag and the
// running prefix of w*cdot (the JAX kernel's tdp rows):
//
//   cdot = rgb . dL/dpix + invdepth * dL/ddepth;   prefix += w*cdot
//   dL/dalpha = cdot*T - (ctot_dot - prefix)/(1-alpha)
//               - final_T*bg_dot/(1-alpha)
//
// where ctot_dot = color . dL/dpix + depth * dL/ddepth and bg_dot = bg .
// dL/dpix per pixel come in from the wrapper.  The forward's alpha and
// transmittance arithmetic comes from composite_common.cuh bit for bit, so
// the kept set is exactly the one the forward kernel composited.
//
// What bounds it on this card.  The fp32 ALU over the evaluated (pixel,
// pair) steps, plus the gradient terms of the kept steps and the sums over
// pixels; the bytes (one 48-byte record and one 40-byte row per pair slot,
// 28 bytes per pixel) are small beside them.  As in the forward, one deep
// tile's serial walk would set the time of a whole launch; the design:
//
// - Segments.  One CTA of 256 threads (one per pixel) per work item (tile,
//   k): the pairs [k*segment, (k+1)*segment) of the tile.  The item starts
//   from the forward kernel's checkpoint of that position (T, done, and the
//   color and inverse depth so far, from which prefix = C . dL/dpix +
//   D * dL/ddepth), so T, and with it the kept set, is the forward's float
//   bit for bit; only the prefix rounds differently.  Each pair slot's row
//   is written by exactly one CTA: no atomics, and the rows are
//   deterministic.  Without checkpoints every item is a whole tile starting
//   at T = 1 (the same kernel).
// - Deepest first: the items come in the order of their tiles' tile_count,
//   descending, a tile's segments in order.  The forward kernel writes the
//   item list beside the checkpoints (item b starts from checkpoint b); the
//   wrapper launches a fixed bound of CTAs, and those past the item count
//   return at once, so nothing is read back to the host.
// - Sums over a warp by a transposed reduction: each lane's ten values,
//   padded to 16, are halved by exchanges at lane distances 16, 8, 4 and 2
//   (each lane keeps the half its partner sends away) and summed at distance
//   1: 8+4+2+1+1 = 16 shuffles per pair in place of 10 trees of 5.  Lane 2f
//   ends holding field f's warp sum, in a fixed order, and writes it to
//   shared memory; after each batch one thread per (pair, field) adds the 8
//   warp partials in order and writes the row.  A pair no lane of the warp
//   kept is not reduced.
// - Batches of 64 pairs: the records and the warp partials take 23,552 B
//   of shared memory.  ptxas gives 48 registers and no spills, so 5 CTAs
//   (40 warps) fit on an SM; launch bounds asking for 4, 5 or 6 CTAs per SM
//   (62, 48 and 40 registers, spilling at 40) ran slower on the H100
//   (PERF.md, from scripts/torch_kernel_variants.py).
//
// Numerics as the forward kernel: no fast math, -fmad=false, expf.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using gstpu::kPixels;

constexpr int kBatch = 64;             // pairs staged per batch
constexpr int kRows = 10;              // gradient sums per pair
constexpr int kPadded = 16;            // kRows padded for the transposed sum
constexpr int kWarps = kPixels / 32;
constexpr int kPixIn = 7;              // per-pixel input planes
constexpr unsigned kFull = 0xffffffffu;

// One exchange of the transposed sum: lanes with `bit` set keep the upper
// `half` of v[0, 2*half) and send the lower one, the others the reverse;
// each adds what its partner at lane distance `bit` sent.
template <int kHalf>
__device__ __forceinline__ void exchange(float (&v)[kPadded], int lane,
                                         int bit) {
  const bool upper = lane & bit;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const float send = upper ? v[k] : v[k + kHalf];
    const float keep = upper ? v[k + kHalf] : v[k];
    v[k] = keep + __shfl_xor_sync(kFull, send, bit);
  }
}

// The warp's sum of field (lane >> 1) of v; v[kRows, kPadded) are zero.
__device__ __forceinline__ float transposed_sum(float (&v)[kPadded],
                                                int lane) {
  exchange<8>(v, lane, 16);
  exchange<4>(v, lane, 8);
  exchange<2>(v, lane, 4);
  exchange<1>(v, lane, 2);
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

__global__ void __launch_bounds__(kPixels)
rasterize_bwd_kernel(const float* __restrict__ table,
                     const int* __restrict__ gauss_id,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const int* __restrict__ order,
                     const int2* __restrict__ items,
                     const int* __restrict__ num_items, int segment,
                     const float* __restrict__ ckpt,
                     const float* __restrict__ pix_in,
                     int grid_x, int row0, int row_stride,
                     float* __restrict__ rows) {
  __shared__ gstpu::Record rec[kBatch];                //  3,072 B
  __shared__ float part[kWarps][kBatch * kRows];       // 20,480 B

  // work item blockIdx.x: the whole tile order[b] from T = 1, or segment
  // item.y of tile item.x from K1's checkpoint b
  const int b = blockIdx.x;
  int2 item = make_int2(0, 0);
  if (ckpt == nullptr) {
    item.x = order[b];
  } else {
    if (b >= *num_items) return;                        // a pad
    item = items[b];
  }
  const int tile = item.x;
  const int count = tile_count[tile];
  const int first = item.y * segment;
  if (first >= count) return;
  const int length = min(segment, count - first);
  const int start = tile_start[tile] + first;

  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  float pix_x, pix_y;
  gstpu::pixel_center(tile, p, grid_x, row0, row_stride, &pix_x, &pix_y);

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
  if (ckpt != nullptr) {
    const float* c =
        ckpt + static_cast<size_t>(b) * gstpu::kCkptFields * kPixels + p;
    trans = c[gstpu::kCkptT * kPixels];
    prefix = c[gstpu::kCkptR * kPixels] * ct_r +
             c[gstpu::kCkptG * kPixels] * ct_g +
             c[gstpu::kCkptB * kPixels] * ct_b +
             c[gstpu::kCkptD * kPixels] * ct_d;
    done = c[gstpu::kCkptDone * kPixels] != 0.0f;
  }
  if (__syncthreads_count(done) == kPixels) return;

  for (int base = 0; base < length; base += kBatch) {
    const int batch = min(kBatch, length - base);
    if (p < batch) gstpu::load_record(table, gauss_id[start + base + p], &rec[p]);
    __syncthreads();

    for (int j = 0; j < batch; ++j) {  // uniform: every lane reaches the shuffles
      float v[kPadded];
#pragma unroll
      for (int f = 0; f < kPadded; ++f) v[f] = 0.0f;
      bool kept = false;
      const gstpu::Record r = rec[j];
      const gstpu::PairAlpha pa = gstpu::pair_alpha(r, pix_x, pix_y);
      if (!done && pa.pass) {
        const float test_t = gstpu::next_transmittance(trans, pa.alpha);
        if (test_t < gstpu::kTEps) {
          done = true;
        } else {
          kept = true;
          const float w = pa.alpha * trans;
          const float cdot = r.q1.z * ct_r + r.q1.w * ct_g + r.q2.x * ct_b +
                             r.q2.y * ct_d;
          prefix += w * cdot;
          const float inv_one_m = 1.0f / (1.0f - pa.alpha);
          const float dl_dalpha = cdot * trans -
                                  (ctot_dot - prefix) * inv_one_m -
                                  (final_t * inv_one_m) * bg_dot;
          const float ca = r.q0.z, cb = r.q0.w, cc = r.q1.x;
          const float dl_dg = r.q1.y * dl_dalpha;
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
      const float s = __any_sync(kFull, kept) ? transposed_sum(v, lane) : 0.0f;
      if ((lane & 1) == 0 && (lane >> 1) < kRows)
        part[warp][j * kRows + (lane >> 1)] = s;
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

// Launches `ctas` CTAs on `stream` and returns cudaGetLastError().
// Without checkpoints (`ckpt` null) CTA b walks the whole tile order[b];
// with them, CTA b < *num_items walks the segment items[b] = (tile, k) of
// `segment` pairs from checkpoint b, and the CTAs past *num_items return.
int gstpu_rasterize_bwd(const float* table, const int* gauss_id,
                        const int* tile_start, const int* tile_count,
                        const int* order, const int* items,
                        const int* num_items, int ctas, int segment,
                        const float* ckpt, const float* pix_in, int grid_x,
                        int row0, int row_stride, float* rows, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ctas > 0) {
    rasterize_bwd_kernel<<<ctas, kPixels, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        table, gauss_id, tile_start, tile_count, order,
        reinterpret_cast<const int2*>(items), num_items, segment, ckpt,
        pix_in, grid_x, row0, row_stride, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gstpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
