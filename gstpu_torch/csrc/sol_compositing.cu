// The compositing arithmetic alone, on one resident block, for the
// speed-of-light model of NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/sol_model.py::sol_compositing.kernel.  The
// plain PyTorch version of the same function is
// gstpu_torch/sol_model.py::sol_compositing_plain; the wrapper that builds
// and launches this file is gstpu_torch/sol_model.py::sol_compositing.
//
// What it computes.  Every CTA ("tile") reads the same (16, 128) f32 feature
// block, one column per lane (pair): x, y, conic a/b/c, opacity and four
// colour-like rows 6-9 (rows 10-15 are read by nobody).  Pixel p of the 256
// sits at (p / 16, p / 32).  For n_chunks chunks c, with every feature
// multiplied by (1 + c * 1e-7) in float32 (the loop-counter tie of the JAX
// code, which keeps the body in the loop), the pixel walks the 128 lanes:
//
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy;  g = exp(min(power, 0))
//   alpha = min(0.99, op g), zeroed below 1/255
//   p_incl = T * prod_{k <= lane} (1 - alpha_k);  t_ex = p_incl / (1 - alpha)
//   kept = p_incl >= 1e-4;  w = kept ? alpha t_ex : 0
//
// with no done flag and no early exit; after the chunk T becomes the least
// kept p_incl (unchanged when no lane was kept).
// - Forward (out (tiles, 2, 256)): row 0 is the pixel's sum over lanes and
//   chunks of w * row 6, row 1 its final T.  The JAX code carries four such
//   accumulators (rows 6-9); only the first reaches the output, so nvcc drops
//   the other three.  They are written below as the JAX code has them.
// - Backward (out (tiles, 2, 128)): with cdot = (row6+row7+row8+row9) w,
//   u = w cdot, cum_u the inclusive prefix sum of u along the lanes and
//   prefix_u the pixel's sum of u over the earlier chunks,
//     dL/dalpha = kept ? cdot t_ex - (prefix_u + cum_u)/(1-alpha)
//                        - 0.25/(1-alpha) : 0,
//   row 0 of lane j is the sum over pixels and chunks of the six gradient
//   terms of the compositing backward, row 1 that of w (px + py + px+1 +
//   cdot).
//
// Design.  One 256-thread CTA per tile, one thread per pixel, the block in
// shared memory (8 KB).  Each thread walks the lanes in order, so the
// inclusive product (the TPU kernel's roll-doubling) and the prefix sum of u
// (its upper-triangular product on the MXU) are running values in registers.
// The backward's sums over the 256 pixels of each lane go without float
// atomics, as in rasterize_bwd.cu: each warp sums its 32 pixels' two values
// with a fixed shuffle tree, lane 0 writes the warp partials to shared
// memory, and after the chunk thread (field, lane) adds the 8 partials in
// order to its running sum.  Every tile computes the same bits, and two runs
// give identical bits.
//
// Bound on this card: the fp32 ALU.  A launch at the sol model's volumes
// walks tiles x 256 x 128 x n_chunks (pixel, lane) steps of some tens of
// operations each; it reads one 8 KB block and writes 2 floats per pixel
// (forward) or per lane (backward) per tile.  This first version is the
// simple one: the backward pays 10 shuffles per warp per lane.
//
// Numerics: no fast math, -fmad=false, expf.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kChunk = 128;  // lanes (pairs) per chunk
constexpr int kPix = 256;    // pixels per tile, threads per CTA
constexpr int kRows = 16;    // feature rows of the block
constexpr int kWarps = kPix / 32;
constexpr unsigned kFull = 0xffffffffu;

// The float32 roundings of the double constants of the JAX code.
constexpr float kAlphaMin = static_cast<float>(1.0 / 255.0);
constexpr float kAlphaMax = static_cast<float>(0.99);
constexpr float kTEps = static_cast<float>(1e-4);
constexpr float kTie = static_cast<float>(1e-7);

template <bool kBackward>
__global__ void __launch_bounds__(kPix)
sol_compositing_kernel(const float* __restrict__ feat, int n_chunks,
                       float* __restrict__ out) {
  __shared__ float blk[kRows][kChunk];          // 8,192 B
  __shared__ float part[kWarps][2][kChunk];     // 8,192 B, backward only

  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  for (int i = p; i < kRows * kChunk; i += kPix) blk[i / kChunk][i % kChunk] = feat[i];
  __syncthreads();

  const float pix_x = static_cast<float>(p) * 0.0625f;
  const float pix_y = pix_x * 0.5f;
  float trans = 1.0f;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;  // forward
  float prefix_u = 0.0f;                                    // backward
  float lane_acc = 0.0f;  // backward: field p / 128 of lane p % 128

  for (int c = 0; c < n_chunks; ++c) {
    const float s = 1.0f + static_cast<float>(c) * kTie;
    float prod = 1.0f;
    float p_last = INFINITY;
    float cum_u = 0.0f;
    for (int j = 0; j < kChunk; ++j) {  // uniform: every thread walks all lanes
      const float x = blk[0][j] * s;
      const float y = blk[1][j] * s;
      const float ca = blk[2][j] * s;
      const float cb = blk[3][j] * s;
      const float cc = blk[4][j] * s;
      const float op = blk[5][j] * s;
      const float f6 = blk[6][j] * s;
      const float f7 = blk[7][j] * s;
      const float f8 = blk[8][j] * s;
      const float f9 = blk[9][j] * s;
      const float dx = x - pix_x;
      const float dy = y - pix_y;
      const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
      const float g = expf(fminf(power, 0.0f));
      float alpha = fminf(kAlphaMax, op * g);
      alpha = alpha >= kAlphaMin ? alpha : 0.0f;
      prod = prod * (1.0f - alpha);
      const float p_incl = trans * prod;
      const float t_ex = p_incl / (1.0f - alpha);
      const bool kept = p_incl >= kTEps;
      const float w = kept ? alpha * t_ex : 0.0f;
      if (kept) p_last = fminf(p_last, p_incl);
      if (!kBackward) {
        acc0 = acc0 + w * f6;
        acc1 = acc1 + w * f7;
        acc2 = acc2 + w * f8;
        acc3 = acc3 + w * f9;
      } else {
        const float cdot = (f6 + f7 + f8 + f9) * w;
        const float u = w * cdot;
        cum_u = cum_u + u;
        const float inv_one_m = 1.0f / (1.0f - alpha);
        const float dl_da =
            kept ? cdot * t_ex - (prefix_u + cum_u) * inv_one_m -
                       inv_one_m * 0.25f
                 : 0.0f;
        const float dl_dg = op * dl_da;
        const float gdx = g * dx;
        const float gdy = g * dy;
        float r = dl_dg * (-gdx * ca - gdy * cb);
        r = r + dl_dg * (-gdy * cc - gdx * cb);
        r = r + -0.5f * gdx * dx * dl_dg;
        r = r + -0.5f * gdx * dy * dl_dg;
        r = r + -0.5f * gdy * dy * dl_dg;
        r = r + (kept ? g : 0.0f) * dl_da;
        float r2 = w * pix_x;
        r2 = r2 + w * pix_y;
        r2 = r2 + w * (pix_x + 1.0f);
        r2 = r2 + w * cdot;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          r += __shfl_down_sync(kFull, r, off);
          r2 += __shfl_down_sync(kFull, r2, off);
        }
        if (lane == 0) {
          part[warp][0][j] = r;
          part[warp][1][j] = r2;
        }
      }
    }
    trans = isfinite(p_last) ? p_last : trans;
    if (kBackward) {
      prefix_u = prefix_u + cum_u;
      __syncthreads();
      const int f = p / kChunk;
      const int j = p % kChunk;
      float sum = part[0][f][j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += part[w][f][j];
      lane_acc = lane_acc + sum;
      __syncthreads();  // before the next chunk overwrites part
    }
  }

  if (!kBackward) {
    float* o = out + static_cast<size_t>(blockIdx.x) * 2 * kPix;
    o[p] = acc0;
    o[kPix + p] = trans;
  } else {
    out[static_cast<size_t>(blockIdx.x) * 2 * kChunk + p] = lane_acc;
  }
}

}  // namespace

extern "C" {

// Launches one CTA per tile on `stream` and returns cudaGetLastError().
// `feat` is the (16, 128) block; `out` is (tiles, 2, 256) forward or
// (tiles, 2, 128) backward.
int gstpu_sol_compositing(const float* feat, int tiles, int n_chunks,
                          int backward, float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (backward) {
      sol_compositing_kernel<true><<<tiles, kPix, 0, s>>>(feat, n_chunks, out);
    } else {
      sol_compositing_kernel<false><<<tiles, kPix, 0, s>>>(feat, n_chunks, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gstpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
