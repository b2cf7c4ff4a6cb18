// Per-(pixel, pair) arithmetic shared by the forward (rasterize_fwd.cu) and
// backward (rasterize_bwd.cu) compositing kernels.
//
// The backward kernel decides again which pairs each pixel kept.  If it
// rounded power, expf or T*(1-alpha) differently from the forward that
// produced final_t, its kept set would differ and dL/dalpha would break at
// those pixels.  Both kernels therefore take these functions from this one
// header and are built with the same flags (-fmad=false, no fast math).

#pragma once

#include <cuda_runtime.h>

namespace gstpu {

constexpr int kTileSide = 16;
constexpr int kPixels = kTileSide * kTileSide;  // pixels per tile

// A Gaussian's packed record, as the wrapper writes the table (12 floats a
// row, 16-byte aligned, so it moves in three 16-byte loads):
// q0 = (x, y, conic a, conic b), q1 = (conic c, opacity, r, g),
// q2 = (b, inverse depth, pad, pad).
struct Record {
  float4 q0, q1, q2;
};
constexpr int kRecord = 12;  // floats per row of the table

// The float32 roundings of the double constants the JAX code compares with.
constexpr float kAlphaMin = static_cast<float>(1.0 / 255.0);
constexpr float kAlphaMax = static_cast<float>(0.99);
constexpr float kTEps = static_cast<float>(1e-4);

// A checkpoint is a pixel's forward state at a pair position k*segment of
// its tile: kCkptFields planes of kPixels floats, in this order.  The
// forward kernel writes the slot of work item (tile, k) and the item; the
// backward kernel's CTA for that slot starts from it.
enum CkptField { kCkptT, kCkptR, kCkptG, kCkptB, kCkptD, kCkptDone,
                 kCkptFields };
// The forward kernel stages this many pairs per batch; a segment is a
// multiple of it, so every checkpoint falls on a batch start.
constexpr int kFwdBatch = 256;

struct PairAlpha {
  float dx, dy;  // Gaussian center minus pixel center
  float g;       // exp(power) where the pair passes
  float alpha;   // min(0.99, opacity * g)
  bool pass;     // false where the reference `continue`s
};

// Alpha of one pair at one pixel with the reference's individual skips:
// the pair does not pass where power > 0 (or NaN) or alpha < 1/255 (or
// NaN).  No branch: exp takes min(power, 0), which is power wherever the
// pair passes, so the alphas of several pairs can be computed side by side.
__device__ __forceinline__ PairAlpha pair_alpha(const Record& r, float pix_x,
                                                float pix_y) {
  PairAlpha o;
  o.dx = r.q0.x - pix_x;
  o.dy = r.q0.y - pix_y;
  const float power = -0.5f * (r.q0.z * o.dx * o.dx + r.q1.x * o.dy * o.dy) -
                      r.q0.w * o.dx * o.dy;
  o.g = expf(fminf(power, 0.0f));
  const float a = r.q1.y * o.g;
  o.alpha = a > kAlphaMax ? kAlphaMax : a;  // NaN stays NaN
  o.pass = power <= 0.0f && o.alpha >= kAlphaMin;
  return o;
}

// Transmittance after a pair of this alpha; the pixel is done (and the pair
// not kept) when it falls below kTEps.
__device__ __forceinline__ float next_transmittance(float t, float alpha) {
  return t * (1.0f - alpha);
}

// Stage record `gid` of the table into shared memory.
__device__ __forceinline__ void load_record(const float* __restrict__ table,
                                            int gid, Record* dst) {
  const float4* r =
      reinterpret_cast<const float4*>(table + static_cast<size_t>(gid) *
                                                  kRecord);
  dst->q0 = r[0];
  dst->q1 = r[1];
  dst->q2 = r[2];
}

// Pixel-center coordinates of pixel p of band tile `tile`.
__device__ __forceinline__ void pixel_center(int tile, int p, int grid_x,
                                             int row0, int row_stride,
                                             float* pix_x, float* pix_y) {
  const int tx = tile % grid_x;
  const int ty = (tile / grid_x) * row_stride + row0;
  *pix_x = static_cast<float>(tx * kTileSide + p % kTileSide);
  *pix_y = static_cast<float>(ty * kTileSide + p / kTileSide);
}

}  // namespace gstpu
