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
constexpr int kPixels = kTileSide * kTileSide;  // threads per CTA
constexpr int kRecord = 10;                     // floats per Gaussian record

// The float32 roundings of the double constants the JAX code compares with.
constexpr float kAlphaMin = static_cast<float>(1.0 / 255.0);
constexpr float kAlphaMax = static_cast<float>(0.99);
constexpr float kTEps = static_cast<float>(1e-4);

struct PairAlpha {
  float dx, dy;  // Gaussian center minus pixel center
  float g;       // exp(power)
  float alpha;   // min(0.99, opacity * g)
};

// Alpha of one pair at one pixel with the reference's individual skips.
// Returns false where the reference `continue`s: power > 0 (or NaN) or
// alpha < 1/255 (or NaN).  `rec` is a structure of arrays of `stride` floats
// per field: x, y, conic a/b/c, opacity (the rest is not read here).
__device__ __forceinline__ bool pair_alpha(const float* rec, int stride,
                                           int j, float pix_x, float pix_y,
                                           PairAlpha* out) {
  const float dx = rec[0 * stride + j] - pix_x;
  const float dy = rec[1 * stride + j] - pix_y;
  const float power =
      -0.5f * (rec[2 * stride + j] * dx * dx + rec[4 * stride + j] * dy * dy) -
      rec[3 * stride + j] * dx * dy;
  if (!(power <= 0.0f)) return false;
  const float g = expf(power);
  const float a = rec[5 * stride + j] * g;
  const float alpha = a > kAlphaMax ? kAlphaMax : a;  // NaN stays NaN
  if (!(alpha >= kAlphaMin)) return false;
  out->dx = dx;
  out->dy = dy;
  out->g = g;
  out->alpha = alpha;
  return true;
}

// Transmittance after a pair of this alpha; the pixel is done (and the pair
// not kept) when it falls below kTEps.
__device__ __forceinline__ float next_transmittance(float t, float alpha) {
  return t * (1.0f - alpha);
}

// Pixel-center coordinates of thread p of band tile `tile`.
__device__ __forceinline__ void pixel_center(int tile, int p, int grid_x,
                                             int row0, int row_stride,
                                             float* pix_x, float* pix_y) {
  const int tx = tile % grid_x;
  const int ty = (tile / grid_x) * row_stride + row0;
  *pix_x = static_cast<float>(tx * kTileSide + p % kTileSide);
  *pix_y = static_cast<float>(ty * kTileSide + p / kTileSide);
}

}  // namespace gstpu
