// Preprocess for NVIDIA Hopper (sm_90a): cull, projection, EWA covariance,
// radius, tile rect and SH colour of every Gaussian in one pass.
//
// Replaces no TPU kernel: gstpu/ops/preprocess.py is jnp, and so is the
// port's plain version, gstpu_torch/ops/preprocess.py::preprocess (with
// ops/math3d.py).  This file exists because that plain version was 9.9 of
// the 18.4 ms of a frame of the benchmark's mip360-view cell on an H100 (2.96M
// Gaussians at 1237x822): about 380 PyTorch elementwise launches over the
// Gaussians, whose launching also kept the host as busy as the card.  The
// wrapper that builds and launches it is gstpu_torch/ops/cuda_preprocess.py.
//
// What it computes: the plain version's PreprocessOut, one thread per
// Gaussian.  The plain version's early returns are masks, and so they are
// here: cov3d is multiplied by the near-cull mask, every other float field
// by the visibility mask (so an invisible Gaussian's field is v * 0: +-0,
// or NaN where v is not finite, as the plain version's), the integer
// fields are 0 where not visible.  The one exception: rgb and clamped of an
// invisible Gaussian are written as +0 without reading its SH row, which is
// the plain version's value whenever the SH row and the direction to the
// camera are finite.
//
// Numerics.  Every product, sum and quotient is the plain version's, in its
// order: built without fast math and with -fmad=false, so nothing fuses
// (PyTorch runs each operation as a launch of its own); IEEE division and
// sqrtf, logf, ceilf; torch.clamp, maximum and minimum keep a NaN; the
// float-to-int casts saturate as math3d.saturating_int32 does.  Constants
// are rounded from the doubles that PyTorch rounds its Python scalars from
// (decimal -> double -> float can differ from decimal -> float), and the
// host-derived scalars (focal lengths, 1.3 * tan_fov, the scale modifier)
// come rounded from the same double expressions.  The norm of the direction
// to the camera is sqrtf((x*x + z*z) + y*y): torch.linalg.vector_norm of
// three floats on the card squares each into an accumulator of its own and
// adds them in that order (it gives those bits on an H100 for every one of
// 4M random vectors, where (x*x + y*y) + z*z differs on 12% of them).
//
// What bounds it on this card: bytes.  Each Gaussian reads 236 bytes
// (means, scales, rotation, opacity, the SH row padded to 16 x 3) and one
// more with an alive mask, and writes the 101 bytes of PreprocessOut: at
// mip360-view's 2.96M Gaussians about 1.00 GB, 0.30 ms at 3.35 TB/s; the
// arithmetic (a few hundred operations a Gaussian) is far below the fp32
// peak.  The design:
//
// - one pass: every input byte is read once and every output byte written
//   once, with no intermediate in device memory;
// - 16-byte loads where a row allows: the rotation as one float4, the SH row
//   (192 bytes) as float4s; writes as wide as the fields: rect as one int4,
//   xy and cov3d as float2s;
// - the SH row is read only for visible Gaussians (the bytes that the
//   culled part of a view does not need are never moved), and it is streamed
//   through the sum: each float4 is consumed in coefficient order as it
//   arrives, so no more than a piece of the row need be live at once;
// - sh_degree selects a template instance, so a lower degree reads only the
//   float4s its (degree + 1)^2 coefficients occupy.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTileInv = 1.0f / 16.0f;  // pixels per tile side: 16 (exact)
constexpr float kIntSafe = 1073741824.0f;  // 2^30, math3d._INT_SAFE

// The plain version's constants, rounded from Python's doubles.
constexpr float kNear = static_cast<float>(0.2);
constexpr float kProjEps = static_cast<float>(1e-7);
constexpr float kBlur = static_cast<float>(0.3);
constexpr float kEigenFloor = static_cast<float>(0.1);
constexpr float kFloor = static_cast<float>(1e-12);
constexpr float kC0 = static_cast<float>(0.28209479177387814);
constexpr float kC1 = static_cast<float>(0.4886025119029199);
constexpr float kC20 = static_cast<float>(1.0925484305920792);
constexpr float kC21 = static_cast<float>(-1.0925484305920792);
constexpr float kC22 = static_cast<float>(0.31539156525252005);
constexpr float kC23 = static_cast<float>(-1.0925484305920792);
constexpr float kC24 = static_cast<float>(0.5462742152960396);
constexpr float kC30 = static_cast<float>(-0.5900435899266435);
constexpr float kC31 = static_cast<float>(2.890611442640554);
constexpr float kC32 = static_cast<float>(-0.4570457994644658);
constexpr float kC33 = static_cast<float>(0.3731763325901154);
constexpr float kC34 = static_cast<float>(-0.4570457994644658);
constexpr float kC35 = static_cast<float>(1.445305721320277);
constexpr float kC36 = static_cast<float>(-0.5900435899266435);

struct Inputs {
  const float* means;      // (N, 3)
  const float* scales;     // (N, 3)
  const float4* rotations; // (N, 4) quaternions (x, y, z, w)
  const float* opacities;  // (N,)
  const float4* shs;       // (N, 16, 3): 12 float4 a row
  const unsigned char* alive;  // (N,) bool, or null
  const float* view;       // (4, 4), [p, 1] @ view
  const float* proj;       // (4, 4), [p, 1] @ proj
  const float* campos;     // (3,)
};

struct Scalars {
  int n, grid_x, grid_y, tight_radius;
  float width, height, focal_x, focal_y, lim_x, lim_y, scale_modifier;
};

struct Outputs {
  int* radii;          // (N,)
  float2* xy;          // (N, 2)
  float* depth;        // (N,)
  float2* cov3d;       // (N, 6): three float2 a row
  float* rgb;          // (N, 3)
  float* conic;        // (N, 3)
  float* opacity;      // (N,)
  int* tiles_touched;  // (N,)
  int4* rect;          // (N, 4)
  float* clamped;      // (N, 3)
  unsigned char* visible;  // (N,) bool
};

// torch.clamp(v, min=lo) and torch.clamp(v, lo, hi): a NaN v stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
// torch.maximum and torch.minimum: a NaN operand wins.
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// math3d.saturating_int32: NaN -> 0, +-inf -> +-2^30, clamp to +-2^30,
// truncate (fmaxf and fminf take an infinity to the bound).
__device__ __forceinline__ int saturating_int32(float v) {
  return isnan(v) ? 0
                  : static_cast<int>(fminf(fmaxf(v, -kIntSafe), kIntSafe));
}

__device__ __forceinline__ int clamp_tile(int v, int hi) {
  return min(max(v, 0), hi);
}

// Column j of [p, 1] @ m: ((x*m0j + y*m1j) + z*m2j) + m3j, as
// math3d.transform_points rounds it.
__device__ __forceinline__ float transform(const float* __restrict__ m,
                                           int j, float x, float y, float z) {
  return ((x * __ldg(m + j) + y * __ldg(m + 4 + j)) + z * __ldg(m + 8 + j))
         + __ldg(m + 12 + j);
}

// math3d.eval_sh for the unit direction (x, y, z): each channel's sum over
// the first (kDegree + 1)^2 coefficients of the row, in coefficient order
// (terms 1 and 3 subtracted).  The row is read a float4 at a time and every
// float is consumed as it comes: float f is coefficient f / 3 of channel
// f % 3.
template <int kDegree>
__device__ __forceinline__ void eval_sh(const float4* __restrict__ row,
                                        float x, float y, float z,
                                        float acc[3]) {
  constexpr int kFloats = 3 * (kDegree + 1) * (kDegree + 1);
  float b[16];
  b[0] = kC0;
  if (kDegree > 0) {
    b[1] = kC1 * y;
    b[2] = kC1 * z;
    b[3] = kC1 * x;
  }
  if (kDegree > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = kC20 * xy;
    b[5] = kC21 * yz;
    b[6] = kC22 * ((2.0f * zz - xx) - yy);
    b[7] = kC23 * xz;
    b[8] = kC24 * (xx - yy);
    if (kDegree > 2) {
      b[9] = (kC30 * y) * (3.0f * xx - yy);
      b[10] = (kC31 * xy) * z;
      b[11] = (kC32 * y) * ((4.0f * zz - xx) - yy);
      b[12] = (kC33 * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
      b[13] = (kC34 * x) * ((4.0f * zz - xx) - yy);
      b[14] = (kC35 * z) * (xx - yy);
      b[15] = (kC36 * x) * (xx - 3.0f * yy);
    }
  }
#pragma unroll
  for (int i = 0; i < (kFloats + 3) / 4; ++i) {
    const float4 v = __ldg(row + i);
    const float part[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = 4 * i + j;
      if (f >= kFloats) break;
      const int k = f / 3;
      const float term = b[k] * part[j];
      float& a = acc[f % 3];
      a = k == 0 ? term : (k == 1 || k == 3 ? a - term : a + term);
    }
  }
}

template <int kDegree>
__global__ void __launch_bounds__(kThreads) preprocess_kernel(
    Inputs in, Scalars s, Outputs out) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= s.n) return;
  const long long i3 = 3LL * g;
  const float mx = __ldg(in.means + i3);
  const float my = __ldg(in.means + i3 + 1);
  const float mz = __ldg(in.means + i3 + 2);

  // near cull
  const float tvx = transform(in.view, 0, mx, my, mz);
  const float tvy = transform(in.view, 1, mx, my, mz);
  const float depth = transform(in.view, 2, mx, my, mz);
  bool near_ok = depth >= kNear;
  if (in.alive != nullptr) near_ok = near_ok && __ldg(in.alive + g) != 0;

  // projection to NDC, then pixels
  const float p_w =
      1.0f / (transform(in.proj, 3, mx, my, mz) + kProjEps);
  const float ndc_x = transform(in.proj, 0, mx, my, mz) * p_w;
  const float ndc_y = transform(in.proj, 1, mx, my, mz) * p_w;
  const float px = ((ndc_x + 1.0f) * s.width - 1.0f) * 0.5f;
  const float py = ((ndc_y + 1.0f) * s.height - 1.0f) * 0.5f;

  // 3D covariance (R S)(R S)^T, packed upper triangle
  const float4 q = __ldg(in.rotations + g);
  const float r00 = 1.0f - 2.0f * (q.y * q.y + q.z * q.z);
  const float r01 = 2.0f * (q.x * q.y - q.w * q.z);
  const float r02 = 2.0f * (q.x * q.z + q.w * q.y);
  const float r10 = 2.0f * (q.x * q.y + q.w * q.z);
  const float r11 = 1.0f - 2.0f * (q.x * q.x + q.z * q.z);
  const float r12 = 2.0f * (q.y * q.z - q.w * q.x);
  const float r20 = 2.0f * (q.x * q.z - q.w * q.y);
  const float r21 = 2.0f * (q.y * q.z + q.w * q.x);
  const float r22 = 1.0f - 2.0f * (q.x * q.x + q.y * q.y);
  const float sx = s.scale_modifier * __ldg(in.scales + i3);
  const float sy = s.scale_modifier * __ldg(in.scales + i3 + 1);
  const float sz = s.scale_modifier * __ldg(in.scales + i3 + 2);
  const float w0 = sx * sx, w1 = sy * sy, w2 = sz * sz;
  const float c00 = (r00 * r00 * w0 + r01 * r01 * w1) + r02 * r02 * w2;
  const float c01 = (r00 * r10 * w0 + r01 * r11 * w1) + r02 * r12 * w2;
  const float c02 = (r00 * r20 * w0 + r01 * r21 * w1) + r02 * r22 * w2;
  const float c11 = (r10 * r10 * w0 + r11 * r11 * w1) + r12 * r12 * w2;
  const float c12 = (r10 * r20 * w0 + r11 * r21 * w1) + r12 * r22 * w2;
  const float c22 = (r20 * r20 * w0 + r21 * r21 * w1) + r22 * r22 * w2;

  // EWA projection onto the screen (math3d.compute_cov2d)
  const float tx = clamp(tvx / depth, -s.lim_x, s.lim_x) * depth;
  const float ty = clamp(tvy / depth, -s.lim_y, s.lim_y) * depth;
  const float inv_tz = 1.0f / depth;
  const float j00 = s.focal_x * inv_tz;
  const float j11 = s.focal_y * inv_tz;
  const float j02 = -(s.focal_x * tx) * inv_tz * inv_tz;
  const float j12 = -(s.focal_y * ty) * inv_tz * inv_tz;
  float t0[3], t1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float w2k = __ldg(in.view + 8 + k);
    t0[k] = j00 * __ldg(in.view + k) + j02 * w2k;
    t1[k] = j11 * __ldg(in.view + 4 + k) + j12 * w2k;
  }
  const float u00 = (c00 * t0[0] + c01 * t0[1]) + c02 * t0[2];
  const float u01 = (c01 * t0[0] + c11 * t0[1]) + c12 * t0[2];
  const float u02 = (c02 * t0[0] + c12 * t0[1]) + c22 * t0[2];
  const float u10 = (c00 * t1[0] + c01 * t1[1]) + c02 * t1[2];
  const float u11 = (c01 * t1[0] + c11 * t1[1]) + c12 * t1[2];
  const float u12 = (c02 * t1[0] + c12 * t1[1]) + c22 * t1[2];
  const float a = ((t0[0] * u00 + t0[1] * u01) + t0[2] * u02) + kBlur;
  const float b = (t0[0] * u10 + t0[1] * u11) + t0[2] * u12;
  const float c = ((t1[0] * u10 + t1[1] * u11) + t1[2] * u12) + kBlur;
  const float det = a * c - b * b;
  const bool det_ok = det != 0.0f;
  const float det_inv = 1.0f / (det_ok ? det : 1.0f);

  // screen-space radius via eigenvalues
  const float mid = 0.5f * (a + c);
  const float root = sqrtf(clamp_min(mid * mid - det, kEigenFloor));
  const float lambda = maximum(mid + root, mid - root);
  const float opacity = __ldg(in.opacities + g);
  float radius = ceilf(3.0f * sqrtf(lambda));
  if (s.tight_radius) {
    const float r_cut2 =
        2.0f * logf(clamp_min(255.0f * opacity, kFloor)) * lambda;
    radius = minimum(radius, ceilf(sqrtf(clamp_min(r_cut2, 0.0f))));
  }

  // tile rect (math3d.get_rect)
  const int4 rect = make_int4(
      clamp_tile(saturating_int32((px - radius) * kTileInv), s.grid_x),
      clamp_tile(saturating_int32((py - radius) * kTileInv), s.grid_y),
      clamp_tile(saturating_int32((px + radius + 16.0f - 1.0f) * kTileInv),
                 s.grid_x),
      clamp_tile(saturating_int32((py + radius + 16.0f - 1.0f) * kTileInv),
                 s.grid_y));
  const int tiles = (rect.w - rect.y) * (rect.z - rect.x);
  const bool visible = near_ok && det_ok && tiles != 0;

  // SH colour, of visible Gaussians only
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  float clamped[3] = {0.0f, 0.0f, 0.0f};
  if (visible) {
    const float dx = mx - __ldg(in.campos);
    const float dy = my - __ldg(in.campos + 1);
    const float dz = mz - __ldg(in.campos + 2);
    const float norm = clamp_min(sqrtf((dx * dx + dz * dz) + dy * dy), kFloor);
    eval_sh<kDegree>(in.shs + 12LL * g, dx / norm, dy / norm, dz / norm,
                     rgb);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float v = rgb[ch] + 0.5f;
      clamped[ch] = v < 0.0f ? 1.0f : 0.0f;
      rgb[ch] = clamp_min(v, 0.0f);
    }
  }

  // masked writes: the plain version's v * mask
  const float vis = visible ? 1.0f : 0.0f;
  const float near = near_ok ? 1.0f : 0.0f;
  out.radii[g] = visible ? saturating_int32(radius) : 0;
  out.xy[g] = make_float2(px * vis, py * vis);
  out.depth[g] = depth * vis;
  float2* cov = out.cov3d + i3;
  cov[0] = make_float2(c00 * near, c01 * near);
  cov[1] = make_float2(c02 * near, c11 * near);
  cov[2] = make_float2(c12 * near, c22 * near);
  out.conic[i3] = c * det_inv * vis;
  out.conic[i3 + 1] = -b * det_inv * vis;
  out.conic[i3 + 2] = a * det_inv * vis;
  out.opacity[g] = opacity * vis;
  out.tiles_touched[g] = visible ? tiles : 0;
  out.rect[g] = visible ? rect : make_int4(0, 0, 0, 0);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    out.rgb[i3 + ch] = rgb[ch];
    out.clamped[i3 + ch] = clamped[ch];
  }
  out.visible[g] = visible;
}

}  // namespace

extern "C" {

// Launches the instance of `sh_degree` (0-3) on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for another degree.  `alive`
// may be null; every other pointer is a contiguous tensor of the shape
// PreprocessOut and preprocess() give it.
int gstpu_preprocess(const float* means, const float* scales,
                     const float* rotations, const float* opacities,
                     const float* shs, const unsigned char* alive,
                     const float* view, const float* proj,
                     const float* campos, int n, int sh_degree,
                     int tight_radius, float width, float height,
                     float focal_x, float focal_y, float lim_x, float lim_y,
                     float scale_modifier, int grid_x, int grid_y, int* radii,
                     float* xy, float* depth, float* cov3d, float* rgb,
                     float* conic, float* opacity, int* tiles_touched,
                     int* rect, float* clamped, unsigned char* visible,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Inputs in{means, scales, reinterpret_cast<const float4*>(rotations),
                  opacities, reinterpret_cast<const float4*>(shs), alive,
                  view, proj, campos};
  const Scalars s{n, grid_x, grid_y, tight_radius, width, height, focal_x,
                  focal_y, lim_x, lim_y, scale_modifier};
  const Outputs out{radii, reinterpret_cast<float2*>(xy), depth,
                    reinterpret_cast<float2*>(cov3d), rgb, conic, opacity,
                    tiles_touched, reinterpret_cast<int4*>(rect), clamped,
                    visible};
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sh_degree) {
    case 0: preprocess_kernel<0><<<blocks, kThreads, 0, st>>>(in, s, out); break;
    case 1: preprocess_kernel<1><<<blocks, kThreads, 0, st>>>(in, s, out); break;
    case 2: preprocess_kernel<2><<<blocks, kThreads, 0, st>>>(in, s, out); break;
    case 3: preprocess_kernel<3><<<blocks, kThreads, 0, st>>>(in, s, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gstpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
