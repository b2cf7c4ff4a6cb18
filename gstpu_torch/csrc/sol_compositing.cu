// The compositing arithmetic alone, on one resident block, for the
// speed-of-light model of NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/sol_model.py::sol_compositing.kernel.  The
// plain PyTorch version of the same function is
// gstpu_torch/sol_model.py::sol_compositing_plain; the wrapper that builds
// and launches this file is gstpu_torch/sol_model.py::sol_compositing.
//
// What it computes.  Every tile reads the same (16, 128) f32 feature block,
// one column per lane (pair): x, y, conic a/b/c, opacity and four
// colour-like rows 6-9 (rows 10-15 are read by nobody).  Pixel p of the 256
// sits at (p / 16, p / 32).  For n_chunks chunks c, with every feature
// multiplied by s = (1 + c * 1e-7) in float32 (the loop-counter tie of the
// JAX code, which keeps the body in the loop), the pixel walks the 128 lanes:
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
// The JAX code takes t_ex = p_incl / (1 - alpha); this kernel takes the
// same quantity from the exclusive product, t_ex = T * prod_{k < lane}
// (1 - alpha_k), as K1 and K2 take T (kExclusiveT).  Kept and the carry
// still come from p_incl, so only t_ex's rounding moves: on the sol model's
// block the forward stays within 6e-8 of a kernel that divides.
//
// What bounds it on this card: the issue rate.  A launch at the sol model's
// volumes walks tiles x 256 x 128 x n_chunks (pixel, lane) steps; its bytes
// (one 8 KB block in, 2 floats per pixel or lane per tile out) take
// microseconds.  Under the shared flags (-fmad=false, no fast math, expf,
// IEEE reciprocal) no multiply fuses with an add, so every counted
// operation of a step is one instruction (expf is 8), and an SM
// sub-partition issues one warp instruction per clock.  The bound
// (sol_model.k3_bound) divides the operations by 67 TFLOP/s, a rate that
// counts an FMA as two operations: a kernel that issued nothing but the
// counted operations would reach 50% of it.  So the design cuts the
// instructions per step that are not the step's own arithmetic.
//
// Design.
// - Lane work once per chunk.  The block is copied to shared memory once per
//   CTA.  At the start of each chunk of each tile the CTA scales it by s
//   into one 16-byte aligned record per lane (x y a b | c op f6 f6+f7+f8+f9
//   | f7 f8 f9 0), so a step reads its lane with two broadcast 16-byte
//   loads, not 7-10 scalar loads of the rows and as many multiplies per
//   pixel.  The products are the same floats.
// - kFwdPixPerThread pixels per thread in the forward (pixels
//   kFwdPixPerThread t + k): each lane's loads serve them all, and their
//   transmittance chains are independent, which gives the scheduler work
//   between dependent instructions.  The backward keeps one pixel a thread
//   (kBwdPixPerThread): its IEEE reciprocal compiles to a range check and a
//   branch to a slow path, which splits the step into basic blocks that
//   nvcc does not interleave, so there more warps hide latency better than
//   more pixels a thread.  (An IEEE division of t_ex does the same to the
//   forward: with it, 4 pixels a thread ran slower than 1.)  A CTA of
//   256 / pixels-per-thread threads holds one tile.
// - Backward sums over pixels without a shuffle tree per lane: each thread
//   first adds its pixels' two values in order; after a batch of kLaneBatch
//   lanes the warp reduces the 2 kLaneBatch values of each thread by a
//   transposed butterfly (at each of the five levels every thread sends half
//   of its values and keeps the other half, so the batch takes about one
//   shuffle per value instead of five), which leaves each value summed over
//   the warp's 32 threads in the order of a shuffle tree (distance 16 first);
//   then the warps' partials go through shared memory and are added in warp
//   order after the chunk.  No float atomics: every tile computes the same
//   bits, and two runs give identical bits.
// - One CTA per tile (kPersistent false), or a grid of as many CTAs as the
//   card holds at once striding over the tiles (kPersistent true).  Every
//   tile is walked in full: nothing is shared between tiles but the block.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, K3): ptxas
// gives the forward 94 registers and 11,264 B of shared memory (20 CTAs of
// one warp per SM, so the 2,500 tiles run in one wave), the backward 48
// registers and 19,456 B (5 CTAs of 8 warps per SM), no spills;
// cuobjdump counts 34.4 instructions per step in the forward's inner loop
// and 104.4 in the backward's (a thread a pixel that reads the rows and
// divides: 65 and 160).
// scripts/torch_kernel_variants.py builds this file with one of the design
// constants below changed at a time and times each variant.
//
// Numerics: no fast math, -fmad=false, expf, IEEE reciprocal.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kChunk = 128;  // lanes (pairs) per chunk
constexpr int kPix = 256;    // pixels per tile
constexpr int kLaneRows = 10;  // feature rows that the walk reads
constexpr unsigned kFull = 0xffffffffu;

// Design constants.
constexpr int kFwdPixPerThread = 8;  // forward: pixels per thread, 1/2/4/8
constexpr int kBwdPixPerThread = 1;  // backward: pixels per thread, 1/2/4/8
constexpr int kLaneBatch = 8;        // backward: lanes per butterfly, <= 16
constexpr bool kHoistLanes = true;   // lane records once per chunk
constexpr bool kExclusiveT = true;   // t_ex = T * (product before the lane)
constexpr bool kPersistent = false;  // a grid of resident CTAs over the tiles

// The CTA of one form.
template <bool kBackward>
struct Shape {
  static constexpr int kPixPerThread =
      kBackward ? kBwdPixPerThread : kFwdPixPerThread;
  static constexpr int kThreads = kPix / kPixPerThread;
  static constexpr int kWarps = kThreads / 32;
  static_assert(kThreads % 32 == 0 && kThreads * kPixPerThread == kPix,
                "pixels per thread must be 1, 2, 4 or 8");
};
constexpr int kValues = 2 * kLaneBatch;  // a thread's values per butterfly
static_assert(kChunk % kLaneBatch == 0 && kValues <= 32 &&
                  (kValues & (kValues - 1)) == 0,
              "kLaneBatch must be a power of two, at most 16");

// The float32 roundings of the double constants of the JAX code.
constexpr float kAlphaMin = static_cast<float>(1.0 / 255.0);
constexpr float kAlphaMax = static_cast<float>(0.99);
constexpr float kTEps = static_cast<float>(1e-4);
constexpr float kTie = static_cast<float>(1e-7);

// One lane's scaled features, as a step reads them.
struct LaneRecord {
  float4 q0;  // x, y, conic a, conic b
  float4 q1;  // conic c, opacity, row 6, rows 6+7+8+9
  float4 q2;  // rows 7, 8, 9, 0 (only the forward's dead accumulators)
};

struct Lane {
  float x, y, ca, cb, cc, op, f6, f7, f8, f9, fsum;
};

__device__ __forceinline__ Lane read_lane(const LaneRecord* rec,
                                          const float (*blk)[kChunk], int j,
                                          float s) {
  Lane l;
  if constexpr (kHoistLanes) {
    const float4 q0 = rec[j].q0;
    const float4 q1 = rec[j].q1;
    const float4 q2 = rec[j].q2;
    l = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q2.x, q2.y, q2.z, q1.w};
  } else {
    l.x = blk[0][j] * s;
    l.y = blk[1][j] * s;
    l.ca = blk[2][j] * s;
    l.cb = blk[3][j] * s;
    l.cc = blk[4][j] * s;
    l.op = blk[5][j] * s;
    l.f6 = blk[6][j] * s;
    l.f7 = blk[7][j] * s;
    l.f8 = blk[8][j] * s;
    l.f9 = blk[9][j] * s;
    l.fsum = l.f6 + l.f7 + l.f8 + l.f9;
  }
  return l;
}

// One (pixel, lane) step up to w, in the JAX code's order of operations.
struct Step {
  float dx, dy, g, alpha, one_m, p_incl, t_ex, w;
  bool kept;
};

__device__ __forceinline__ Step step(const Lane& l, float pix_x, float pix_y,
                                     float trans, float& prod,
                                     float& p_last) {
  Step o;
  o.dx = l.x - pix_x;
  o.dy = l.y - pix_y;
  const float power =
      -0.5f * (l.ca * o.dx * o.dx + l.cc * o.dy * o.dy) - l.cb * o.dx * o.dy;
  o.g = expf(fminf(power, 0.0f));
  float alpha = fminf(kAlphaMax, l.op * o.g);
  o.alpha = alpha >= kAlphaMin ? alpha : 0.0f;
  o.one_m = 1.0f - o.alpha;
  const float before = prod;
  prod = prod * o.one_m;
  o.p_incl = trans * prod;
  o.t_ex = kExclusiveT ? trans * before : o.p_incl / o.one_m;
  o.kept = o.p_incl >= kTEps;
  o.w = o.kept ? o.alpha * o.t_ex : 0.0f;
  if (o.kept) p_last = fminf(p_last, o.p_incl);
  return o;
}

// The transposed butterfly: the thread's kN values v[0..kN) are summed over
// the warp, level by level from distance kOff down to 1; at a level with
// more than one value left, the threads with the level's bit set keep the
// upper half of their values and send the lower, the others the reverse.
// Afterwards v[0] of lane t holds the warp's sum of value t >> (5 - log2 kN)
// (any kN <= 32: the levels past log2 kN sum the last value whole).
template <int kN, int kOff>
__device__ __forceinline__ void butterfly(float* v, int lane) {
  if constexpr (kOff > 0) {
    if constexpr (kN > 1) {
      constexpr int h = kN / 2;
      const bool upper = (lane & kOff) != 0;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float send = upper ? v[i] : v[i + h];
        const float keep = upper ? v[i + h] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, kOff);
      }
      butterfly<h, kOff / 2>(v, lane);
    } else {
      v[0] = v[0] + __shfl_xor_sync(kFull, v[0], kOff);
      butterfly<1, kOff / 2>(v, lane);
    }
  }
}

template <bool kBackward>
__global__ void __launch_bounds__(Shape<kBackward>::kThreads)
sol_compositing_kernel(const float* __restrict__ feat, int tiles,
                       int n_chunks, float* __restrict__ out) {
  constexpr int kPixPerThread = Shape<kBackward>::kPixPerThread;
  constexpr int kThreads = Shape<kBackward>::kThreads;
  constexpr int kWarps = Shape<kBackward>::kWarps;
  __shared__ float blk[kLaneRows][kChunk];                  // 5,120 B
  __shared__ LaneRecord rec[kChunk];                        // 6,144 B
  __shared__ float part[kBackward ? kWarps : 1][2][kChunk];  // backward

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  for (int i = t; i < kLaneRows * kChunk; i += kThreads) {
    blk[i / kChunk][i % kChunk] = feat[i];
  }

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float pix_x[kPixPerThread], pix_y[kPixPerThread], trans[kPixPerThread];
    float acc0[kPixPerThread], acc1[kPixPerThread], acc2[kPixPerThread],
        acc3[kPixPerThread];              // forward
    float prefix_u[kPixPerThread];        // backward
    float lane_acc[kPixPerThread];  // backward: (field, lane) t + i kThreads
#pragma unroll
    for (int k = 0; k < kPixPerThread; ++k) {
      pix_x[k] = static_cast<float>(t * kPixPerThread + k) * 0.0625f;
      pix_y[k] = pix_x[k] * 0.5f;
      trans[k] = 1.0f;
      acc0[k] = acc1[k] = acc2[k] = acc3[k] = 0.0f;
      prefix_u[k] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kPixPerThread; ++i) lane_acc[i] = 0.0f;

    for (int c = 0; c < n_chunks; ++c) {
      const float s = 1.0f + static_cast<float>(c) * kTie;
      __syncthreads();  // the block is in; the last chunk's reads are done
      if constexpr (kHoistLanes) {
        for (int j = t; j < kChunk; j += kThreads) {
          float v[kLaneRows];
#pragma unroll
          for (int r = 0; r < kLaneRows; ++r) v[r] = blk[r][j] * s;
          rec[j].q0 = make_float4(v[0], v[1], v[2], v[3]);
          rec[j].q1 = make_float4(v[4], v[5], v[6], v[6] + v[7] + v[8] + v[9]);
          rec[j].q2 = make_float4(v[7], v[8], v[9], 0.0f);
        }
      }
      __syncthreads();

      float prod[kPixPerThread], p_last[kPixPerThread], cum_u[kPixPerThread];
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        prod[k] = 1.0f;
        p_last[k] = INFINITY;
        cum_u[k] = 0.0f;
      }
      if constexpr (!kBackward) {
#pragma unroll 2
        for (int j = 0; j < kChunk; ++j) {  // every thread walks every lane
          const Lane l = read_lane(rec, blk, j, s);
#pragma unroll
          for (int k = 0; k < kPixPerThread; ++k) {
            const Step o =
                step(l, pix_x[k], pix_y[k], trans[k], prod[k], p_last[k]);
            acc0[k] = acc0[k] + o.w * l.f6;
            acc1[k] = acc1[k] + o.w * l.f7;
            acc2[k] = acc2[k] + o.w * l.f8;
            acc3[k] = acc3[k] + o.w * l.f9;
          }
        }
      } else {
#pragma unroll 1
        for (int jb = 0; jb < kChunk; jb += kLaneBatch) {
          // v[jj]: the thread's sum of row 0 over its pixels for lane
          // jb + jj; v[kLaneBatch + jj]: that of row 1
          float v[kValues];
#pragma unroll
          for (int jj = 0; jj < kLaneBatch; ++jj) {
            const Lane l = read_lane(rec, blk, jb + jj, s);
#pragma unroll
            for (int k = 0; k < kPixPerThread; ++k) {
              const Step o =
                  step(l, pix_x[k], pix_y[k], trans[k], prod[k], p_last[k]);
              const float cdot = l.fsum * o.w;
              const float u = o.w * cdot;
              cum_u[k] = cum_u[k] + u;
              const float inv_one_m = 1.0f / o.one_m;
              const float dl_da =
                  o.kept ? cdot * o.t_ex -
                               (prefix_u[k] + cum_u[k]) * inv_one_m -
                               inv_one_m * 0.25f
                         : 0.0f;
              const float dl_dg = l.op * dl_da;
              const float gdx = o.g * o.dx;
              const float gdy = o.g * o.dy;
              float r = dl_dg * (-gdx * l.ca - gdy * l.cb);
              r = r + dl_dg * (-gdy * l.cc - gdx * l.cb);
              r = r + -0.5f * gdx * o.dx * dl_dg;
              r = r + -0.5f * gdx * o.dy * dl_dg;
              r = r + -0.5f * gdy * o.dy * dl_dg;
              r = r + (o.kept ? o.g : 0.0f) * dl_da;
              float r2 = o.w * pix_x[k];
              r2 = r2 + o.w * pix_y[k];
              r2 = r2 + o.w * (pix_x[k] + 1.0f);
              r2 = r2 + o.w * cdot;
              if (k == 0) {
                v[jj] = r;
                v[kLaneBatch + jj] = r2;
              } else {
                v[jj] = v[jj] + r;
                v[kLaneBatch + jj] = v[kLaneBatch + jj] + r2;
              }
            }
          }
          butterfly<kValues, 16>(v, lane);
          constexpr int kSpread = 32 / kValues;  // lanes holding each sum
          if (lane % kSpread == 0) {
            const int idx = lane / kSpread;
            part[warp][idx / kLaneBatch][jb + idx % kLaneBatch] = v[0];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        trans[k] = isfinite(p_last[k]) ? p_last[k] : trans[k];
        prefix_u[k] = prefix_u[k] + cum_u[k];
      }
      if constexpr (kBackward) {
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kPixPerThread; ++i) {
          const int f = (t + i * kThreads) / kChunk;  // field f of lane j
          const int j = (t + i * kThreads) % kChunk;
          float sum = part[0][f][j];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) sum += part[w][f][j];
          lane_acc[i] = lane_acc[i] + sum;
        }
      }
    }

    if constexpr (!kBackward) {
      float* o = out + static_cast<size_t>(tile) * 2 * kPix;
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        o[t * kPixPerThread + k] = acc0[k];
        o[kPix + t * kPixPerThread + k] = trans[k];
      }
    } else {
      float* o = out + static_cast<size_t>(tile) * 2 * kChunk;
#pragma unroll
      for (int i = 0; i < kPixPerThread; ++i) o[t + i * kThreads] = lane_acc[i];
    }
  }
}

// CTAs that a launch over `tiles` tiles starts: one per tile, or (with
// kPersistent) as many as the card holds at once, at most one per tile.
template <bool kBackward>
cudaError_t grid_size(int tiles, int device, int* grid) {
  *grid = tiles;
  if (!kPersistent || tiles == 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sol_compositing_kernel<kBackward>, Shape<kBackward>::kThreads,
      0);
  if (err != cudaSuccess) return err;
  *grid = sms * per_sm < tiles ? sms * per_sm : tiles;
  return cudaSuccess;
}

template <bool kBackward>
cudaError_t launch(const float* feat, int tiles, int n_chunks, float* out,
                   int device, cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = grid_size<kBackward>(tiles, device, &grid);
  if (err != cudaSuccess || grid == 0) return err;
  sol_compositing_kernel<kBackward><<<grid, Shape<kBackward>::kThreads, 0,
                                      stream>>>(feat, tiles, n_chunks, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K3 on `stream` and returns the CUDA error code (0 on success).
// `feat` is the (16, 128) block; `out` is (tiles, 2, 256) forward or
// (tiles, 2, 128) backward.
int gstpu_sol_compositing(const float* feat, int tiles, int n_chunks,
                          int backward, float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = backward ? launch<true>(feat, tiles, n_chunks, out, device, s)
                 : launch<false>(feat, tiles, n_chunks, out, device, s);
  return static_cast<int>(err);
}

const char* gstpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
