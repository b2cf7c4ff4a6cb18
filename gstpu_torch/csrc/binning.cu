// Tile binning for NVIDIA Hopper (sm_90a): two kernels around one sort.
//
// Replaces no TPU kernel: gstpu/ops/binning.py::build_pairs is jnp and
// lax.sort, and so is the port's plain version,
// gstpu_torch/ops/binning.py::build_pairs.  This file exists because that
// plain version was 68% of a frame of the benchmark's mip360-view cell on
// an H100 (31.4 of 46.2 ms at 2.96M Gaussians and 32.4M pair slots): about 40
// PyTorch passes over every slot, most of them on int64, among them a
// searchsorted of every slot and a (K, 4) int64 gather of the rects.  The
// wrapper that builds and launches it is gstpu_torch/ops/cuda_binning.py.
//
// What it computes: the plain version's Pairs, bit for bit.  Slot
// k = cum[g] - tiles[g] + local holds pair `local` of Gaussian g (row-major
// in its band-local rect); its key is tile << 32 | depth bits, or the
// sentinel num_tiles << 32 | 2^31-1 for a culled slot and for every slot
// past the pair count.  One stable sort of the keys by their low
// 32 + bit_length(num_tiles) bits, with each slot's index carried, gives the
// plain version's order: an LSD radix sort over slot-major input is stable,
// and every key is non-negative (a valid depth is > 0.2 by the near cull,
// so its float bits are).
//
// - duplicate_kernel: a warp per 32 Gaussians.  Each lane loads its
//   Gaussian's prefix sum, rect, depth and cull inputs once; the warp then
//   walks the slots of its 32 Gaussians 32 at a time, each lane finding its
//   slot's Gaussian by a five-step binary search over the lanes' first slots
//   (shuffles), and writes the key, the slot index and the Gaussian of every
//   slot below the capacity.  The launch's last kTailBlocks blocks write the
//   sentinel and the index to the slots from the pair count to the capacity.
//   The exact pair cull is the plain version's test, operation for
//   operation (-fmad=false keeps dx*dx + dy*dy unfused, as PyTorch's
//   separate multiplies and add).
// - cub::DeviceRadixSort::SortPairs over the key bits [0, end_bit), with
//   the 32-bit slot indices carried, ping-ponging between two buffers.
// - finish_kernel: a thread per sorted position i.  For every i it writes
//   gm_pos[slot(i)] = i; below the kept capacity, tile_id and gauss_id (the
//   slot's Gaussian, or N - 1 past the pair count, as the plain version's
//   clamped searchsorted gives) and, at every change of tile between i - 1
//   and i, the tile ranges of the tiles in between (an empty tile starts
//   where the next tile does, as searchsorted's insertion point); with the
//   cull, the thread at the first sentinel writes the kept count.
//   count_kernel then writes tile_count from the ranges.
//
// No slot is written by more than one thread and nothing is accumulated, so
// every output is deterministic; the pair count stays on the card.
//
// What bounds it on this card: bytes.  At mip360-view's sizes (N = 2.96M,
// K = 32.8M slots, 21.7M pairs) the function itself needs the Gaussians'
// inputs read once (0.07 GB), a 12-byte key and index per slot written
// once and read once (0.79 GB) and its outputs written once (0.41 GB):
// about 1.26 GB, 0.38 ms at 3.35 TB/s.  This design moves more: CUB's
// onesweep sort takes six 8-bit radix passes over the 44-bit keys, each
// reading and writing 12 bytes per slot (4.7 GB), and the finish kernel's
// random gather and scatter waste most of each 32-byte sector: about
// 6.2 GB, 1.9 ms.  The design keeps every pass at the size of the
// Gaussians or of the slots, each slot touched by one thread per pass;
// sorts 44 bits and 4-byte values instead of 64-bit keys and 8-byte
// indices (the plain version's torch.sort, eight passes of 16 bytes); and
// leaves one random gather (the Gaussian of each kept position) and one
// random scatter (gm_pos) as the only uncoalesced traffic.

#include <cuda_runtime.h>

#include <climits>
#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kTailBlocks = 1024;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr long long kSentinelDepthBits = 0x7fffffff;

// torch.clamp(v, lo, hi) for finite bounds: a NaN v stays NaN.
__device__ __forceinline__ float clamp_as_torch(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads) duplicate_kernel(
    const long long* __restrict__ cum, const int* __restrict__ tiles,
    const int4* __restrict__ rect, const int* __restrict__ depth_bits,
    const float2* __restrict__ cull_xy, const float* __restrict__ cull_tcut,
    int n, int dup_blocks, int grid_x, int num_tiles, int capacity, int row0,
    int row_stride, unsigned long long* __restrict__ keys,
    unsigned* __restrict__ slots, int* __restrict__ gauss,
    int* __restrict__ gauss_cum) {
  const long long total = cum[n - 1];
  const unsigned long long sentinel =
      (static_cast<unsigned long long>(num_tiles) << 32) |
      static_cast<unsigned long long>(kSentinelDepthBits);

  if (static_cast<int>(blockIdx.x) >= dup_blocks) {
    // the slots past the pair count
    const long long stride =
        static_cast<long long>(gridDim.x - dup_blocks) * kThreads;
    for (long long s = total + static_cast<long long>(blockIdx.x - dup_blocks)
                                   * kThreads + threadIdx.x;
         s < capacity; s += stride) {
      keys[s] = sentinel;
      slots[s] = static_cast<unsigned>(s);
    }
    return;
  }

  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const bool real = g < n;
  // lanes past N own no slot: first slot = end = the pair count
  const long long end = real ? cum[g] : total;
  const long long start = end - (real ? tiles[g] : 0);
  int4 r = make_int4(0, 0, 1, 0);
  int bits = 0;
  float2 c = make_float2(0.0f, 0.0f);
  float tcut = 0.0f;
  if (real) {
    gauss_cum[g] = static_cast<int>(end);
    r = rect[g];
    bits = depth_bits[g];
    if (cull_xy != nullptr) {
      c = cull_xy[g];
      tcut = cull_tcut[g];
    }
  }
  const int width = max(r.z - r.x, 1);

  const long long warp_start = __shfl_sync(kFullMask, start, 0);
  const long long warp_end =
      min(__shfl_sync(kFullMask, end, 31), static_cast<long long>(capacity));
  // offsets from the warp's first slot; every slot walked lies below
  // capacity - warp_start < 2^31, so a larger offset can be cut to INT_MAX
  const int first = static_cast<int>(
      min(start - warp_start, static_cast<long long>(INT_MAX)));
  const int g0 = g - lane;

  for (long long base = warp_start; base < warp_end; base += 32) {
    const long long s = base + lane;
    const int off = static_cast<int>(s - warp_start);
    // the last lane whose first slot is at or before s: its Gaussian owns s
    // (lanes with no slots share the next lane's first slot)
    int o = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      if (__shfl_sync(kFullMask, first, o + step) <= off) o += step;
    }
    const int local = off - __shfl_sync(kFullMask, first, o);
    const int rx = __shfl_sync(kFullMask, r.x, o);
    const int ry = __shfl_sync(kFullMask, r.y, o);
    const int w = __shfl_sync(kFullMask, width, o);
    const int b = __shfl_sync(kFullMask, bits, o);
    const float cx = __shfl_sync(kFullMask, c.x, o);
    const float cy = __shfl_sync(kFullMask, c.y, o);
    const float cut = __shfl_sync(kFullMask, tcut, o);
    if (s >= warp_end) continue;

    const long long tx = rx + local % w;
    const long long ty = ry + local / w;  // band-local tile row
    const long long tile = ty * grid_x + tx;
    bool valid = true;
    if (cull_xy != nullptr) {
      // the tile's pixel-center rect (pixel coordinates are integers)
      const float x0 = static_cast<float>(tx * 16);
      const float y0 = static_cast<float>((ty * row_stride + row0) * 16);
      const float dx = clamp_as_torch(cx, x0, x0 + 15.0f) - cx;
      const float dy = clamp_as_torch(cy, y0, y0 + 15.0f) - cy;
      valid = dx * dx + dy * dy <= cut;
    }
    keys[s] = valid ? static_cast<unsigned long long>(
                          (tile << 32) | static_cast<long long>(b))
                    : sentinel;
    slots[s] = static_cast<unsigned>(s);
    gauss[s] = g0 + o;
  }
}

__device__ __forceinline__ long long key_tile(unsigned long long key) {
  return static_cast<long long>(key >> 32);
}

__global__ void __launch_bounds__(kThreads) finish_kernel(
    const unsigned long long* __restrict__ keys,
    const unsigned* __restrict__ slots, const int* __restrict__ gauss,
    const long long* __restrict__ cum, int n, int capacity, int kept_capacity,
    int num_tiles, int count_kept, int* __restrict__ gm_pos,
    int* __restrict__ tile_id, int* __restrict__ gauss_id,
    int* __restrict__ bounds, int* __restrict__ num_pairs,
    int* __restrict__ num_kept) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= capacity) return;
  const long long total = cum[n - 1];
  if (i == 0) {
    *num_pairs = static_cast<int>(total);
    if (!count_kept) *num_kept = static_cast<int>(total);
  }
  const unsigned slot = slots[i];
  gm_pos[slot] = i;
  if (i >= kept_capacity && !count_kept) return;

  const long long tile = key_tile(keys[i]);
  const long long prev = i == 0 ? -1 : key_tile(keys[i - 1]);
  if (i < kept_capacity) {
    tile_id[i] = static_cast<int>(tile);
    gauss_id[i] = slot < total ? gauss[slot] : n - 1;
    // bounds[t] = the first position whose tile is >= t
    for (long long t = max(prev + 1, 0LL); t <= min(tile, 1LL * num_tiles);
         ++t)
      bounds[t] = i;
    if (i == kept_capacity - 1) {
      for (long long t = max(tile + 1, 0LL); t <= num_tiles; ++t)
        bounds[t] = kept_capacity;
    }
  }
  if (count_kept) {
    // kept = the position of the first sentinel (culled or past the count)
    if (tile >= num_tiles && (i == 0 || prev < num_tiles)) *num_kept = i;
    if (i == capacity - 1 && tile < num_tiles) *num_kept = capacity;
  }
}

__global__ void count_kernel(const int* __restrict__ bounds, int num_tiles,
                             int* __restrict__ tile_count) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < num_tiles) tile_count[t] = bounds[t + 1] - bounds[t];
}

int blocks_of(long long items) {
  return static_cast<int>((items + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Writes every slot's key, index and Gaussian (and gauss_cum, the int32
// prefix sum) on `stream`; returns cudaGetLastError().  cull_xy and
// cull_tcut are both null (no cull) or both given.
int gstpu_binning_duplicate(const long long* cum, const int* tiles,
                            const int* rect, const int* depth,
                            const float* cull_xy, const float* cull_tcut,
                            int n, int grid_x, int num_tiles, int capacity,
                            int row0, int row_stride, unsigned long long* keys,
                            unsigned* slots, int* gauss, int* gauss_cum,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dup_blocks = blocks_of(n);
  duplicate_kernel<<<dup_blocks + kTailBlocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      cum, tiles, reinterpret_cast<const int4*>(rect), depth,
      reinterpret_cast<const float2*>(cull_xy), cull_tcut, n, dup_blocks,
      grid_x, num_tiles, capacity, row0, row_stride, keys, slots, gauss,
      gauss_cum);
  return static_cast<int>(cudaGetLastError());
}

// The scratch bytes gstpu_binning_sort needs for `capacity` keys sorted by
// bits [0, end_bit).
int gstpu_binning_sort_bytes(int capacity, int end_bit, size_t* bytes,
                             int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cub::DoubleBuffer<unsigned long long> keys(nullptr, nullptr);
  cub::DoubleBuffer<unsigned> slots(nullptr, nullptr);
  *bytes = 0;
  return static_cast<int>(cub::DeviceRadixSort::SortPairs(
      nullptr, *bytes, keys, slots, capacity, 0, end_bit));
}

// Stable sort of `capacity` keys by bits [0, end_bit), the slot indices
// carried, between the buffers (keys, slots) and (keys_alt, slots_alt);
// writes to *selector which of the two (0 or 1) holds the result.
int gstpu_binning_sort(unsigned long long* keys, unsigned long long* keys_alt,
                       unsigned* slots, unsigned* slots_alt, void* temp,
                       size_t temp_bytes, int capacity, int end_bit,
                       int* selector, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cub::DoubleBuffer<unsigned long long> k(keys, keys_alt);
  cub::DoubleBuffer<unsigned> v(slots, slots_alt);
  err = cub::DeviceRadixSort::SortPairs(temp, temp_bytes, k, v, capacity, 0,
                                        end_bit,
                                        static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  *selector = k.selector;
  return static_cast<int>(cudaGetLastError());
}

// From the sorted keys and slot indices: gm_pos (capacity), tile_id and
// gauss_id (kept_capacity), bounds (num_tiles + 1: tile starts and the
// end), tile_count (num_tiles), num_pairs and num_kept (one int each; with
// count_kept the non-sentinel keys, else the pair count).
int gstpu_binning_finish(const unsigned long long* keys, const unsigned* slots,
                         const int* gauss, const long long* cum, int n,
                         int capacity, int kept_capacity, int num_tiles,
                         int count_kept, int* gm_pos, int* tile_id,
                         int* gauss_id, int* bounds, int* tile_count,
                         int* num_pairs, int* num_kept, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kept_capacity == 0) {
    err = cudaMemsetAsync(bounds, 0, sizeof(int) * (num_tiles + 1), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  finish_kernel<<<blocks_of(capacity), kThreads, 0, s>>>(
      keys, slots, gauss, cum, n, capacity, kept_capacity, num_tiles,
      count_kept, gm_pos, tile_id, gauss_id, bounds, num_pairs, num_kept);
  if (num_tiles > 0)
    count_kernel<<<blocks_of(num_tiles), kThreads, 0, s>>>(bounds, num_tiles,
                                                           tile_count);
  return static_cast<int>(cudaGetLastError());
}

const char* gstpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
