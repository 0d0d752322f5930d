// tile_topk: the k smallest (or largest) f32 values among n with their
// indices, ties to the lower index, in passes over 2048-key tiles (Hopper,
// sm_90a). Shared by event_topk.cu (K2, ascending) and aoi_topk.cu (K3,
// descending).
//
// Every element becomes one 64-bit key: the order-preserving bits of its f32
// value in the high word (complemented for DESC, so larger values get
// smaller keys), its u32 index in the low word. Comparing keys as unsigned
// integers orders by value and then by index, so ties go to the lower index
// with no extra work, and no two keys are ever equal (the result is
// deterministic; no atomics anywhere). One CTA sorts a tile of TILE keys in
// shared memory with an ascending bitonic network and writes its first k.
// The same kernel then runs over the tiles*k candidates until one tile
// remains; that last pass decodes the keys into (value, index). Padding is
// the all-ones key, which sorts after every real key (+inf included when
// ascending), so it never wins. The TPU kernels' k iterative arg-extrema per
// tile are not carried over: a CTA has 1024 threads to spend, so a sort of
// the tile is cheaper than k reductions.
//
// Bound: a call reads n*4 bytes and writes k*12; at n = 16384 that is
// 64 KiB, about 20 ns of HBM time, so it is bound by launch latency (one
// launch per pass, two passes at n = 16384, k <= 1024).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 2048;      // keys per CTA: 16 KiB of shared memory
constexpr int THREADS = 1024;   // one compare-exchange pair per thread
constexpr uint64_t PAD = ~0ull; // sorts after every real key

template <bool DESC>
__device__ __forceinline__ uint64_t pack(float v, uint32_t i) {
  uint32_t b = __float_as_uint(v);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);  // ascending with v
  if (DESC) b = ~b;
  return (static_cast<uint64_t>(b) << 32) | i;
}

template <bool DESC>
__device__ __forceinline__ float unpack_value(uint64_t key) {
  uint32_t b = static_cast<uint32_t>(key >> 32);
  if (DESC) b = ~b;
  b = (b & 0x80000000u) ? (b & 0x7fffffffu) : ~b;
  return __uint_as_float(b);
}

// One pass: CTA b sorts in[b*TILE, min((b+1)*TILE, m)) and keeps its first k.
// FROM_VALUES: the input is the (m,) f32 value vector, else (m,) packed keys.
// DECODE: the last pass (one CTA); writes (value, index) instead of keys.
template <bool DESC, bool FROM_VALUES, bool DECODE>
__global__ void __launch_bounds__(THREADS)
tile_topk(const void* __restrict__ in, int m, int k,
          uint64_t* __restrict__ out_keys, float* __restrict__ out_v,
          int64_t* __restrict__ out_i) {
  __shared__ uint64_t s[TILE];
  const int tid = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * TILE;
  for (int j = tid; j < TILE; j += THREADS) {
    const int64_t g = base + j;
    uint64_t key = PAD;
    if (g < m) {
      if (FROM_VALUES) {
        key = pack<DESC>(static_cast<const float*>(in)[g], static_cast<uint32_t>(g));
      } else {
        key = static_cast<const uint64_t*>(in)[g];
      }
    }
    s[j] = key;
  }
  // bitonic sort, ascending; thread tid owns the pair (a, a + stride)
  for (int size = 2; size <= TILE; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      const int a = 2 * tid - (tid & (stride - 1));
      const int b = a + stride;
      const bool up = (a & size) == 0;
      const uint64_t ka = s[a], kb = s[b];
      if ((ka > kb) == up) {
        s[a] = kb;
        s[b] = ka;
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < k; j += THREADS) {
    const uint64_t key = s[j];
    if (DECODE) {
      out_v[j] = unpack_value<DESC>(key);
      out_i[j] = static_cast<int64_t>(key & 0xffffffffull);
    } else {
      out_keys[static_cast<int64_t>(blockIdx.x) * k + j] = key;
    }
  }
}

inline int tiles_of(int m) { return (m + TILE - 1) / TILE; }

// values: (n,) f32 on the device. scratch_a, scratch_b: room for
// tiles_of(n) * k keys each. out_v: (k,) f32, out_i: (k,) i64. Requires
// 1 <= k <= n and 2 * k <= TILE (the wrappers check). Launches on `stream`
// and does not synchronise; returns the first launch error, or 0.
template <bool DESC>
int tile_topk_launch(const float* values, int n, int k, uint64_t* scratch_a,
                     uint64_t* scratch_b, float* out_v, int64_t* out_i,
                     cudaStream_t stream) {
  int m = n;
  if (tiles_of(m) == 1) {
    tile_topk<DESC, true, true><<<1, THREADS, 0, stream>>>(values, m, k, nullptr,
                                                           out_v, out_i);
    return static_cast<int>(cudaGetLastError());
  }
  tile_topk<DESC, true, false><<<tiles_of(m), THREADS, 0, stream>>>(
      values, m, k, scratch_a, nullptr, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  m = tiles_of(m) * k;
  uint64_t* src = scratch_a;
  uint64_t* dst = scratch_b;
  while (tiles_of(m) > 1) {
    tile_topk<DESC, false, false><<<tiles_of(m), THREADS, 0, stream>>>(
        src, m, k, dst, nullptr, nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    m = tiles_of(m) * k;
    uint64_t* t = src;
    src = dst;
    dst = t;
  }
  tile_topk<DESC, false, true><<<1, THREADS, 0, stream>>>(src, m, k, nullptr,
                                                          out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
