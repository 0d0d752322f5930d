// event_topk: the k earliest pending completion times among n (Hopper, sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/event_topk.py::tile_next_k
// (_next_k_kernel) together with its phase 2 in src/repro/kernels/ops.py::
// event_next_k. Same function: (times (k,), idx (k,)) of the k smallest
// times, ties to the lower index, idle clients carrying +inf.
//
// Design. Every element becomes one 64-bit key: the order-preserving bits of
// its f32 time in the high word, its u32 index in the low word. Comparing
// keys as unsigned integers orders by time and then by index, so ties go to
// the lower index with no extra work, and no two keys are ever equal (the
// result is deterministic; no atomics anywhere). One CTA sorts a tile of
// TILE keys in shared memory with a bitonic network and writes its first k.
// The same kernel then runs over the tiles*k candidates until one tile
// remains; that last pass decodes the keys into (time, index). The TPU
// kernel's k iterative argmaxes per tile are not carried over: a CTA has
// 1024 threads to spend, so a sort of the tile is cheaper than k reductions.
//
// Bound. The function reads n*4 bytes and writes k*12 bytes; at the main
// path's n = 16384 that is 64 KiB, about 20 ns of HBM time, so the kernel is
// bound by launch latency (one launch per pass, two passes at n = 16384,
// k <= 1024). A later single-pass radix select in one CTA would remove the
// second launch; this version is the simple one that is right.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 2048;      // keys per CTA: 16 KiB of shared memory
constexpr int THREADS = 1024;   // one compare-exchange pair per thread
constexpr uint64_t PAD = ~0ull; // sorts after every real key, +inf included

__device__ __forceinline__ uint64_t pack(float t, uint32_t i) {
  uint32_t b = __float_as_uint(t);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<uint64_t>(b) << 32) | i;
}

__device__ __forceinline__ float unpack_time(uint64_t key) {
  uint32_t b = static_cast<uint32_t>(key >> 32);
  b = (b & 0x80000000u) ? (b & 0x7fffffffu) : ~b;
  return __uint_as_float(b);
}

// One pass: CTA b sorts in[b*TILE, min((b+1)*TILE, m)) and keeps its first k.
// FROM_TIMES: the input is the (m,) f32 time vector, else (m,) packed keys.
// DECODE: the last pass (one CTA); writes (time, index) instead of keys.
template <bool FROM_TIMES, bool DECODE>
__global__ void __launch_bounds__(THREADS)
tile_topk(const void* __restrict__ in, int m, int k,
          uint64_t* __restrict__ out_keys, float* __restrict__ out_t,
          int64_t* __restrict__ out_i) {
  __shared__ uint64_t s[TILE];
  const int tid = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * TILE;
  for (int j = tid; j < TILE; j += THREADS) {
    const int64_t g = base + j;
    uint64_t key = PAD;
    if (g < m) {
      if (FROM_TIMES) {
        key = pack(static_cast<const float*>(in)[g], static_cast<uint32_t>(g));
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
      out_t[j] = unpack_time(key);
      out_i[j] = static_cast<int64_t>(key & 0xffffffffull);
    } else {
      out_keys[static_cast<int64_t>(blockIdx.x) * k + j] = key;
    }
  }
}

inline int tiles_of(int m) { return (m + TILE - 1) / TILE; }

}  // namespace

extern "C" {

int event_topk_tile() { return TILE; }

// times: (n,) f32 on the device. scratch_a, scratch_b: room for
// tiles_of(n) * k keys each. out_t: (k,) f32, out_i: (k,) i64. Requires
// 1 <= k <= n and 2 * k <= TILE (the wrapper checks). Launches on `stream`
// and does not synchronise; returns the first launch error, or 0.
int event_topk_launch(const float* times, int n, int k, uint64_t* scratch_a,
                      uint64_t* scratch_b, float* out_t, int64_t* out_i,
                      cudaStream_t stream) {
  int m = n;
  if (tiles_of(m) == 1) {
    tile_topk<true, true><<<1, THREADS, 0, stream>>>(times, m, k, nullptr,
                                                     out_t, out_i);
    return static_cast<int>(cudaGetLastError());
  }
  tile_topk<true, false><<<tiles_of(m), THREADS, 0, stream>>>(
      times, m, k, scratch_a, nullptr, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  m = tiles_of(m) * k;
  uint64_t* src = scratch_a;
  uint64_t* dst = scratch_b;
  while (tiles_of(m) > 1) {
    tile_topk<false, false><<<tiles_of(m), THREADS, 0, stream>>>(
        src, m, k, dst, nullptr, nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    m = tiles_of(m) * k;
    uint64_t* t = src;
    src = dst;
    dst = t;
  }
  tile_topk<false, true><<<1, THREADS, 0, stream>>>(src, m, k, nullptr, out_t,
                                                    out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
