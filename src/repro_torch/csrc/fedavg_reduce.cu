// fedavg_reduce: the weighted cohort sum out[n] = sum_c w[c] * P[c, n] of
// every leaf of a parameter tree, in one launch (Hopper, sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fedavg_reduce.py::fedavg_reduce
// (_fedavg_kernel). Same function, leaf by leaf: a (C, N_i) f32 stack of
// flattened cohort params contracted against the shared (C,) f32 weights,
// accumulated in f32. Every slot counts, weight 0 included, as in the
// Pallas dot: a padded slot adds exactly 0 and a NaN in any slot propagates.
//
// Design. The TPU kernel streams (C, 16384) tiles through VMEM and contracts
// each on the MXU, one call per leaf. Here one launch covers up to
// MAX_LEAVES leaves: the leaf table (pointers, N_i, a 16-byte-vector flag
// and the prefix sums of the leaves' block counts) is a kernel argument, so
// the launch needs no copy to the device and no sync. Each CTA finds its
// leaf in the prefix table; each thread owns consecutive columns of that
// leaf: four of them with 16-byte loads when the leaf's flag is set (N a
// multiple of 4, both pointers 16-byte aligned), else one with scalar
// loads. It walks c = 0..C-1 in order with an f32 FMA, so every output is a
// fixed-order sum: launches are bitwise repeatable (no split over C, no
// atomics), and a leaf's outputs do not depend on the other leaves of its
// launch. The weights are staged in shared memory, CHUNK at a time, so any
// C works.
//
// Bound. A leaf reads C*N*4 + C*4 bytes and writes N*4, and does 2*C*N
// flops: at 0.5 flop per byte it is bound by memory, (C*N + C + N)*4 bytes
// over 3.35 TB/s. At the sync main path's largest leaf (C = 30, N = 1 605 632)
// that is 199 MB, about 59 us. Consecutive threads read consecutive 16-byte
// words of a row, so each row read is coalesced; there is no reuse to keep
// on chip beyond the weights. The seven small leaves of the paper CNN are
// launch cost, not bytes: one launch for the tree pays it once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 1024;  // weights staged per pass over c: 4 KiB
constexpr int MAX_LEAVES = 16;

struct LeafTable {
  const float* P[MAX_LEAVES];
  float* out[MAX_LEAVES];
  long long N[MAX_LEAVES];
  int vec[MAX_LEAVES];        // 1: four columns a thread, 16-byte loads
  int block_end[MAX_LEAVES];  // inclusive prefix sums of the leaves' block counts
};

template <bool VEC>
__device__ __forceinline__ void reduce_columns(const float* __restrict__ P,
                                               const float* __restrict__ sw_global,
                                               float* sw, int C, int64_t N, int64_t block,
                                               float* __restrict__ out) {
  constexpr int COLS = VEC ? 4 : 1;
  const int64_t col = (block * THREADS + threadIdx.x) * COLS;
  const bool live = col < N;
  float acc[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) acc[j] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += CHUNK) {
    const int cn = min(CHUNK, C - c0);
    __syncthreads();  // the previous chunk's weights are no longer read
    for (int j = threadIdx.x; j < cn; j += THREADS) sw[j] = sw_global[c0 + j];
    __syncthreads();
    if (live) {
      const float* row = P + static_cast<int64_t>(c0) * N + col;
#pragma unroll 4
      for (int c = 0; c < cn; ++c, row += N) {
        const float wc = sw[c];
        if constexpr (VEC) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(row));
          acc[0] = fmaf(wc, v.x, acc[0]);
          acc[1] = fmaf(wc, v.y, acc[1]);
          acc[2] = fmaf(wc, v.z, acc[2]);
          acc[3] = fmaf(wc, v.w, acc[3]);
        } else {
          acc[0] = fmaf(wc, __ldg(row), acc[0]);
        }
      }
    }
  }
  if (!live) return;
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(out + col) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    out[col] = acc[0];
  }
}

__global__ void __launch_bounds__(THREADS)
fedavg_reduce_kernel(const __grid_constant__ LeafTable tab, const float* __restrict__ w, int C) {
  __shared__ float sw[CHUNK];
  const int bx = static_cast<int>(blockIdx.x);
  int leaf = 0;
  while (bx >= tab.block_end[leaf]) ++leaf;  // uniform over the block
  const int64_t block = bx - (leaf ? tab.block_end[leaf - 1] : 0);
  if (tab.vec[leaf]) {
    reduce_columns<true>(tab.P[leaf], w, sw, C, tab.N[leaf], block, tab.out[leaf]);
  } else {
    reduce_columns<false>(tab.P[leaf], w, sw, C, tab.N[leaf], block, tab.out[leaf]);
  }
}

}  // namespace

extern "C" {

// One launch for n <= MAX_LEAVES leaves on `stream`; returns
// cudaGetLastError() (0 on success). Leaf i: P[i] (C*N[i] floats,
// row-major), out[i] (N[i] floats, allocated by the caller), vec[i] (1 when
// N[i] is a multiple of 4 and P[i], out[i] are 16-byte aligned),
// block_end[i] = the sum of the block counts of leaves 0..i, a leaf taking
// ceil(N / (256 * (vec ? 4 : 1))) blocks; leaves with N = 0 take none. The
// caller keeps every buffer alive until the stream reaches the kernel.
int fedavg_reduce_group_launch(const float* const* P, float* const* out, const long long* N,
                               const int* vec, const int* block_end, int n, const float* w,
                               int C, cudaStream_t stream) {
  if (n < 1 || n > MAX_LEAVES) return static_cast<int>(cudaErrorInvalidValue);
  LeafTable tab;
  for (int i = 0; i < MAX_LEAVES; ++i) {
    const int j = i < n ? i : n - 1;  // unused slots repeat the last leaf's end
    tab.P[i] = P[j];
    tab.out[i] = out[j];
    tab.N[i] = N[j];
    tab.vec[i] = vec[j];
    tab.block_end[i] = block_end[j];
  }
  const int blocks = block_end[n - 1];
  if (blocks <= 0) return 0;
  fedavg_reduce_kernel<<<blocks, THREADS, 0, stream>>>(tab, w, C);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
