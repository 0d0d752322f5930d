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
//
// Segmented route (the tiered aggregation of repro_torch.topo). With a
// (C,) int32 segment map seg and E segments, each leaf's output is (E, N):
//   out[e, n] = sum over c ascending with seg[c] == e of w[c] * P[c, n].
// The grid's y axis is the segment: a CTA owns (column tile, leaf, e). It
// stages w in shared memory CHUNK at a time and compacts the chunk's rows
// of segment e into a shared list, in ascending c (a ballot prefix per
// warp), then walks only that list: it loads only its own segment's rows,
// and its work per chunk is the CTA's share of the stack plus one pass over
// the map. Rows of other segments are skipped, not multiplied by 0, so a
// NaN stays in its segment; a segment with no row writes exactly 0. Every
// (e, n) is still a fixed-order f32 FMA sum with no atomics, and the whole
// stack is read once over the grid. The map is data (seg = assign[idx] of
// the popped cohort), so the launch needs no host sync. Bound: (C*N + E*N
// + 2*C) * 4 bytes a leaf.
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

constexpr int WARPS = THREADS / 32;

// rows[0..return) = the c in [c0, c0 + cn) with seg[c] == e, ascending (a
// block-wide ordered compaction: one ballot prefix per warp and pass).
__device__ __forceinline__ int compact_rows(const int* __restrict__ seg, int c0, int cn,
                                           int e, int* rows, int* warp_count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int j0 = 0; j0 < cn; j0 += THREADS) {
    const int j = j0 + threadIdx.x;
    const bool hit = j < cn && seg[c0 + j] == e;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = base, total = base;
    for (int k = 0; k < WARPS; ++k) {
      before += k < warp ? warp_count[k] : 0;
      total += warp_count[k];
    }
    if (hit) rows[before + __popc(ballot & ((1u << lane) - 1u))] = j;
    __syncthreads();  // warp_count is rewritten by the next pass
    base = total;
  }
  return base;
}

// acc[j] += wc * row[j] for the thread's columns, one f32 FMA each.
template <bool VEC>
__device__ __forceinline__ void fma_row(float* acc, float wc, const float* row) {
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

template <bool VEC, bool SEG>
__device__ __forceinline__ void reduce_columns(const float* __restrict__ P,
                                               const float* __restrict__ sw_global,
                                               const int* __restrict__ seg_global,
                                               float* sw, int* rows, int* warp_count,
                                               int C, int64_t N, int64_t block, int e,
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
    // SEG: only segment e's rows of the chunk, in order
    const int count = SEG ? compact_rows(seg_global, c0, cn, e, rows, warp_count) : 0;
    __syncthreads();
    if (live) {
      if constexpr (SEG) {
#pragma unroll 4
        for (int i = 0; i < count; ++i) {
          const int c = rows[i];
          fma_row<VEC>(acc, sw[c], P + static_cast<int64_t>(c0 + c) * N + col);
        }
      } else {
        const float* row = P + static_cast<int64_t>(c0) * N + col;
#pragma unroll 4
        for (int c = 0; c < cn; ++c, row += N) fma_row<VEC>(acc, sw[c], row);
      }
    }
  }
  if (!live) return;
  if constexpr (SEG) out += static_cast<int64_t>(e) * N;
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(out + col) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    out[col] = acc[0];
  }
}

template <bool SEG>
__global__ void __launch_bounds__(THREADS)
fedavg_reduce_kernel(const __grid_constant__ LeafTable tab, const float* __restrict__ w,
                     const int* __restrict__ seg, int C) {
  __shared__ float sw[CHUNK];
  __shared__ int rows[SEG ? CHUNK : 1];
  __shared__ int warp_count[WARPS];
  const int bx = static_cast<int>(blockIdx.x);
  const int e = static_cast<int>(blockIdx.y);
  int leaf = 0;
  while (bx >= tab.block_end[leaf]) ++leaf;  // uniform over the block
  const int64_t block = bx - (leaf ? tab.block_end[leaf - 1] : 0);
  if (tab.vec[leaf]) {
    reduce_columns<true, SEG>(tab.P[leaf], w, seg, sw, rows, warp_count, C, tab.N[leaf],
                              block, e, tab.out[leaf]);
  } else {
    reduce_columns<false, SEG>(tab.P[leaf], w, seg, sw, rows, warp_count, C, tab.N[leaf],
                               block, e, tab.out[leaf]);
  }
}

}  // namespace

extern "C" {

// One launch for n <= MAX_LEAVES leaves on `stream`; returns
// cudaGetLastError() (0 on success). Leaf i: P[i] (C*N[i] floats,
// row-major), out[i] (N[i] floats, or E*N[i] with a segment map, allocated
// by the caller), vec[i] (1 when N[i] is a multiple of 4 and P[i], out[i]
// are 16-byte aligned),
// block_end[i] = the sum of the block counts of leaves 0..i, a leaf taking
// ceil(N / (256 * (vec ? 4 : 1))) blocks; leaves with N = 0 take none.
// seg: null for the plain sum, else the (C,) int32 segment map on the
// device and E >= 1 its segment count (rows with seg outside 0..E-1 count
// nowhere). The caller keeps every buffer alive until the stream reaches
// the kernel.
int fedavg_reduce_group_launch(const float* const* P, float* const* out, const long long* N,
                               const int* vec, const int* block_end, int n, const float* w,
                               int C, const int* seg, int E, cudaStream_t stream) {
  if (n < 1 || n > MAX_LEAVES || E < 1 || E > 65535 || (!seg && E != 1))
    return static_cast<int>(cudaErrorInvalidValue);
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
  if (seg) {
    fedavg_reduce_kernel<true><<<dim3(blocks, E), THREADS, 0, stream>>>(tab, w, seg, C);
  } else {
    fedavg_reduce_kernel<false><<<blocks, THREADS, 0, stream>>>(tab, w, nullptr, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
