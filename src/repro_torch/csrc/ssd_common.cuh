// ssd_common: what the Mamba2 SSD scan's forward (ssd_scan.cu) and backward
// (ssd_scan_bwd.cu) share (Hopper, sm_90a): the CTA shape of their kernels,
// the strides of their inputs, the row loaders into padded f32 (FMA
// kernels) and bf16 (tensor-core kernels) shared tiles, bf16 pair packing,
// the shared-memory cap, the fixed-order chunk cumsum and the CB kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mma_tiles.cuh"

namespace {

constexpr int BLK = 64;       // rows and columns of a sub-block
constexpr int THREADS = 256;  // a 16 x 16 thread grid
constexpr int RB = BLK / 16;  // rows of a sub-block per thread

struct Strides {
  // element strides of x (b, s, h), B (b, s), C (b, s), dt (b, s, h) and
  // A (b): 0 where A is (nh,), nh where it is one row per batch row
  long long xb, xs, xh, bb, bs, cb, cs, db, ds, dh, ab;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// rows [r0, r0 + BLK) of a (rows, width) matrix (row stride `rs`, contiguous
// in the row) into dst with row stride `ld`, zero past row `rows`
template <typename T, int W>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long rs, int r0, int rows) {
  for (int e = threadIdx.x; e < BLK * W; e += THREADS) {
    const int r = e / W, c = e % W;
    dst[r * ld + c] = (r0 + r < rows) ? widen(src[(r0 + r) * rs + c]) : 0.f;
  }
}

constexpr int kMaxL = 256;  // longest chunk of this route (one row a thread)
constexpr int PAD = 8;      // bf16 padding of a shared row: 16 B, so the
                            // eight rows of an ldmatrix hit distinct banks
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  __nv_bfloat162 v;
  memcpy(&v, &u, sizeof(u));
  return __bfloat1622float2(v);
}

// rows [0, LP) of a (rows, W) bf16 matrix (row stride rs, contiguous rows)
// into shared memory with row stride W + PAD, zero from row `rows` on.
// Where `vec` (every row 16-byte aligned) the rows come by cp.async, all
// in flight; the caller commits and waits before it reads them.
template <int W>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long rs,
                                          int rows, int LP, bool vec) {
  constexpr int CPR = W / 8;  // 16-byte pieces a row
  for (int e = threadIdx.x; e < LP * CPR; e += THREADS) {
    const int r = e / CPR, c = (e % CPR) * 8;
    bf16* d = dst + r * (W + PAD) + c;
    const bf16* p = src + r * rs + c;
    if (r < rows && vec) {
      cp_async16(d, p);
    } else {
      bf16 tmp[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) tmp[i] = r < rows ? p[i] : __float2bfloat16(0.f);
      memcpy(d, tmp, sizeof(tmp));
    }
  }
}

// Raises `kernel`'s dynamic shared memory cap to `bytes` on the current
// device if it is below: once per kernel and device in practice.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int (&cap)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int& have = cap[dev & 63];
  if (bytes <= have) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) have = bytes;
  return err;
}

// cs[t] = inclusive cumsum of dt[t] * a over the chunk (t < L), in a fixed
// order: a shuffle scan in each warp, then the warps' totals in order.
// The forward's state and output phases and the backward's pre-pass call
// this on the same inputs, so all of them see the same bits. cs has THREADS
// entries (past L: the chunk total).
__device__ __forceinline__ void chunk_cumsum(const float* dt_s, float a, float* cs,
                                             float* warp_tot, int L) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float v = t < L ? __fmul_rn(dt_s[t], a) : 0.f;  // no FMA contraction
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = __fadd_rn(v, u);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base = __fadd_rn(base, warp_tot[w]);
  cs[t] = __fadd_rn(base, v);
  __syncthreads();
}

// Per (b, chunk, 64 x 64 block at or below the diagonal): CB[i][j] = C_i .
// B_j for every head at once (B and C have no head axis), into a (L, ldc)
// f32 matrix per (b, chunk). Exact products of bf16 inputs, summed in f32 by
// the tensor cores. The forward's phase 1 and the backward's CB pass.
template <int DS>
__global__ void __launch_bounds__(THREADS)
ssd_cb_kernel(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
              float* __restrict__ cb, int L, int ldc, Strides st, bool vec) {
  constexpr int LD = DS + PAD;
  __shared__ __align__(16) bf16 c_s[64 * LD];
  __shared__ __align__(16) bf16 b_s[64 * LD];
  int p = blockIdx.x, ib = 0;  // the block pair (ib, jb), jb <= ib
  while (p > ib) p -= ++ib;
  const int jb = p, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int i0 = 64 * ib, j0 = 64 * jb, s0 = c * L;
  load_tile<DS>(c_s, Cm + b * st.cb + (s0 + i0) * st.cs, st.cs, L - i0, 64, vec);
  load_tile<DS>(b_s, Bm + b * st.bb + (s0 + j0) * st.bs, st.bs, L - j0, 64, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mi = lane >> 3, rr = lane & 7, g = lane >> 2, t4 = lane & 3;
  const int mt = warp & 3, nq = warp >> 2;  // rows 16 mt, columns 32 nq
  float acc[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < DS / 16; ++kk) {
    uint32_t a[4];
    ldsm(a, c_s + (16 * mt + (mi & 1) * 8 + rr) * LD + 16 * kk + (mi >> 1) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bq[4];  // B[k][j] = B_j[k], stored (j, k): no transpose
      ldsm(bq, b_s + (32 * nq + 16 * np + (mi >> 1) * 8 + rr) * LD + 16 * kk +
                   (mi & 1) * 8);
      mma(acc[2 * np], a, bq[0], bq[1]);
      mma(acc[2 * np + 1], a, bq[2], bq[3]);
    }
  }
  float* out = cb + static_cast<long long>(b * nc + c) * L * ldc;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + 16 * mt + g + 8 * half;
    if (i >= L) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = j0 + 32 * nq + 8 * n + 2 * t4;
      if (j < L) out[i * ldc + j] = acc[n][2 * half];
      if (j + 1 < L) out[i * ldc + j + 1] = acc[n][2 * half + 1];
    }
  }
}

}  // namespace
