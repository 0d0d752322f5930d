// ssd_common: what the Mamba2 SSD scan's forward (ssd_scan.cu) and backward
// (ssd_scan_bwd.cu) share (Hopper, sm_90a): the CTA shape of their kernels,
// the strides of their inputs, the row loaders into padded f32 (FMA
// kernels) and bf16 (tensor-core kernels) shared tiles, bf16 pair packing
// and the shared-memory cap.
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

}  // namespace
