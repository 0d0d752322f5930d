// ssd_scan: the Mamba2 SSD chunked scan (Hopper, sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel), and computes the function of src/repro/models/ssm.py::
// ssd_chunked: for each (batch, head) and each chunk of L steps in order,
//   y_i = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j + exp(cs_i) C_i . h
//   h  <- exp(cs_L) h + sum_j exp(cs_L - cs_j) dt_j x_j (x) B_j
// with cs the inclusive cumsum of dt * A inside the chunk and h the carried
// (hd, ds) f32 state, from h0 (or zeros). y and the final h are written in
// f32; x, B and C are read as f32 or bf16 and widened on load.
//
// Design. One CTA per (batch, head) walks the chunks in order: this in-block
// loop replaces the Pallas grid's sequential chunk axis, and the state stays
// in shared memory between chunks (hd x ds f32, 32 KiB at 64 x 128). The
// Pallas kernel holds the chunk whole, with an (L, L) f32 score matrix
// (256 KiB at L = 256, more than a block's 227 KiB); here the intra-chunk
// term goes in 64 x 64 sub-blocks, only j-blocks at or below the i-block,
// so the masked upper triangle is skipped. Per i-block: C_i in shared
// memory; the carried-state term C_i h^T first; then for each j-block the
// scores S = C_i B_j^T, scaled by exp(cs_i - cs_j) dt_j (the exponential of
// a difference: exp(cs_i) exp(-cs_j) would overflow, cs reaching dt*A*L),
// masked to j <= i, staged in shared memory and multiplied into x_j. After
// the chunk's i-blocks, the state update walks the j-blocks once more. The
// cumsum runs in order on one thread, as a sequential cumsum does. Every
// product is an f32 FMA (no TF32: the reference's f32 tolerance is 1e-4),
// each thread owning a 4 x (width / 16) register tile of a 16 x 16 thread
// grid; shared rows are padded by one float so the column reads of B, C and
// h fall in distinct banks. No atomics: sums run in a fixed order.
//
// Inputs are read through strides (the last dim contiguous), so x, B and C
// can be the model's slices of the conv output (row stride di + 2 ds) with
// no transpose copy. Bound: at mamba2-370m's prefill shape (B, S, nh, hd,
// ds) = (4, 2048, 32, 64, 128), L = 256, this schedule needs 21.5 GFLOP of
// f32 FMA work (0.32 ms at 67 TFLOP/s) against 110 MB of traffic (33 us at
// 3.35 TB/s): it is bound by operations. B * nh = 128 CTAs, one wave on the
// 132 SMs, one CTA per SM (134 KiB of shared memory each).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLK = 64;       // rows and columns of a sub-block
constexpr int THREADS = 256;  // a 16 x 16 thread grid
constexpr int RB = BLK / 16;  // rows of a sub-block per thread

struct Strides {
  // element strides of x (b, s, h), B (b, s), C (b, s), dt (b, s, h)
  long long xb, xs, xh, bb, bs, cb, cs, db, ds, dh;
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

template <typename T, int HD, int DS>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ h0,
           float* __restrict__ y, float* __restrict__ hout, int S, int nh,
           int L, Strides st) {
  constexpr int LDS = DS + 1;       // padded row of h, B and C
  constexpr int LDB = BLK + 1;      // padded row of the scores
  constexpr int CH = HD / 16;       // columns of y per thread
  constexpr int CN = DS / 16;       // state columns per thread
  extern __shared__ float smem[];
  float* h_s = smem;                 // (HD, LDS) carried state
  float* c_s = h_s + HD * LDS;       // (BLK, LDS) C_i
  float* b_s = c_s + BLK * LDS;      // (BLK, LDS) B_j
  float* x_s = b_s + BLK * LDS;      // (BLK, HD) x_j
  float* s_s = x_s + BLK * HD;       // (BLK, LDB) scores
  float* cs_s = s_s + BLK * LDB;     // (L,) cumsum, then the update weights
  float* dt_s = cs_s + L;            // (L,) dt

  const int h = blockIdx.x, b = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float a = A[h];
  const long long hoff = (static_cast<long long>(b) * nh + h) * HD * DS;
  for (int e = threadIdx.x; e < HD * DS; e += THREADS) {
    h_s[(e / DS) * LDS + e % DS] = h0 ? h0[hoff + e] : 0.f;
  }

  const int nb = (L + BLK - 1) / BLK;
  for (int s0 = 0; s0 < S; s0 += L) {
    const T* xc = x + b * st.xb + s0 * st.xs + h * st.xh;
    const T* bc = Bm + b * st.bb + s0 * st.bs;
    const T* cc = Cm + b * st.cb + s0 * st.cs;
    for (int t = threadIdx.x; t < L; t += THREADS) {
      dt_s[t] = dt[b * st.db + (s0 + t) * st.ds + h * st.dh];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float run = 0.f;
      for (int t = 0; t < L; ++t) {
        run = __fadd_rn(run, __fmul_rn(dt_s[t], a));  // no FMA contraction
        cs_s[t] = run;
      }
    }
    __syncthreads();
    const float total = cs_s[L - 1];

    for (int ib = 0; ib < nb; ++ib) {
      const int i0 = ib * BLK;
      load_rows<T, DS>(c_s, LDS, cc, st.cs, i0, L);
      __syncthreads();
      // the carried state's term: exp(cs_i) * C_i . h^T
      float acc[RB][CH] = {};
      for (int n = 0; n < DS; ++n) {
        float av[RB], bv[CH];
#pragma unroll
        for (int r = 0; r < RB; ++r) av[r] = c_s[(ty + 16 * r) * LDS + n];
#pragma unroll
        for (int c = 0; c < CH; ++c) bv[c] = h_s[(tx + 16 * c) * LDS + n];
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int c = 0; c < CH; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int i = i0 + ty + 16 * r;
        const float e = i < L ? expf(cs_s[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c) acc[r][c] *= e;
      }
      // the intra-chunk term, j-blocks at or below the diagonal
      for (int jb = 0; jb <= ib; ++jb) {
        const int j0 = jb * BLK;
        load_rows<T, DS>(b_s, LDS, bc, st.bs, j0, L);
        load_rows<T, HD>(x_s, HD, xc, st.xs, j0, L);
        __syncthreads();
        float sc[RB][RB] = {};
        for (int n = 0; n < DS; ++n) {
          float av[RB], bv[RB];
#pragma unroll
          for (int r = 0; r < RB; ++r) av[r] = c_s[(ty + 16 * r) * LDS + n];
#pragma unroll
          for (int c = 0; c < RB; ++c) bv[c] = b_s[(tx + 16 * c) * LDS + n];
#pragma unroll
          for (int r = 0; r < RB; ++r)
#pragma unroll
            for (int c = 0; c < RB; ++c) sc[r][c] = fmaf(av[r], bv[c], sc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < RB; ++c) {
            const int j = j0 + tx + 16 * c;
            s_s[(ty + 16 * r) * LDB + tx + 16 * c] =
                (j <= i && i < L) ? sc[r][c] * expf(cs_s[i] - cs_s[j]) * dt_s[j]
                                  : 0.f;
          }
        }
        __syncthreads();
        for (int j = 0; j < BLK; ++j) {
          float av[RB], bv[CH];
#pragma unroll
          for (int r = 0; r < RB; ++r) av[r] = s_s[(ty + 16 * r) * LDB + j];
#pragma unroll
          for (int c = 0; c < CH; ++c) bv[c] = x_s[j * HD + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < RB; ++r)
#pragma unroll
            for (int c = 0; c < CH; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i < L) {
          float* yrow = y + ((static_cast<long long>(b) * S + s0 + i) * nh + h) * HD;
#pragma unroll
          for (int c = 0; c < CH; ++c) yrow[tx + 16 * c] = acc[r][c];
        }
      }
    }

    // state update: h <- exp(total) h + sum_j w_j x_j (x) B_j,
    // w_j = exp(total - cs_j) dt_j (written over the cumsum)
    for (int t = threadIdx.x; t < L; t += THREADS) {
      cs_s[t] = expf(total - cs_s[t]) * dt_s[t];
    }
    const float decay = expf(total);
    float hacc[CH][CN];
#pragma unroll
    for (int r = 0; r < CH; ++r)
#pragma unroll
      for (int c = 0; c < CN; ++c)
        hacc[r][c] = decay * h_s[(ty + 16 * r) * LDS + tx + 16 * c];
    for (int jb = 0; jb < nb; ++jb) {
      const int j0 = jb * BLK;
      load_rows<T, DS>(b_s, LDS, bc, st.bs, j0, L);
      load_rows<T, HD>(x_s, HD, xc, st.xs, j0, L);
      __syncthreads();
      const int jn = min(BLK, L - j0);
      for (int j = 0; j < jn; ++j) {
        const float w = cs_s[j0 + j];
        float av[CH], bv[CN];
#pragma unroll
        for (int r = 0; r < CH; ++r) av[r] = w * x_s[j * HD + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < CN; ++c) bv[c] = b_s[j * LDS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < CH; ++r)
#pragma unroll
          for (int c = 0; c < CN; ++c) hacc[r][c] = fmaf(av[r], bv[c], hacc[r][c]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < CH; ++r)
#pragma unroll
      for (int c = 0; c < CN; ++c)
        h_s[(ty + 16 * r) * LDS + tx + 16 * c] = hacc[r][c];
    __syncthreads();
  }
  for (int e = threadIdx.x; e < HD * DS; e += THREADS) {
    hout[hoff + e] = h_s[(e / DS) * LDS + e % DS];
  }
}

template <int HD, int DS>
constexpr size_t smem_bytes(int L) {
  return sizeof(float) * (HD * (DS + 1) + 2 * BLK * (DS + 1) + BLK * HD +
                          BLK * (BLK + 1) + 2 * L);
}

template <typename T, int HD, int DS>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* h0, float* y, float* hout, int Bb,
           int S, int nh, int L, Strides st, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD, DS>(L);
  auto kernel = ssd_kernel<T, HD, DS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(nh, Bb), THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), h0, y, hout, S, nh, L, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, int ds, const void* x, const float* dt, const float* A,
             const void* Bm, const void* Cm, const float* h0, float* y,
             float* hout, int Bb, int S, int nh, int L, Strides st,
             cudaStream_t stream) {
#define SSD_CASE(HD_, DS_)                                                    \
  if (hd == HD_ && ds == DS_)                                                 \
    return launch<T, HD_, DS_>(x, dt, A, Bm, Cm, h0, y, hout, Bb, S, nh, L, st, \
                               stream);
  SSD_CASE(32, 16)
  SSD_CASE(32, 64)
  SSD_CASE(32, 128)
  SSD_CASE(64, 16)
  SSD_CASE(64, 64)
  SSD_CASE(64, 128)
#undef SSD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// x (Bb, S, nh, hd), B/C (Bb, S, ds): f32 (dtype 0) or bf16 (dtype 1), the
// last dim contiguous; dt (Bb, S, nh) f32; A (nh,) f32; h0 (Bb, nh, hd, ds)
// f32 contiguous or null (zeros). Writes y (Bb, S, nh, hd) and hout
// (Bb, nh, hd, ds), f32 contiguous. `strides` holds the ten element strides
// of Strides. Requires S % L == 0 (the wrapper checks). Launches on `stream`
// and does not synchronise; returns the launch error, or 0.
int ssd_scan_launch(const void* x, const float* dt, const float* A,
                    const void* Bm, const void* Cm, const float* h0, float* y,
                    float* hout, int Bb, int S, int nh, int hd, int ds, int L,
                    const long long* strides, int dtype, cudaStream_t stream) {
  Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
             strides[5], strides[6], strides[7], strides[8], strides[9]};
  if (dtype == 0)
    return dispatch<float>(hd, ds, x, dt, A, Bm, Cm, h0, y, hout, Bb, S, nh, L,
                           st, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, ds, x, dt, A, Bm, Cm, h0, y, hout, Bb, S,
                                   nh, L, st, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
