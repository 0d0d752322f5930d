// ssd_scan_bwd: the backward of the Mamba2 SSD chunked scan (Hopper, sm_90a).
//
// It replaces no TPU kernel. The reference trains through jax.grad of the
// jnp ssd_chunked (src/repro/models/ssm.py), and its Pallas kernel has no
// VJP. The port trains through its K6 kernel, so the gradient of the scan
// is a kernel too. Per (batch b, head h, chunk) with rows i, j in [0, L):
// l_j = dt_j a, cs the inclusive cumsum of l, T = cs_{L-1}, CB_ij = C_i.B_j,
// M_ij = CB_ij exp(cs_i - cs_j) dt_j (j <= i, else 0), w_j = exp(T - cs_j)
// dt_j. The forward is y_i = sum_j M_ij x_j + exp(cs_i) h_in C_i and
// h_out = exp(T) h_in + sum_j w_j x_j (x) B_j. Given dy and dH_out:
//   dH_in = exp(T) dH_out + sum_i exp(cs_i) dy_i (x) C_i   (chunk by chunk back)
//   dM_ij = dy_i . x_j,  P_ij = dM_ij exp(cs_i - cs_j) dt_j
//   dx_j = sum_i M_ij dy_i + w_j dH_out B_j
//   dB_j = sum_h [sum_i P_ij C_i + w_j dH_out^T x_j]
//   dC_i = sum_h [sum_j P_ij B_j + exp(cs_i) h_in^T dy_i]
//   dcs from G_ij = dM_ij M_ij (row sums in, column sums out), the entering
//   state's and the leaving state's terms; dl its reverse cumsum;
//   ddt = dM.CB.decay summed over i + exp(T - cs_j) u_j + a dl, with
//   u_j = x_j . (dH_out B_j); dA = sum over (b, chunk, k) of dt_k dl_k.
// Every exponential is taken of a difference that is <= 0, masked before
// exp (j <= i, T - cs_j, cs_i, T): the reference's jax.grad takes exp of
// every (i, j) and masks after, so 0 * inf turns its ddt and dA into NaN
// once sum dt |a| over a chunk passes about 88; this kernel stays finite.
//
// Four kernels on the caller's stream, from one C call:
//  1. ssd_bwd_dstate_kernel, per (b, head, chunk): the chunk's cumsum and
//     total, and its own sum_i exp(cs_i) dy_i (x) C_i.
//  2. ssd_bwd_pass_kernel, per (b, head, 1024 state elements): the chunks
//     in reverse, dH_out of each (written over its own term), and dh0.
//  3. ssd_bwd_chunk_kernel, per (b, head, chunk): 64-row blocks of j (x_j,
//     B_j) outside, blocks of i >= j inside; dx_j and the head's dB_j in
//     registers, the head's dC_i in its workspace rows (read, added, written
//     by the same thread in block order); dcs and ddt's direct part in
//     shared memory, each entry updated by one thread between barriers; at
//     the end one thread's reverse cumsum gives ddt and the chunk's dA.
//  4. ssd_bwd_sum_kernel: dB and dC summed over the heads in head order and
//     written in x's dtype; dA's per-row partials (b, head) summed over the
//     chunks in order.
// bf16 x, B and C with chunks of at most 256 and d_state of at least 64 (the
// model's route) run phases 1 and 3 on the tensor cores (the _tc_ kernels:
// mma.sync from ldmatrix, each f32 operand as two bf16 terms, below); f32
// inputs and the other bf16 shapes run them as f32 FMA on the widened
// inputs. No atomics: two launches on the same inputs give the same bits.
//
// Bound on the H100 at mamba2-370m's training shape (B, S, nh, hd, ds) =
// (4, 2048, 32, 64, 128), L = 256, bf16: the function needs 43 GFLOP (the
// causal pairs' products, CB once per (b, chunk), and four (L x hd x ds)
// products a chunk): 44 us at 989 TFLOP/s; its inputs and outputs (x, dy
// in f32, h_in, dx, B, C, dB, dC, dt, ddt, dh0) are 182 MB: 54 us at
// 3.35 TB/s, so bytes bound it. The schedule adds about 670 MB of
// workspace traffic: each chunk's state term and dH_out (33.5 MB each way,
// twice) and the per-head dB and dC partials, 2 x (4, 32, 2048, 128) f32 =
// 268 MB written, read by the head sums, and dC's read and written again by
// each later block of j. The tensor-core route runs 119 GFLOP of mma work
// (whole 64 x 64 blocks, CB per head, two or three products a term pair)
// in one 175 KB CTA of 8 warps per SM: its time goes to that work at the
// rate one CTA an SM reaches, not to the bound. The FMA route's 60 GFLOP
// from shared memory (8 loads for 16 FMAs) reaches at most half of the
// 67 TFLOP/s f32 rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ssd_common.cuh"

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

// sum over the 16 threads of a row of the 16 x 16 grid (the same bits in each)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dt of (b, h, chunk) into dt_s, then its inclusive cumsum of dt * a into
// cs_s, in order on one thread (any L); returns after a barrier
__device__ __forceinline__ void chunk_cumsum(const float* dt, float a, float* dt_s,
                                             float* cs_s, int b, int h, int s0, int L,
                                             const Strides& st) {
  for (int t = threadIdx.x; t < L; t += THREADS)
    dt_s[t] = dt[b * st.db + (s0 + t) * st.ds + h * st.dh];
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int t = 0; t < L; ++t) {
      run = __fadd_rn(run, __fmul_rn(dt_s[t], a));  // no FMA contraction
      cs_s[t] = run;
    }
  }
  __syncthreads();
}

// Phase 1, per (b, head, chunk): dstate = sum_i exp(cs_i) dy_i (x) C_i
// (hd x ds, each thread a (hd / 16) x (ds / 16) tile) and the chunk total T.
template <typename T, int HD, int DS>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dstate_kernel(const float* __restrict__ dy, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Cm,
                      float* __restrict__ dstate, float* __restrict__ totals, int S,
                      int nh, int L, Strides st) {
  constexpr int LDS = DS + 1, CH = HD / 16, CN = DS / 16;
  extern __shared__ float smem[];
  float* dy_s = smem;             // (BLK, HD) exp(cs_i) dy_i
  float* c_s = dy_s + BLK * HD;   // (BLK, LDS) C_i
  float* dt_s = c_s + BLK * LDS;  // (L,)
  float* cs_s = dt_s + L;         // (L,)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int s0 = c * L, tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  chunk_cumsum(dt, A[b * st.ab + h], dt_s, cs_s, b, h, s0, L, st);
  const long long bhc = (static_cast<long long>(b) * nh + h) * nc + c;
  if (threadIdx.x == 0) totals[bhc] = cs_s[L - 1];
  const long long dys = static_cast<long long>(nh) * HD;  // dy's row stride
  const float* dyc = dy + (static_cast<long long>(b) * S + s0) * dys + h * HD;
  const T* cc = Cm + b * st.cb + s0 * st.cs;
  float acc[CH][CN] = {};
  for (int i0 = 0; i0 < L; i0 += BLK) {
    load_rows<float, HD>(dy_s, HD, dyc, dys, i0, L);
    load_rows<T, DS>(c_s, LDS, cc, st.cs, i0, L);
    __syncthreads();
    for (int e = threadIdx.x; e < BLK * HD; e += THREADS)
      if (i0 + e / HD < L) dy_s[e] *= expf(cs_s[i0 + e / HD]);
    __syncthreads();
    const int in = min(BLK, L - i0);
    for (int i = 0; i < in; ++i) {
      float av[CH], bv[CN];
#pragma unroll
      for (int r = 0; r < CH; ++r) av[r] = dy_s[i * HD + ty + 16 * r];
#pragma unroll
      for (int q = 0; q < CN; ++q) bv[q] = c_s[i * LDS + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < CH; ++r)
#pragma unroll
        for (int q = 0; q < CN; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
    __syncthreads();
  }
  float* out = dstate + bhc * HD * DS;
#pragma unroll
  for (int r = 0; r < CH; ++r)
#pragma unroll
    for (int q = 0; q < CN; ++q) out[(ty + 16 * r) * DS + tx + 16 * q] = acc[r][q];
}

// Phase 2, per (b, head, 1024 state elements): the chunks in reverse from
// dh_final (or zeros). Chunk c's slot holds its own term on entry and its
// dH_out on exit; dH_in = exp(T_c) dH_out + term is the previous chunk's
// dH_out, and chunk 0's is dh0.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_pass_kernel(const float* __restrict__ dhf, float* __restrict__ dstate,
                    const float* __restrict__ totals, float* __restrict__ dh0, int nc,
                    int E) {
  const long long bh = static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int e = (blockIdx.x * THREADS + threadIdx.x) * 4;
  if (e >= E) return;
  float4 g = dhf ? *reinterpret_cast<const float4*>(dhf + bh * E + e)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = nc - 1; c >= 0; --c) {
    float4* slot = reinterpret_cast<float4*>(dstate + (bh * nc + c) * E + e);
    const float4 s = *slot;
    *slot = g;
    const float d = expf(totals[bh * nc + c]);
    g = make_float4(d * g.x + s.x, d * g.y + s.y, d * g.z + s.z, d * g.w + s.w);
  }
  *reinterpret_cast<float4*>(dh0 + bh * E + e) = g;
}

// One thread, after a chunk's blocks: d cs's terms at T (<dH_out, h_in>
// from the threads' shares, sum_j w_j u_j), dl = the reverse cumsum of
// d cs, ddt = its direct part + a dl, and the chunk's dA = dt . dl.
__device__ __forceinline__ void chunk_tail(const float* sum_s, const float* wu_s,
                                           float* dcs_s, const float* ddt_s,
                                           const float* dt_s, float total, float a, int L,
                                           float* ddt, float* dAc, long long bhc, int b,
                                           int S, int s0, int nh, int h) {
  float d = 0.f, wu = 0.f;
  for (int t = 0; t < THREADS; ++t) d += sum_s[t];
  for (int t = 0; t < L; ++t) wu += wu_s[t];
  dcs_s[L - 1] += expf(total) * d + wu;
  float run = 0.f, da = 0.f;
  for (int k = L - 1; k >= 0; --k) {
    run += dcs_s[k];
    ddt[(static_cast<long long>(b) * S + s0 + k) * nh + h] = ddt_s[k] + a * run;
    da = fmaf(dt_s[k], run, da);
  }
  dAc[bhc] = da;
}

// Phase 3, per (b, head, chunk): everything else. Each thread owns a
// 4 x (width / 16) register tile of a 16 x 16 thread grid (rows ty + 16 r,
// columns tx + 16 q); shared rows are padded by one float so that column
// reads fall in distinct banks.
template <typename T, int HD, int DS>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const float* __restrict__ hin,
                     const float* __restrict__ dy, const float* __restrict__ dHout,
                     T* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dBp,
                     float* __restrict__ dCp, float* __restrict__ dAc, int S, int nh, int L,
                     Strides st) {
  constexpr int LDS = DS + 1, LDX = HD + 1, LDB = BLK + 1;
  constexpr int CH = HD / 16, CN = DS / 16;
  extern __shared__ float smem[];
  float* hin_s = smem;               // (HD, LDS) h_in
  float* dh_s = hin_s + HD * LDS;    // (HD, LDS) dH_out
  float* x_s = dh_s + HD * LDS;      // (BLK, LDX) x_j
  float* b_s = x_s + BLK * LDX;      // (BLK, LDS) B_j
  float* dy_s = b_s + BLK * LDS;     // (BLK, LDX) dy_i
  float* c_s = dy_s + BLK * LDX;     // (BLK, LDS) C_i
  float* m_s = c_s + BLK * LDS;      // (BLK, LDB) M of the block pair
  float* p_s = m_s + BLK * LDB;      // (BLK, LDB) P of the block pair
  float* red_s = p_s + BLK * LDB;    // (2, 16, BLK) column partials of G and Q
  float* dt_s = red_s + 32 * BLK;    // (L,) dt
  float* cs_s = dt_s + L;            // (L,) cumsum
  float* w_s = cs_s + L;             // (L,) w_j
  float* dcs_s = w_s + L;            // (L,) d cs
  float* ddt_s = dcs_s + L;          // (L,) ddt's direct part
  float* wu_s = ddt_s + L;           // (L,) w_j u_j
  float* sum_s = wu_s + L;           // (THREADS,) shares of <dH_out, h_in>

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int s0 = c * L, tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float a = A[b * st.ab + h];
  const long long bhc = (static_cast<long long>(b) * nh + h) * nc + c;
  float dot = 0.f;
  for (int e = tid; e < HD * DS; e += THREADS) {
    const float hv = hin[bhc * HD * DS + e], gv = dHout[bhc * HD * DS + e];
    hin_s[(e / DS) * LDS + e % DS] = hv;
    dh_s[(e / DS) * LDS + e % DS] = gv;
    dot = fmaf(gv, hv, dot);
  }
  sum_s[tid] = dot;
  chunk_cumsum(dt, a, dt_s, cs_s, b, h, s0, L, st);
  const float total = cs_s[L - 1];
  for (int t = tid; t < L; t += THREADS) {
    w_s[t] = expf(total - cs_s[t]) * dt_s[t];
    dcs_s[t] = 0.f;
    ddt_s[t] = 0.f;
  }

  const T* xc = x + b * st.xb + s0 * st.xs + h * st.xh;
  const T* bc = Bm + b * st.bb + s0 * st.bs;
  const T* cc = Cm + b * st.cb + s0 * st.cs;
  const long long dys = static_cast<long long>(nh) * HD;  // dy's and dx's row stride
  const float* dyc = dy + (static_cast<long long>(b) * S + s0) * dys + h * HD;
  T* dxc = dx + (static_cast<long long>(b) * S + s0) * dys + h * HD;
  const long long poff = ((static_cast<long long>(b) * nh + h) * S + s0) * DS;
  float* dbp = dBp + poff;  // this head's (L, DS) rows of the chunk
  float* dcp = dCp + poff;
  const int nb = (L + BLK - 1) / BLK;
  for (int jb = 0; jb < nb; ++jb) {
    const int j0 = jb * BLK;
    __syncthreads();
    load_rows<T, HD>(x_s, LDX, xc, st.xs, j0, L);
    load_rows<T, DS>(b_s, LDS, bc, st.bs, j0, L);
    __syncthreads();
    // the leaving state's terms of rows j: dx_j = w_j dH_out B_j,
    // dB_j = w_j dH_out^T x_j, u_j = B_j . dH_out^T x_j
    float dxa[RB][CH] = {}, dba[RB][CN] = {};
    for (int n = 0; n < DS; ++n) {
      float av[RB], bv[CH];
#pragma unroll
      for (int r = 0; r < RB; ++r) av[r] = b_s[(ty + 16 * r) * LDS + n];
#pragma unroll
      for (int q = 0; q < CH; ++q) bv[q] = dh_s[(tx + 16 * q) * LDS + n];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int q = 0; q < CH; ++q) dxa[r][q] = fmaf(av[r], bv[q], dxa[r][q]);
    }
    for (int p = 0; p < HD; ++p) {
      float av[RB], bv[CN];
#pragma unroll
      for (int r = 0; r < RB; ++r) av[r] = x_s[(ty + 16 * r) * LDX + p];
#pragma unroll
      for (int q = 0; q < CN; ++q) bv[q] = dh_s[p * LDS + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int q = 0; q < CN; ++q) dba[r][q] = fmaf(av[r], bv[q], dba[r][q]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int j = j0 + ty + 16 * r;
      float u = 0.f;
#pragma unroll
      for (int q = 0; q < CN; ++q) u = fmaf(dba[r][q], b_s[(ty + 16 * r) * LDS + tx + 16 * q], u);
      u = row_sum(u);
      const float wj = j < L ? w_s[j] : 0.f;
#pragma unroll
      for (int q = 0; q < CH; ++q) dxa[r][q] *= wj;
#pragma unroll
      for (int q = 0; q < CN; ++q) dba[r][q] *= wj;
      if (tx == 0 && j < L) {
        wu_s[j] = wj * u;
        dcs_s[j] -= wj * u;
        ddt_s[j] += expf(total - cs_s[j]) * u;
      }
    }

    for (int ib = jb; ib < nb; ++ib) {
      const int i0 = ib * BLK;
      __syncthreads();
      load_rows<float, HD>(dy_s, LDX, dyc, dys, i0, L);
      load_rows<T, DS>(c_s, LDS, cc, st.cs, i0, L);
      __syncthreads();
      float rowg[RB] = {};
      if (jb == 0) {
        // the entering state's terms of rows i, first: dC_i = exp(cs_i)
        // h_in^T dy_i into the workspace, exp(cs_i) C_i . h_in^T dy_i to dcs_i
        float rt[RB][CN] = {};
        for (int p = 0; p < HD; ++p) {
          float av[RB], bv[CN];
#pragma unroll
          for (int r = 0; r < RB; ++r) av[r] = dy_s[(ty + 16 * r) * LDX + p];
#pragma unroll
          for (int q = 0; q < CN; ++q) bv[q] = hin_s[p * LDS + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < RB; ++r)
#pragma unroll
            for (int q = 0; q < CN; ++q) rt[r][q] = fmaf(av[r], bv[q], rt[r][q]);
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const int i = i0 + ty + 16 * r;
          const float ei = i < L ? expf(cs_s[i]) : 0.f;
          float s = 0.f;
#pragma unroll
          for (int q = 0; q < CN; ++q) {
            const float v = ei * rt[r][q];
            s = fmaf(v, c_s[(ty + 16 * r) * LDS + tx + 16 * q], s);
            if (i < L) dcp[i * DS + tx + 16 * q] = v;
          }
          rowg[r] = s;  // summed over the row with G's terms below
        }
      }
      // CB and dM of the block pair, then M, P and the sums of G and Q
      float sc[RB][RB] = {}, dm[RB][RB] = {};
      for (int n = 0; n < DS; ++n) {
        float av[RB], bv[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) av[r] = c_s[(ty + 16 * r) * LDS + n];
#pragma unroll
        for (int q = 0; q < RB; ++q) bv[q] = b_s[(tx + 16 * q) * LDS + n];
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int q = 0; q < RB; ++q) sc[r][q] = fmaf(av[r], bv[q], sc[r][q]);
      }
      for (int p = 0; p < HD; ++p) {
        float av[RB], bv[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) av[r] = dy_s[(ty + 16 * r) * LDX + p];
#pragma unroll
        for (int q = 0; q < RB; ++q) bv[q] = x_s[(tx + 16 * q) * LDX + p];
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int q = 0; q < RB; ++q) dm[r][q] = fmaf(av[r], bv[q], dm[r][q]);
      }
      float colg[RB] = {}, colq[RB] = {};
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int i = i0 + ty + 16 * r;
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          const int j = j0 + tx + 16 * q;
          const bool on = j <= i && i < L;
          const float e = on ? expf(cs_s[i] - cs_s[j]) : 0.f;  // masked before exp
          const float dtj = on ? dt_s[j] : 0.f;
          const float cbe = sc[r][q] * e;
          const float qv = dm[r][q] * cbe;  // dM CB decay: ddt's direct part
          const float g = qv * dtj;         // dM M
          m_s[(ty + 16 * r) * LDB + tx + 16 * q] = cbe * dtj;
          p_s[(ty + 16 * r) * LDB + tx + 16 * q] = dm[r][q] * e * dtj;
          rowg[r] += g;
          colg[q] += g;
          colq[q] += qv;
        }
      }
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        red_s[ty * BLK + tx + 16 * q] = colg[q];
        red_s[(16 + ty) * BLK + tx + 16 * q] = colq[q];
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int i = i0 + ty + 16 * r;
        const float s = row_sum(rowg[r]);
        if (tx == 0 && i < L) dcs_s[i] += s;
      }
      __syncthreads();
      if (tid < BLK && j0 + tid < L) {
        float sg = 0.f, sq = 0.f;
        for (int t = 0; t < 16; ++t) {
          sg += red_s[t * BLK + tid];
          sq += red_s[(16 + t) * BLK + tid];
        }
        dcs_s[j0 + tid] -= sg;
        ddt_s[j0 + tid] += sq;
      }
      // dx_j += M^T dy_i, dB_j += P^T C_i
      const int in = min(BLK, L - i0);
      for (int k = 0; k < in; ++k) {
        float av[RB], pv[RB], bv[CH], cv[CN];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          av[r] = m_s[k * LDB + ty + 16 * r];
          pv[r] = p_s[k * LDB + ty + 16 * r];
        }
#pragma unroll
        for (int q = 0; q < CH; ++q) bv[q] = dy_s[k * LDX + tx + 16 * q];
#pragma unroll
        for (int q = 0; q < CN; ++q) cv[q] = c_s[k * LDS + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
#pragma unroll
          for (int q = 0; q < CH; ++q) dxa[r][q] = fmaf(av[r], bv[q], dxa[r][q]);
#pragma unroll
          for (int q = 0; q < CN; ++q) dba[r][q] = fmaf(pv[r], cv[q], dba[r][q]);
        }
      }
      // dC_i += P B_j, on the head's workspace rows
      float dca[RB][CN];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int i = i0 + ty + 16 * r;
#pragma unroll
        for (int q = 0; q < CN; ++q) dca[r][q] = i < L ? dcp[i * DS + tx + 16 * q] : 0.f;
      }
      const int jn = min(BLK, L - j0);
      for (int k = 0; k < jn; ++k) {
        float av[RB], bv[CN];
#pragma unroll
        for (int r = 0; r < RB; ++r) av[r] = p_s[(ty + 16 * r) * LDB + k];
#pragma unroll
        for (int q = 0; q < CN; ++q) bv[q] = b_s[k * LDS + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int q = 0; q < CN; ++q) dca[r][q] = fmaf(av[r], bv[q], dca[r][q]);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i < L) {
#pragma unroll
          for (int q = 0; q < CN; ++q) dcp[i * DS + tx + 16 * q] = dca[r][q];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int j = j0 + ty + 16 * r;
      if (j < L) {
#pragma unroll
        for (int q = 0; q < CH; ++q) store(dxc + j * dys + tx + 16 * q, dxa[r][q]);
#pragma unroll
        for (int q = 0; q < CN; ++q) dbp[j * DS + tx + 16 * q] = dba[r][q];
      }
    }
  }
  __syncthreads();
  if (tid == 0) chunk_tail(sum_s, wu_s, dcs_s, ddt_s, dt_s, total, a, L, ddt, dAc,
                           bhc, b, S, s0, nh, h);
}

// ---------------------------------------------------------------------------
// The tensor-core route of phase 3 (bf16 x, B and C, chunks of at most 256,
// d_state of at least 64): the FMA kernel's schedule with every product on
// mma.sync m16n8k16 (bf16 in, f32 accumulate) from ldmatrix fragments of
// padded shared tiles. x, B and C are exact bf16; each f32 operand (dy,
// dH_out, h_in, M, P) goes in as two bf16 planes, hi (the value rounded) and
// lo (the remainder rounded). A product with one exact operand takes two
// mma (hi, lo); M^T dy and dy h_in have none and take three (hi hi, hi lo,
// lo hi), as tests/test_torch_ssd_scan_bwd.py's emulation settles: one term
// leaves ddt and dA off by up to 1e-2 of their max, two within 1e-5.
// ---------------------------------------------------------------------------

// (v0, v1) as a hi and a lo bf16 pair: the values rounded, the remainders
// rounded
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(h);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(v0 - f.x, v1 - f.y));
}

// the f32 pair (v0, v1) into the hi and lo planes (`plane` elements apart)
// of a padded bf16 tile at element `at` (even)
__device__ __forceinline__ void store_split(bf16* tile, int plane, int at, float v0,
                                            float v1) {
  uint32_t hi, lo;
  split2(v0, v1, hi, lo);
  *reinterpret_cast<uint32_t*>(tile + at) = hi;
  *reinterpret_cast<uint32_t*>(tile + plane + at) = lo;
}

// acc (16 rows from m0, 16 NP columns from n0; n-tile t at columns
// n0 + 8 t) += A (16 x K) B (K x 16 NP), one warp, both operands bf16 in
// shared memory: A stored (m, k), or (k, m) where A_T; B stored (n, k), or
// (k, n) where B_T.
template <int K, int NP, bool A_T, bool B_T>
__device__ __forceinline__ void warp_mma(float (&acc)[2 * NP][4], const bf16* a, int lda,
                                         const bf16* b, int ldb, int m0, int n0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    if (A_T)
      ldsm_t(af, a + (k0 + (mi >> 1) * 8 + rr) * lda + m0 + (mi & 1) * 8);
    else
      ldsm(af, a + (m0 + (mi & 1) * 8 + rr) * lda + k0 + (mi >> 1) * 8);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      const int n = n0 + 16 * np;
      uint32_t bq[4];
      if (B_T)
        ldsm_t(bq, b + (k0 + (mi & 1) * 8 + rr) * ldb + n + (mi >> 1) * 8);
      else
        ldsm(bq, b + (n + (mi >> 1) * 8 + rr) * ldb + k0 + (mi & 1) * 8);
      mma(acc[2 * np], af, bq[0], bq[1]);
      mma(acc[2 * np + 1], af, bq[2], bq[3]);
    }
  }
}

// rows [r0, r0 + BLK) of a (rows, W) f32 matrix (row stride rs, 8-byte
// aligned rows), each times exp(cs[row]) where cs is given, into hi and lo
// planes of a padded bf16 tile, zero past row `rows`
template <int W>
__device__ __forceinline__ void load_split(bf16* tile, const float* src, long long rs,
                                           int r0, int rows, const float* cs = nullptr) {
  for (int e = 2 * threadIdx.x; e < BLK * W; e += 2 * THREADS) {
    const int r = e / W, c = e % W;
    float2 v = make_float2(0.f, 0.f);
    if (r0 + r < rows) {
      v = *reinterpret_cast<const float2*>(src + (r0 + r) * rs + c);
      if (cs) {
        const float ex = expf(cs[r0 + r]);
        v = make_float2(v.x * ex, v.y * ex);
      }
    }
    store_split(tile, BLK * (W + PAD), r * (W + PAD) + c, v.x, v.y);
  }
}

// Phase 1 on the tensor cores (the chunk kernel's route): dstate =
// (exp(cs) dy)^T C, dy's exp(cs_i) dy_i as two bf16 planes against exact C,
// 64 rows of the chunk at a time; a warp owns a 16-row tile of the state
// and DS / (8 / (HD / 16)) of its columns.
template <int HD, int DS>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dstate_tc_kernel(const float* __restrict__ dy, const float* __restrict__ dt,
                         const float* __restrict__ A, const bf16* __restrict__ Cm,
                         float* __restrict__ dstate, float* __restrict__ totals, int S,
                         int nh, int L, Strides st, bool vec) {
  constexpr int LDX = HD + PAD, LDS = DS + PAD, PX = BLK * LDX;
  constexpr int RT = HD / 16, CW = DS / (8 / RT), NP = CW / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* c_s = reinterpret_cast<bf16*>(smem_raw);  // (BLK, LDS) C_i
  bf16* dy_s = c_s + BLK * LDS;                    // 2 x (BLK, LDX) exp(cs_i) dy_i
  float* dt_s = reinterpret_cast<float*>(dy_s + 2 * PX);
  float* cs_s = dt_s + kMaxL;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int s0 = c * L, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp % RT, n0 = (warp / RT) * CW;
  chunk_cumsum(dt, A[b * st.ab + h], dt_s, cs_s, b, h, s0, L, st);
  const long long bhc = (static_cast<long long>(b) * nh + h) * nc + c;
  if (threadIdx.x == 0) totals[bhc] = cs_s[L - 1];
  const long long dys = static_cast<long long>(nh) * HD;
  const float* dyc = dy + (static_cast<long long>(b) * S + s0) * dys + h * HD;
  const bf16* cc = Cm + b * st.cb + s0 * st.cs;
  float acc[2 * NP][4] = {};
  for (int i0 = 0; i0 < L; i0 += BLK) {
    __syncthreads();
    load_tile<DS>(c_s, cc + i0 * st.cs, st.cs, L - i0, BLK, vec);
    cp_async_commit();
    load_split<HD>(dy_s, dyc, dys, i0, L, cs_s);
    cp_async_wait<0>();
    __syncthreads();
    warp_mma<BLK, NP, true, true>(acc, dy_s, LDX, c_s, LDS, 16 * mt, n0);
    warp_mma<BLK, NP, true, true>(acc, dy_s + PX, LDX, c_s, LDS, 16 * mt, n0);
  }
  float* out = dstate + bhc * HD * DS;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int t = 0; t < 2 * NP; ++t)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(out + (16 * mt + g + 8 * half) * DS + n0 + 8 * t + 2 * t4) =
          make_float2(acc[t][2 * half], acc[t][2 * half + 1]);
}

template <int HD, int DS>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const bf16* __restrict__ Bm,
                        const bf16* __restrict__ Cm, const float* __restrict__ hin,
                        const float* __restrict__ dy, const float* __restrict__ dHout,
                        bf16* __restrict__ dx, float* __restrict__ ddt,
                        float* __restrict__ dBp, float* __restrict__ dCp,
                        float* __restrict__ dAc, int S, int nh, int L, Strides st, bool vec) {
  constexpr int LDX = HD + PAD, LDS = DS + PAD, LDP = BLK + PAD;
  constexpr int PX = BLK * LDX, PP = BLK * LDP, PH = HD * LDS;  // plane sizes
  constexpr int NX = HD / 32, NS = DS / 32;  // 16-column pairs of a warp's half
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);  // (BLK, LDX) x_j
  bf16* b_s = x_s + PX;                            // (BLK, LDS) B_j
  bf16* c_s = b_s + BLK * LDS;                     // (BLK, LDS) C_i
  bf16* dy_s = c_s + BLK * LDS;                    // 2 x (BLK, LDX) dy_i, hi and lo
  bf16* m_s = dy_s + 2 * PX;                       // 2 x (BLK, LDP) M of the pair
  bf16* p_s = m_s + 2 * PP;                        // 2 x (BLK, LDP) P of the pair
  bf16* dh_s = p_s + 2 * PP;                       // 2 x (HD, LDS) dH_out
  bf16* hin_s = dh_s + 2 * PH;                     // 2 x (HD, LDS) h_in
  float* dt_s = reinterpret_cast<float*>(hin_s + 2 * PH);  // (kMaxL,) each
  float* cs_s = dt_s + kMaxL;
  float* w_s = cs_s + kMaxL;
  float* dcs_s = w_s + kMaxL;
  float* ddt_s = dcs_s + kMaxL;
  float* wu_s = ddt_s + kMaxL;
  float* colg_s = wu_s + kMaxL;     // (4, BLK) column sums of G, per row tile
  float* colq_s = colg_s + 4 * BLK; // (4, BLK) column sums of Q
  float* rowg_s = colq_s + 4 * BLK; // (2, BLK) row sums per column half: u's
                                    // at a j block's start, then G's
  float* sum_s = rowg_s + 2 * BLK;  // (THREADS,) shares of <dH_out, h_in>

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int s0 = c * L, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp & 3, nq = warp >> 2;  // the warp's 16-row tile, column half
  const int r0 = 16 * mt + g;               // its rows r0 and r0 + 8 of a block
  const float a = A[b * st.ab + h];
  const long long bhc = (static_cast<long long>(b) * nh + h) * nc + c;
  float dot = 0.f;
  for (int e = 2 * tid; e < HD * DS; e += 2 * THREADS) {
    const float2 hv = *reinterpret_cast<const float2*>(hin + bhc * HD * DS + e);
    const float2 gv = *reinterpret_cast<const float2*>(dHout + bhc * HD * DS + e);
    const int at = (e / DS) * LDS + e % DS;
    store_split(hin_s, PH, at, hv.x, hv.y);
    store_split(dh_s, PH, at, gv.x, gv.y);
    dot = fmaf(gv.x, hv.x, fmaf(gv.y, hv.y, dot));
  }
  sum_s[tid] = dot;
  chunk_cumsum(dt, a, dt_s, cs_s, b, h, s0, L, st);
  const float total = cs_s[L - 1];
  for (int t = tid; t < L; t += THREADS) {
    w_s[t] = expf(total - cs_s[t]) * dt_s[t];
    dcs_s[t] = 0.f;
    ddt_s[t] = 0.f;
  }

  const bf16* xc = x + b * st.xb + s0 * st.xs + h * st.xh;
  const bf16* bc = Bm + b * st.bb + s0 * st.bs;
  const bf16* cc = Cm + b * st.cb + s0 * st.cs;
  const long long dys = static_cast<long long>(nh) * HD;  // dy's and dx's row stride
  const float* dyc = dy + (static_cast<long long>(b) * S + s0) * dys + h * HD;
  bf16* dxc = dx + (static_cast<long long>(b) * S + s0) * dys + h * HD;
  const long long poff = ((static_cast<long long>(b) * nh + h) * S + s0) * DS;
  float* dbp = dBp + poff;
  float* dcp = dCp + poff;
  const int xn0 = nq * HD / 2, sn0 = nq * DS / 2;  // the warp's first columns
  const int nb = (L + BLK - 1) / BLK;
  for (int jb = 0; jb < nb; ++jb) {
    const int j0 = jb * BLK;
    __syncthreads();
    load_tile<HD>(x_s, xc + j0 * st.xs, st.xs, L - j0, BLK, vec);
    load_tile<DS>(b_s, bc + j0 * st.bs, st.bs, L - j0, BLK, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // the leaving state's terms of rows j: dx_j = w_j dH_out B_j,
    // dB_j = w_j dH_out^T x_j, u_j = B_j . dH_out^T x_j
    float dxa[2 * NX][4] = {}, dba[2 * NS][4] = {};
    warp_mma<DS, NX, false, false>(dxa, b_s, LDS, dh_s, LDS, 16 * mt, xn0);
    warp_mma<DS, NX, false, false>(dxa, b_s, LDS, dh_s + PH, LDS, 16 * mt, xn0);
    warp_mma<HD, NS, false, true>(dba, x_s, LDX, dh_s, LDS, 16 * mt, sn0);
    warp_mma<HD, NS, false, true>(dba, x_s, LDX, dh_s + PH, LDS, 16 * mt, sn0);
    float u[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 2 * NS; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 bv = unpack(*reinterpret_cast<const uint32_t*>(
            b_s + (r0 + 8 * half) * LDS + sn0 + 8 * t + 2 * t4));
        u[half] = fmaf(dba[t][2 * half], bv.x, fmaf(dba[t][2 * half + 1], bv.y, u[half]));
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      u[half] += __shfl_xor_sync(0xffffffffu, u[half], 1);
      u[half] += __shfl_xor_sync(0xffffffffu, u[half], 2);
      if (t4 == 0) rowg_s[nq * BLK + r0 + 8 * half] = u[half];
      const int j = j0 + r0 + 8 * half;
      const float wj = j < L ? w_s[j] : 0.f;
#pragma unroll
      for (int t = 0; t < 2 * NX; ++t) {
        dxa[t][2 * half] *= wj;
        dxa[t][2 * half + 1] *= wj;
      }
#pragma unroll
      for (int t = 0; t < 2 * NS; ++t) {
        dba[t][2 * half] *= wj;
        dba[t][2 * half + 1] *= wj;
      }
    }
    __syncthreads();
    if (tid < BLK && j0 + tid < L) {
      const int j = j0 + tid;
      const float uj = rowg_s[tid] + rowg_s[BLK + tid];
      wu_s[j] = w_s[j] * uj;
      dcs_s[j] -= w_s[j] * uj;
      ddt_s[j] += expf(total - cs_s[j]) * uj;
    }

    for (int ib = jb; ib < nb; ++ib) {
      const int i0 = ib * BLK;
      __syncthreads();
      load_tile<DS>(c_s, cc + i0 * st.cs, st.cs, L - i0, BLK, vec);
      cp_async_commit();
      load_split<HD>(dy_s, dyc, dys, i0, L);
      cp_async_wait<0>();
      __syncthreads();
      float rowg[2] = {0.f, 0.f};
      float dca[2 * NS][4] = {};
      if (jb == 0) {
        // the entering state's terms of rows i, first: dC_i = exp(cs_i)
        // h_in^T dy_i, and exp(cs_i) C_i . h_in^T dy_i to dcs_i
        warp_mma<HD, NS, false, true>(dca, dy_s, LDX, hin_s, LDS, 16 * mt, sn0);
        warp_mma<HD, NS, false, true>(dca, dy_s, LDX, hin_s + PH, LDS, 16 * mt, sn0);
        warp_mma<HD, NS, false, true>(dca, dy_s + PX, LDX, hin_s, LDS, 16 * mt, sn0);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + r0 + 8 * half;
          const float ei = i < L ? expf(cs_s[i]) : 0.f;
#pragma unroll
          for (int t = 0; t < 2 * NS; ++t) {
            const float2 cv = unpack(*reinterpret_cast<const uint32_t*>(
                c_s + (r0 + 8 * half) * LDS + sn0 + 8 * t + 2 * t4));
            dca[t][2 * half] *= ei;
            dca[t][2 * half + 1] *= ei;
            rowg[half] = fmaf(dca[t][2 * half], cv.x,
                              fmaf(dca[t][2 * half + 1], cv.y, rowg[half]));
          }
        }
      } else {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + r0 + 8 * half;
          if (i < L) {
#pragma unroll
            for (int t = 0; t < 2 * NS; ++t) {
              const float2 v = *reinterpret_cast<const float2*>(
                  dcp + static_cast<long long>(i) * DS + sn0 + 8 * t + 2 * t4);
              dca[t][2 * half] = v.x;
              dca[t][2 * half + 1] = v.y;
            }
          }
        }
      }
      // CB and dM of the block pair (16 rows x 32 columns a warp), then M,
      // P, G = dM M and Q = dM CB decay, masked before exp
      float sc[4][4] = {}, dm[4][4] = {};
      warp_mma<DS, 2, false, false>(sc, c_s, LDS, b_s, LDS, 16 * mt, 32 * nq);
      warp_mma<HD, 2, false, false>(dm, dy_s, LDX, x_s, LDX, 16 * mt, 32 * nq);
      warp_mma<HD, 2, false, false>(dm, dy_s + PX, LDX, x_s, LDX, 16 * mt, 32 * nq);
      float colg[4][2] = {}, colq[4][2] = {};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int il = r0 + 8 * half, i = i0 + il;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int jl = 32 * nq + 8 * t + 2 * t4;
          float mv[2], pv[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int j = j0 + jl + k;
            const bool on = j <= i && i < L;
            const float e = on ? expf(cs_s[i] - cs_s[j]) : 0.f;
            const float dtj = on ? dt_s[j] : 0.f;
            const float cbe = sc[t][2 * half + k] * e;
            const float qv = dm[t][2 * half + k] * cbe;
            const float gv = qv * dtj;
            mv[k] = cbe * dtj;
            pv[k] = dm[t][2 * half + k] * e * dtj;
            rowg[half] += gv;
            colg[t][k] += gv;
            colq[t][k] += qv;
          }
          store_split(m_s, PP, il * LDP + jl, mv[0], mv[1]);
          store_split(p_s, PP, il * LDP + jl, pv[0], pv[1]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        rowg[half] += __shfl_xor_sync(0xffffffffu, rowg[half], 1);
        rowg[half] += __shfl_xor_sync(0xffffffffu, rowg[half], 2);
        if (t4 == 0) rowg_s[nq * BLK + r0 + 8 * half] = rowg[half];
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            colg[t][k] += __shfl_xor_sync(0xffffffffu, colg[t][k], off);
            colq[t][k] += __shfl_xor_sync(0xffffffffu, colq[t][k], off);
          }
          if (g == 0) {
            colg_s[mt * BLK + 32 * nq + 8 * t + 2 * t4 + k] = colg[t][k];
            colq_s[mt * BLK + 32 * nq + 8 * t + 2 * t4 + k] = colq[t][k];
          }
        }
      __syncthreads();
      if (tid < BLK) {  // row i0 + tid's sums in, then column j0 + tid's out
        if (i0 + tid < L) dcs_s[i0 + tid] += rowg_s[tid] + rowg_s[BLK + tid];
        if (j0 + tid < L) {
          float sg = 0.f, sq = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            sg += colg_s[q * BLK + tid];
            sq += colq_s[q * BLK + tid];
          }
          dcs_s[j0 + tid] -= sg;
          ddt_s[j0 + tid] += sq;
        }
      }
      // dx_j += M^T dy_i (hi hi, hi lo, lo hi), dB_j += P^T C_i, dC_i += P B_j
      warp_mma<BLK, NX, true, true>(dxa, m_s, LDP, dy_s, LDX, 16 * mt, xn0);
      warp_mma<BLK, NX, true, true>(dxa, m_s, LDP, dy_s + PX, LDX, 16 * mt, xn0);
      warp_mma<BLK, NX, true, true>(dxa, m_s + PP, LDP, dy_s, LDX, 16 * mt, xn0);
      warp_mma<BLK, NS, true, true>(dba, p_s, LDP, c_s, LDS, 16 * mt, sn0);
      warp_mma<BLK, NS, true, true>(dba, p_s + PP, LDP, c_s, LDS, 16 * mt, sn0);
      warp_mma<BLK, NS, false, true>(dca, p_s, LDP, b_s, LDS, 16 * mt, sn0);
      warp_mma<BLK, NS, false, true>(dca, p_s + PP, LDP, b_s, LDS, 16 * mt, sn0);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = i0 + r0 + 8 * half;
        if (i < L) {
#pragma unroll
          for (int t = 0; t < 2 * NS; ++t)
            *reinterpret_cast<float2*>(dcp + static_cast<long long>(i) * DS + sn0 + 8 * t +
                                       2 * t4) = make_float2(dca[t][2 * half],
                                                             dca[t][2 * half + 1]);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = j0 + r0 + 8 * half;
      if (j < L) {
#pragma unroll
        for (int t = 0; t < 2 * NX; ++t)
          *reinterpret_cast<__nv_bfloat162*>(dxc + j * dys + xn0 + 8 * t + 2 * t4) =
              __floats2bfloat162_rn(dxa[t][2 * half], dxa[t][2 * half + 1]);
#pragma unroll
        for (int t = 0; t < 2 * NS; ++t)
          *reinterpret_cast<float2*>(dbp + static_cast<long long>(j) * DS + sn0 + 8 * t +
                                     2 * t4) = make_float2(dba[t][2 * half],
                                                           dba[t][2 * half + 1]);
      }
    }
  }
  __syncthreads();
  if (tid == 0) chunk_tail(sum_s, wu_s, dcs_s, ddt_s, dt_s, total, a, L, ddt, dAc,
                           bhc, b, S, s0, nh, h);
}

// Phase 4: dB and dC (b, s, n) summed over the heads in head order, in x's
// dtype; dA (b, h) summed over the chunks in order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_sum_kernel(const float* __restrict__ dBp, const float* __restrict__ dCp,
                   const float* __restrict__ dAc, T* __restrict__ dB, T* __restrict__ dC,
                   float* __restrict__ dA, int nh, int nc, long long N) {
  const int b = blockIdx.y;
  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (e < N) {
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < nh; ++h) {
      sb += dBp[(static_cast<long long>(b) * nh + h) * N + e];
      sc += dCp[(static_cast<long long>(b) * nh + h) * N + e];
    }
    store(dB + b * N + e, sb);
    store(dC + b * N + e, sc);
  }
  if (blockIdx.x == 0) {
    for (int h = threadIdx.x; h < nh; h += THREADS) {
      float s = 0.f;
      for (int c = 0; c < nc; ++c) s += dAc[(b * nh + h) * nc + c];
      dA[b * nh + h] = s;
    }
  }
}

template <int HD, int DS>
constexpr int dstate_smem(int L) {
  return 4 * (BLK * HD + BLK * (DS + 1) + 2 * L);
}

template <int HD, int DS>
constexpr int chunk_smem(int L) {
  return 4 * (2 * HD * (DS + 1) + 2 * BLK * (HD + 1) + 2 * BLK * (DS + 1) +
              2 * BLK * (BLK + 1) + 32 * BLK + 6 * L + THREADS);
}

template <int HD, int DS>
constexpr int dstate_tc_smem() {
  return 2 * (BLK * (DS + PAD) + 2 * BLK * (HD + PAD)) + 4 * 2 * kMaxL;
}

template <int HD, int DS>
constexpr int chunk_tc_smem() {
  return 2 * (3 * BLK * (HD + PAD) + 2 * BLK * (DS + PAD) + 4 * BLK * (BLK + PAD) +
              4 * HD * (DS + PAD)) + 4 * (6 * kMaxL + 10 * BLK + THREADS);
}

// Phase 1 on the tensor cores where phase 3 takes them (below), else FMA.
template <typename T, int HD, int DS>
cudaError_t launch_dstate(const float* dy, const float* dt, const float* A, const T* Cm,
                          float* dstate, float* totals, int Bb, int S, int nh, int L,
                          Strides st, bool vec, cudaStream_t stream) {
  const dim3 grid(S / L, nh, Bb);
  if constexpr (std::is_same_v<T, bf16> && DS >= 64) {
    if (L <= kMaxL) {
      static int cap[64];
      const cudaError_t err =
          allow_smem(ssd_bwd_dstate_tc_kernel<HD, DS>, dstate_tc_smem<HD, DS>(), cap);
      if (err != cudaSuccess) return err;
      ssd_bwd_dstate_tc_kernel<HD, DS><<<grid, THREADS, dstate_tc_smem<HD, DS>(), stream>>>(
          dy, dt, A, Cm, dstate, totals, S, nh, L, st, vec);
      return cudaSuccess;
    }
  }
  static int cap[64];
  const cudaError_t err = allow_smem(ssd_bwd_dstate_kernel<T, HD, DS>,
                                     dstate_smem<HD, DS>(L), cap);
  if (err != cudaSuccess) return err;
  ssd_bwd_dstate_kernel<T, HD, DS><<<grid, THREADS, dstate_smem<HD, DS>(L), stream>>>(
      dy, dt, A, Cm, dstate, totals, S, nh, L, st);
  return cudaSuccess;
}

// Phase 3 on the tensor cores where it takes the inputs: bf16, chunks of at
// most 256, d_state of at least 64 (a warp's half of the state's columns
// is whole 16-column ldmatrix tiles); else the FMA kernel. Returns the
// error of raising the kernel's shared memory cap, or cudaSuccess.
template <typename T, int HD, int DS>
cudaError_t launch_chunk(const T* x, const float* dt, const float* A, const T* Bm,
                         const T* Cm, const float* hin, const float* dy, const float* dHout,
                         T* dx, float* ddt, float* dBp, float* dCp, float* dAc, int Bb,
                         int S, int nh, int L, Strides st, bool vec, cudaStream_t stream) {
  const dim3 grid(S / L, nh, Bb);
  if constexpr (std::is_same_v<T, bf16> && DS >= 64) {
    if (L <= kMaxL) {
      static int cap[64];
      const cudaError_t err =
          allow_smem(ssd_bwd_chunk_tc_kernel<HD, DS>, chunk_tc_smem<HD, DS>(), cap);
      if (err != cudaSuccess) return err;
      ssd_bwd_chunk_tc_kernel<HD, DS><<<grid, THREADS, chunk_tc_smem<HD, DS>(), stream>>>(
          x, dt, A, Bm, Cm, hin, dy, dHout, dx, ddt, dBp, dCp, dAc, S, nh, L, st, vec);
      return cudaSuccess;
    }
  }
  static int cap[64];
  const cudaError_t err = allow_smem(ssd_bwd_chunk_kernel<T, HD, DS>, chunk_smem<HD, DS>(L),
                                     cap);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<T, HD, DS><<<grid, THREADS, chunk_smem<HD, DS>(L), stream>>>(
      x, dt, A, Bm, Cm, hin, dy, dHout, dx, ddt, dBp, dCp, dAc, S, nh, L, st);
  return cudaSuccess;
}

// Floats of the workspace (the wrapper allocates it): each chunk's own
// state term, then its dH_out (Bb, nh, nc, HD, DS); the chunk totals and
// dA partials (Bb, nh, nc) each; the per-head dB and dC (Bb, nh, S, DS)
long long workspace_floats(int Bb, int S, int nh, int hd, int ds, int L) {
  const long long nc = S / L, bh = static_cast<long long>(Bb) * nh;
  return bh * nc * hd * ds + 2 * bh * nc + 2 * bh * S * ds;
}

template <typename T, int HD, int DS>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const float* hin, const float* dy, const float* dhf, void* dx, float* ddt,
           float* dA, void* dB, void* dC, float* dh0, float* ws, int Bb, int S, int nh,
           int L, Strides st, bool vec, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  const int nc = S / L;
  const long long bh = static_cast<long long>(Bb) * nh;
  float* dstate = ws;
  float* totals = dstate + bh * nc * HD * DS;
  float* dAc = totals + bh * nc;
  float* dBp = dAc + bh * nc;
  float* dCp = dBp + bh * S * DS;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  err = launch_dstate<T, HD, DS>(dy, dt, A, ct, dstate, totals, Bb, S, nh, L, st, vec,
                                 stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int E = HD * DS;
  ssd_bwd_pass_kernel<<<dim3((E + 4 * THREADS - 1) / (4 * THREADS), nh, Bb), THREADS, 0,
                        stream>>>(dhf, dstate, totals, dh0, nc, E);
  err = launch_chunk<T, HD, DS>(xt, dt, A, bt, ct, hin, dy, dstate, static_cast<T*>(dx),
                                ddt, dBp, dCp, dAc, Bb, S, nh, L, st, vec, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long N = static_cast<long long>(S) * DS;
  ssd_bwd_sum_kernel<T><<<dim3(static_cast<unsigned>((N + THREADS - 1) / THREADS), Bb),
                          THREADS, 0, stream>>>(dBp, dCp, dAc, static_cast<T*>(dB),
                                                static_cast<T*>(dC), dA, nh, nc, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of workspace `ssd_scan_bwd_launch` needs.
long long ssd_scan_bwd_workspace(int Bb, int S, int nh, int hd, int ds, int L) {
  return workspace_floats(Bb, S, nh, hd, ds, L);
}

// The inputs as ssd_scan_launch takes them (x, B, C f32 or bf16 by
// `dtype`, through `strides`, the eleven of Strides; A (nh,) or (Bb, nh)),
// hin the forward's entering states (Bb, nh, S / L, hd, ds), dy
// (Bb, S, nh, hd) and dhf (Bb, nh, hd, ds, or null: zeros), f32 contiguous
// and 16-byte aligned. Writes dx (Bb, S, nh, hd), dB and dC (Bb, S, ds) in
// x's dtype, ddt (Bb, S, nh), dA (Bb, nh: each batch row's part) and dh0
// (Bb, nh, hd, ds) in f32, all contiguous. `ws` is ssd_scan_bwd_workspace
// floats; `vec` says every row of x, B and C is 16-byte aligned. Launches
// on `stream` and does not synchronise; returns the launch error, or 0.
int ssd_scan_bwd_launch(const void* x, const float* dt, const float* A, const void* Bm,
                        const void* Cm, const float* hin, const float* dy, const float* dhf,
                        void* dx, float* ddt, float* dA, void* dB, void* dC, float* dh0,
                        float* ws, int Bb, int S, int nh, int hd, int ds, int L,
                        const long long* strides, int dtype, int vec, cudaStream_t stream) {
  Strides st{strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
             strides[6], strides[7], strides[8], strides[9], strides[10]};
#define SSD_BWD_CASE(T_, HD_, DS_)                                                      \
  if (hd == HD_ && ds == DS_)                                                           \
    return launch<T_, HD_, DS_>(x, dt, A, Bm, Cm, hin, dy, dhf, dx, ddt, dA, dB, dC, dh0, \
                                ws, Bb, S, nh, L, st, vec != 0, stream);
#define SSD_BWD_SHAPES(T_)  \
  SSD_BWD_CASE(T_, 32, 16)  \
  SSD_BWD_CASE(T_, 32, 64)  \
  SSD_BWD_CASE(T_, 32, 128) \
  SSD_BWD_CASE(T_, 64, 16)  \
  SSD_BWD_CASE(T_, 64, 64)  \
  SSD_BWD_CASE(T_, 64, 128)
  if (dtype == 0) {
    SSD_BWD_SHAPES(float)
  } else if (dtype == 1) {
    SSD_BWD_SHAPES(bf16)
  }
#undef SSD_BWD_SHAPES
#undef SSD_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
