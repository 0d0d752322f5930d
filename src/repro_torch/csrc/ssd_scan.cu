// ssd_scan: the Mamba2 SSD chunked scan (Hopper, sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel), and computes the function of src/repro/models/ssm.py::
// ssd_chunked: for each (batch, head) and each chunk of L steps in order,
//   y_i = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j + exp(cs_i) C_i . h
//   h  <- exp(cs_L) h + sum_j exp(cs_L - cs_j) dt_j x_j (x) B_j
// with cs the inclusive cumsum of dt * A inside the chunk and h the carried
// (hd, ds) f32 state, from h0 (or zeros). y and the final h are written in
// f32; x, B and C are read as f32 or bf16, through strides (the last dim
// contiguous), so the model's slices of its conv output go in with no copy.
//
// bf16 inputs, chunks of at most 256 (the model's route): four kernels on
// the caller's stream, the chunked SSD decomposition.
//  1. ssd_cb_kernel, per (b, chunk, 64 x 64 block at or below the
//     diagonal): CB = C B^T once for all heads (B and C have no head axis).
//  2. ssd_state_kernel, per (b, head, chunk): the chunk's cumsum and total
//     decay, and its own state sum_j w_j x_j (x) B_j, w_j = exp(cs_L -
//     cs_j) dt_j.
//  3. ssd_pass_kernel, per (b, head, 1024 state elements): the chunks in
//     order, h_c = exp(total_c) h_{c-1} + state_c; writes the state
//     entering each chunk as bf16 terms (phase 4's operand) and h_final.
//  4. ssd_out_kernel, per (b, head, chunk): y = (CB o decay o dt o causal
//     mask) x + exp(cs_i) C h_in^T; the heads of one (b, chunk) run side by
//     side, so their shared CB tile is read from L2.
// Every product runs on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate) from ldmatrix fragments of padded shared tiles. One operand
// of each product is an exact bf16 input (x, B or C); the other (w x, the
// decayed scores, h_in) is f32 and goes in as kTerms = 2 bf16 terms (the
// value rounded, then the remainder rounded), each its own product into
// the same f32 accumulator: 16 bits of mantissa, where one term (8 bits)
// or TF32 (11) misses the f32 tolerance of 1e-4. The cumsum is a fixed-
// order warp scan, run by phases 2 and 4 on the same inputs. No atomics.
//
// Bound on the H100 at mamba2-370m's prefill shape (B, S, nh, hd, ds) =
// (4, 2048, 32, 64, 128), L = 256: 0.27 GFLOP for CB^T and 12.9 GFLOP for
// the three products per (b, head, chunk), these twice for the two terms,
// is 26 GFLOP of tensor-core work (26 us at 989 TFLOP/s); the inputs and
// outputs are 110 MB (33 us at 3.35 TB/s): bound by bytes. The schedule's
// workspace adds 151 MB of traffic (the chunk states written and read, the
// entering states' bf16 terms written and read, CB written and read): 78 us
// for the 261 MB.
// The FMA route's schedule would need 21.5 GFLOP of f32 FMA work (0.32 ms
// at 67 TFLOP/s). Phases 2 and 4 run 1024 CTAs each over the 132 SMs; the
// C fragments of phase 4 come from L2, so two of its CTAs fit on an SM.
//
// f32 inputs (and bf16 chunks longer than 256): ssd_fma_kernel, one CTA
// per (batch, head) walking the chunks in order with the state in shared
// memory, the intra-chunk term in 64 x 64 sub-blocks at or below the
// diagonal, every product an f32 FMA (f32 inputs are not exact in bf16,
// and the reference's f32 tolerance is 1e-4): bound by its 21.5 GFLOP of
// FMA work (0.32 ms at 67 TFLOP/s) at the shape above.
//
// For training, either route also writes the state entering each chunk in
// f32 (ssd_pass_kernel has it in registers, the FMA kernel in shared memory
// at the start of the chunk): ssd_scan_bwd.cu's input. A is (nh,) or, under
// a vmapped cohort whose clients each have their own A, one row per batch
// row, read through a batch stride. With no such output and an (nh,) A the
// kernels compute what they computed without them, bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mma_tiles.cuh"
#include "ssd_common.cuh"

namespace {

// The FMA route. One CTA per (batch, head) walks the chunks in order; the
// state stays in shared memory between chunks (hd x ds f32). Per 64-row
// i-block: C_i in shared memory; the carried-state term C_i h^T first;
// then for each j-block the scores S = C_i B_j^T, scaled by
// exp(cs_i - cs_j) dt_j (the exponential of a difference: exp(cs_i)
// exp(-cs_j) would overflow), masked to j <= i and multiplied into x_j.
// After the chunk's i-blocks, the state update walks the j-blocks once
// more. The cumsum runs in order on one thread. Each thread owns a
// 4 x (width / 16) register tile of a 16 x 16 thread grid; shared rows
// are padded by one float so column reads fall in distinct banks.
template <typename T, int HD, int DS>
__global__ void __launch_bounds__(THREADS)
ssd_fma_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ h0,
           float* __restrict__ y, float* __restrict__ hout, float* __restrict__ hin,
           int S, int nh, int L, Strides st) {
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
  const float a = A[b * st.ab + h];
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
    if (hin) {  // the state entering this chunk, for the backward
      float* out = hin + (hoff * (S / L) + static_cast<long long>(s0 / L) * HD * DS);
      for (int e = threadIdx.x; e < HD * DS; e += THREADS)
        out[e] = h_s[(e / DS) * LDS + e % DS];
    }
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

// ---------------------------------------------------------------------------
// The tensor-core route (bf16 x, B and C; chunks of at most 256 steps)
// ---------------------------------------------------------------------------

constexpr int kTerms = 2;   // bf16 terms an f32 operand is split into
// (v0, v1) as kTerms bf16 pairs whose sum is (v0, v1) to 8 * kTerms bits:
// each term is the remainder of the ones before, rounded to bf16
__device__ __forceinline__ void split(float v0, float v1, uint32_t (&a)[kTerms][4],
                                      int reg) {
#pragma unroll
  for (int t = 0; t < kTerms; ++t) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    a[t][reg] = pack(h);
    const float2 f = __bfloat1622float2(h);
    v0 -= f.x;  // exact: f is v rounded
    v1 -= f.y;
  }
}

// two adjacent bf16 of a row as one 32-bit fragment register (low half the
// first); one 4-byte load where the rows are aligned
__device__ __forceinline__ uint32_t load_pair(const bf16* p, bool vec) {
  if (vec) return *reinterpret_cast<const uint32_t*>(p);
  return pack(__halves2bfloat162(p[0], p[1]));
}

// dt of (b, h, chunk) into dt_s (zero past L), then its cumsum into cs_s
__device__ __forceinline__ void chunk_decay(const float* dt, float a, float* dt_s,
                                            float* cs_s, float* warp_tot, int b,
                                            int h, int s0, int L, const Strides& st) {
  const int t = threadIdx.x;
  dt_s[t] = t < L ? dt[b * st.db + (s0 + t) * st.ds + h * st.dh] : 0.f;
  __syncthreads();
  chunk_cumsum(dt_s, a, cs_s, warp_tot, L);
}

// Phase 2, per (b, head, chunk): the chunk's own state contribution
// state[p][n] = sum_j w_j x_j[p] B_j[n], w_j = exp(cs_L - cs_j) dt_j, an
// (HD x L) . (L x DS) product whose f32 operand w x is split into kTerms
// bf16 terms; also the chunk's total decay cs_L.
template <int HD, int DS>
__global__ void __launch_bounds__(THREADS)
ssd_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm,
                 float* __restrict__ states, float* __restrict__ totals, int nh,
                 int L, Strides st, bool vec) {
  constexpr int LDX = HD + PAD, LDB = DS + PAD;
  constexpr int NT = DS >= 64 ? 8 : DS / 8;          // n-tiles of a unit
  constexpr int UNITS = (HD / 16) * (DS / (8 * NT));  // (16 x 8 NT) units
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int LP = (L + 15) & ~15;
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);  // (LP, LDX)
  bf16* b_s = x_s + LP * LDX;                      // (LP, LDB)
  float* dt_s = reinterpret_cast<float*>(b_s + LP * LDB);
  float* cs_s = dt_s + THREADS;
  float* w_s = cs_s + THREADS;
  float* warp_tot = w_s + THREADS;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int s0 = c * L, t = threadIdx.x;
  load_tile<HD>(x_s, x + b * st.xb + s0 * st.xs + h * st.xh, st.xs, L, LP, vec);
  load_tile<DS>(b_s, Bm + b * st.bb + s0 * st.bs, st.bs, L, LP, vec);
  chunk_decay(dt, A[b * st.ab + h], dt_s, cs_s, warp_tot, b, h, s0, L, st);
  const float total = cs_s[L - 1];
  w_s[t] = t < L ? expf(total - cs_s[t]) * dt_s[t] : 0.f;
  if (t == 0) totals[(b * nh + h) * nc + c] = total;
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = t >> 5, lane = t & 31;
  const int mi = lane >> 3, rr = lane & 7, g = lane >> 2, t4 = lane & 3;
  float* out = states + ((static_cast<long long>(b) * nh + h) * nc + c) * HD * DS;
  for (int u = warp; u < UNITS; u += THREADS / 32) {
    const int p0 = 16 * (u % (HD / 16)), n0 = 8 * NT * (u / (HD / 16));
    float acc[NT][4] = {};
    for (int j0 = 0; j0 < LP; j0 += 16) {
      // A[p][j] = w_j x_j[p]: x stored (j, p), so the fragments come transposed
      uint32_t xr[4], a[kTerms][4];
      ldsm_t(xr, x_s + (j0 + (mi >> 1) * 8 + rr) * LDX + p0 + (mi & 1) * 8);
      const float w0 = w_s[j0 + 2 * t4], w1 = w_s[j0 + 2 * t4 + 1];
      const float w8 = w_s[j0 + 8 + 2 * t4], w9 = w_s[j0 + 9 + 2 * t4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 f = unpack(xr[r]);
        split(f.x * (r < 2 ? w0 : w8), f.y * (r < 2 ? w1 : w9), a, r);
      }
#pragma unroll
      for (int q = 0; q < NT; q += 2) {
        uint32_t bq[4];  // B[j][n] stored (j, n): transposed fragments
        ldsm_t(bq, b_s + (j0 + (mi & 1) * 8 + rr) * LDB + n0 + 8 * q + (mi >> 1) * 8);
#pragma unroll
        for (int term = 0; term < kTerms; ++term) {
          mma(acc[q], a[term], bq[0], bq[1]);
          mma(acc[q + 1], a[term], bq[2], bq[3]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const int n = n0 + 8 * q + 2 * t4;
      *reinterpret_cast<float2*>(out + (p0 + g) * DS + n) = make_float2(acc[q][0], acc[q][1]);
      *reinterpret_cast<float2*>(out + (p0 + g + 8) * DS + n) =
          make_float2(acc[q][2], acc[q][3]);
    }
  }
}

// Phase 3, per (b, head, 1024 state elements): the chunks in order,
// h_c = exp(total_c) h_{c-1} + state_c from h0 (or zeros). Writes the state
// entering each chunk, split into kTerms bf16 planes (the B operand of
// phase 4's C h_in^T), and h_final. The chunks' states are read 8 at a time,
// all in flight.
__global__ void __launch_bounds__(THREADS)
ssd_pass_kernel(const float* __restrict__ h0, const float* __restrict__ states,
                const float* __restrict__ totals, bf16* __restrict__ hsplit,
                float* __restrict__ hout, float* __restrict__ hin, int nc, int E) {
  const long long bh = static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int e = (blockIdx.x * THREADS + threadIdx.x) * 4;
  if (e >= E) return;
  float4 hv = h0 ? *reinterpret_cast<const float4*>(h0 + bh * E + e)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float4 sv[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c0 + k < nc)
        sv[k] = *reinterpret_cast<const float4*>(states + (bh * nc + c0 + k) * E + e);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c0 + k >= nc) break;
      uint32_t p01[kTerms][4], p23[kTerms][4];  // elements e, e + 1 and e + 2, e + 3
      split(hv.x, hv.y, p01, 0);
      split(hv.z, hv.w, p23, 0);
      bf16* out = hsplit + (bh * nc + c0 + k) * kTerms * E + e;
#pragma unroll
      for (int term = 0; term < kTerms; ++term)
        *reinterpret_cast<uint2*>(out + term * E) = make_uint2(p01[term][0], p23[term][0]);
      if (hin) *reinterpret_cast<float4*>(hin + (bh * nc + c0 + k) * E + e) = hv;
      const float d = expf(totals[bh * nc + c0 + k]);
      const float4 st = sv[k];
      hv = make_float4(d * hv.x + st.x, d * hv.y + st.y, d * hv.z + st.z,
                       d * hv.w + st.w);
    }
  }
  *reinterpret_cast<float4*>(hout + bh * E + e) = hv;
}

// CB at the A-fragment places of rows ia, ib (ib = ia + 8) and the 16
// columns from j0: (ia, j0 + 2 t4 ..), (ib, ..), (ia, j0 + 8 + 2 t4 ..),
// (ib, ..), zero where j > i or i >= L (never read there)
__device__ __forceinline__ void load_scores(float2 (&v)[4], const float* cbc, int ldc,
                                            int ia, int ib, int j0, int L) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int reg = 0; reg < 4; ++reg) {
    const int i = (reg & 1) ? ib : ia;
    const int j = j0 + 2 * t4 + ((reg & 2) ? 8 : 0);
    v[reg] = (j <= i && i < L) ? *reinterpret_cast<const float2*>(cbc + i * ldc + j)
                               : make_float2(0.f, 0.f);
  }
}

// Phase 4, per (b, head, chunk), the heads of one (b, chunk) side by side
// so that they share its CB tile in L2:
//   y_i = exp(cs_i) C_i . h_in^T + sum_{j <= i} CB_ij exp(cs_i - cs_j) dt_j x_j
// Both products on the tensor cores, their f32 operand (h_in; the decayed
// scores) split into kTerms bf16 terms. Warp w takes the 16-row tiles w and
// 15 - w, so that the causal work is even across warps. C's fragments come
// straight from global memory (L2: the 32 heads share them), so the shared
// tiles are x and h_in only and two CTAs fit on an SM.
template <int HD, int DS>
__global__ void __launch_bounds__(THREADS)
ssd_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const bf16* __restrict__ Cm,
               const float* __restrict__ cb, const bf16* __restrict__ hsplit,
               float* __restrict__ y, int S, int L, int ldc, Strides st, bool vec) {
  constexpr int LDX = HD + PAD, LDH = DS + PAD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int LP = (L + 15) & ~15;
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);  // (LP, LDX)
  bf16* h_s = x_s + LP * LDX;                      // kTerms x (HD, LDH)
  float* dt_s = reinterpret_cast<float*>(h_s + kTerms * HD * LDH);
  float* cs_s = dt_s + THREADS;
  float* warp_tot = cs_s + THREADS;

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nh = gridDim.x, nc = gridDim.y;
  const int s0 = c * L, t = threadIdx.x;
  load_tile<HD>(x_s, x + b * st.xb + s0 * st.xs + h * st.xh, st.xs, L, LP, vec);
  const bf16* hin = hsplit + ((static_cast<long long>(b) * nh + h) * nc + c) * kTerms * HD * DS;
#pragma unroll
  for (int term = 0; term < kTerms; ++term)
    load_tile<DS>(h_s + term * HD * LDH, hin + term * HD * DS, DS, HD, HD, true);
  const int warp = t >> 5, lane = t & 31;
  const int mi = lane >> 3, rr = lane & 7, g = lane >> 2, t4 = lane & 3;
  const float* cbc = cb + static_cast<long long>(b * nc + c) * L * ldc;
  const bf16* cc = Cm + b * st.cb + s0 * st.cs;
  // C's A fragments of the 16-row tile r for every k-step, all in flight
  uint32_t ca[DS / 16][4];
  auto load_c = [&](int r) {
#pragma unroll
    for (int kk = 0; kk < DS / 16; ++kk)
#pragma unroll
      for (int reg = 0; reg < 4; ++reg) {
        const int i = 16 * r + g + ((reg & 1) ? 8 : 0);
        ca[kk][reg] = i < L ? load_pair(cc + i * st.cs + 16 * kk + 2 * t4 + ((reg & 2) ? 8 : 0),
                                        vec)
                            : 0u;
      }
  };
  load_c(warp);  // the first tile's, while the shared tiles land
  chunk_decay(dt, A[b * st.ab + h], dt_s, cs_s, warp_tot, b, h, s0, L, st);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll 1
  for (int rep = 0; rep < 2; ++rep) {
    const int r = rep == 0 ? warp : 15 - warp;  // this warp's 16-row tile
    if (16 * r >= LP) continue;
    if (rep == 1) load_c(r);
    const int i0 = 16 * r, ia = i0 + g, ib = ia + 8;
    float acc[HD / 8][4] = {};
    // the carried state: C_i . h_in^T, h_in stored (p, n): no transpose
#pragma unroll
    for (int kk = 0; kk < DS / 16; ++kk) {
#pragma unroll
      for (int term = 0; term < kTerms; ++term) {
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bq[4];
          ldsm(bq, h_s + term * HD * LDH + (16 * np + (mi >> 1) * 8 + rr) * LDH +
                       16 * kk + (mi & 1) * 8);
          mma(acc[2 * np], ca[kk], bq[0], bq[1]);
          mma(acc[2 * np + 1], ca[kk], bq[2], bq[3]);
        }
      }
    }
    const float csa = cs_s[ia], csb = cs_s[ib];
    const float ea = expf(csa), eb = expf(csb);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= ea;
      acc[n][1] *= ea;
      acc[n][2] *= eb;
      acc[n][3] *= eb;
    }
    // the chunk's own steps j <= i, 16 at a time up to the diagonal; the
    // scores of the next step are loaded while this one's are multiplied
    float2 nxt[4];
    load_scores(nxt, cbc, ldc, ia, ib, 0, L);
    for (int j0 = 0; j0 <= i0; j0 += 16) {
      float2 cur[4];
#pragma unroll
      for (int reg = 0; reg < 4; ++reg) cur[reg] = nxt[reg];
      if (j0 + 16 <= i0) load_scores(nxt, cbc, ldc, ia, ib, j0 + 16, L);
      uint32_t a[kTerms][4];
#pragma unroll
      for (int reg = 0; reg < 4; ++reg) {
        const int i = (reg & 1) ? ib : ia;
        const int j = j0 + 2 * t4 + ((reg & 2) ? 8 : 0);
        const float csi = (reg & 1) ? csb : csa;
        const float v0 = j <= i ? cur[reg].x * expf(csi - cs_s[j]) * dt_s[j] : 0.f;
        const float v1 = j + 1 <= i ? cur[reg].y * expf(csi - cs_s[j + 1]) * dt_s[j + 1] : 0.f;
        split(v0, v1, a, reg);
      }
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bq[4];  // x stored (j, p): transposed fragments
        ldsm_t(bq, x_s + (j0 + (mi & 1) * 8 + rr) * LDX + 16 * np + (mi >> 1) * 8);
#pragma unroll
        for (int term = 0; term < kTerms; ++term) {
          mma(acc[2 * np], a[term], bq[0], bq[1]);
          mma(acc[2 * np + 1], a[term], bq[2], bq[3]);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = half ? ib : ia;
      if (i >= L) continue;
      float* yrow = y + ((static_cast<long long>(b) * S + s0 + i) * nh + h) * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<float2*>(yrow + 8 * n + 2 * t4) =
            make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
}

template <int HD, int DS>
constexpr int state_smem(int LP) {
  return LP * (HD + PAD) * 2 + LP * (DS + PAD) * 2 + (3 * THREADS + 8) * 4;
}

template <int HD, int DS>
constexpr int out_smem(int LP) {
  return LP * (HD + PAD) * 2 + kTerms * HD * (DS + PAD) * 2 + (2 * THREADS + 8) * 4;
}

// Floats of the tensor-core route's workspace (the wrapper allocates it):
// the per-chunk states (Bb, nh, nc, HD, DS) f32, the states entering each
// chunk as kTerms bf16 planes (Bb, nh, nc, kTerms, HD, DS), CB
// (Bb, nc, L, ldc) f32, the chunk totals (Bb, nh, nc) f32
long long workspace_floats(int Bb, int S, int nh, int hd, int ds, int L) {
  const long long nc = S / L, ldc = (L + 1) & ~1;
  const long long states = static_cast<long long>(Bb) * nh * nc * hd * ds;
  return states + states * kTerms / 2 + Bb * nc * L * ldc + Bb * nh * nc;
}

template <int HD, int DS>
int launch_tc(const bf16* x, const float* dt, const float* A, const bf16* Bm,
              const bf16* Cm, const float* h0, float* y, float* hout, float* hin,
              float* ws, int Bb, int S, int nh, int L, Strides st, bool vec,
              cudaStream_t stream) {
  static int cap_state[64], cap_out[64];
  const int nc = S / L, ldc = (L + 1) & ~1, LP = (L + 15) & ~15;
  cudaError_t err = allow_smem(ssd_state_kernel<HD, DS>, state_smem<HD, DS>(kMaxL),
                               cap_state);
  if (err == cudaSuccess)
    err = allow_smem(ssd_out_kernel<HD, DS>, out_smem<HD, DS>(kMaxL), cap_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_states = static_cast<long long>(Bb) * nh * nc * HD * DS;
  float* states = ws;
  bf16* hsplit = reinterpret_cast<bf16*>(states + n_states);
  float* cb = states + n_states + n_states * kTerms / 2;
  float* totals = cb + static_cast<long long>(Bb) * nc * L * ldc;
  const int nb = (L + 63) / 64;
  ssd_cb_kernel<DS><<<dim3(nb * (nb + 1) / 2, nc, Bb), THREADS, 0, stream>>>(
      Bm, Cm, cb, L, ldc, st, vec);
  ssd_state_kernel<HD, DS><<<dim3(nc, nh, Bb), THREADS, state_smem<HD, DS>(LP), stream>>>(
      x, dt, A, Bm, states, totals, nh, L, st, vec);
  constexpr int E = HD * DS;
  ssd_pass_kernel<<<dim3((E + 4 * THREADS - 1) / (4 * THREADS), nh, Bb), THREADS, 0,
                    stream>>>(h0, states, totals, hsplit, hout, hin, nc, E);
  ssd_out_kernel<HD, DS><<<dim3(nh, nc, Bb), THREADS, out_smem<HD, DS>(LP), stream>>>(
      x, dt, A, Cm, cb, hsplit, y, S, L, ldc, st, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int DS>
int launch_fma(const void* x, const float* dt, const float* A, const void* Bm,
               const void* Cm, const float* h0, float* y, float* hout, float* hin,
               int Bb, int S, int nh, int L, Strides st, cudaStream_t stream) {
  static int cap[64];
  const size_t smem = smem_bytes<HD, DS>(L);
  auto kernel = ssd_fma_kernel<T, HD, DS>;
  cudaError_t err = allow_smem(kernel, static_cast<int>(smem), cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(nh, Bb), THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), h0, y, hout, hin, S, nh, L, st);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int DS>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* h0, float* y, float* hout, float* hin,
           float* ws, int Bb, int S, int nh, int L, Strides st, int dtype, bool vec,
           cudaStream_t stream) {
  if (dtype == 0)
    return launch_fma<float, HD, DS>(x, dt, A, Bm, Cm, h0, y, hout, hin, Bb, S, nh, L, st,
                                     stream);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (L > kMaxL)
    return launch_fma<bf16, HD, DS>(x, dt, A, Bm, Cm, h0, y, hout, hin, Bb, S, nh, L, st,
                                    stream);
  return launch_tc<HD, DS>(static_cast<const bf16*>(x), dt, A,
                           static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
                           h0, y, hout, hin, ws, Bb, S, nh, L, st, vec, stream);
}

}  // namespace

extern "C" {

// Floats of workspace `ssd_scan_launch` needs (0: the route needs none).
long long ssd_scan_workspace(int Bb, int S, int nh, int hd, int ds, int L, int dtype) {
  return (dtype == 1 && L <= kMaxL) ? workspace_floats(Bb, S, nh, hd, ds, L) : 0;
}

// x (Bb, S, nh, hd), B/C (Bb, S, ds): f32 (dtype 0) or bf16 (dtype 1), the
// last dim contiguous; dt (Bb, S, nh) f32; A (nh,) or (Bb, nh) f32; h0
// (Bb, nh, hd, ds) f32 contiguous and 16-byte aligned, or null (zeros).
// Writes y (Bb, S, nh, hd) and hout (Bb, nh, hd, ds), f32 contiguous, and,
// where `hin` is not null, the state entering each chunk into hin
// (Bb, nh, S / L, hd, ds) f32 contiguous and 16-byte aligned (the
// backward's input). `strides` holds the eleven element strides of Strides
// (A's batch stride last: 0 for (nh,)); `vec` says every row of x, B and C
// is 16-byte aligned. `ws` is ssd_scan_workspace floats (or null if that is
// 0). Requires S % L == 0 (the wrapper checks). Launches on `stream` and
// does not synchronise; returns the launch error, or 0.
int ssd_scan_launch(const void* x, const float* dt, const float* A,
                    const void* Bm, const void* Cm, const float* h0, float* y,
                    float* hout, float* hin, float* ws, int Bb, int S, int nh, int hd,
                    int ds, int L, const long long* strides, int dtype, int vec,
                    cudaStream_t stream) {
  Strides st{strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
             strides[6], strides[7], strides[8], strides[9], strides[10]};
#define SSD_CASE(HD_, DS_)                                                            \
  if (hd == HD_ && ds == DS_)                                                         \
    return launch<HD_, DS_>(x, dt, A, Bm, Cm, h0, y, hout, hin, ws, Bb, S, nh, L, st, \
                            dtype, vec != 0, stream);
  SSD_CASE(32, 16)
  SSD_CASE(32, 64)
  SSD_CASE(32, 128)
  SSD_CASE(64, 16)
  SSD_CASE(64, 64)
  SSD_CASE(64, 128)
#undef SSD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
