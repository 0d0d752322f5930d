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
// once sum dt |a| over a chunk passes about 88; these kernels stay finite.
//
// bf16 x, B and C with chunks of at most 256 and d_state of at least 64 (the
// model's route) run seven kernels on the caller's stream, from one C call:
//  1. ssd_cb_kernel (ssd_common.cuh, the forward's): CB = C B^T once per
//     (b, chunk) for its causal 64 x 64 blocks, in f32, for all heads.
//  2. ssd_bwd_prep_kernel, per (b, head, chunk): the cumsum as the forward's
//     fixed-order warp scan (cs, in log2 units for the main kernels' ex2,
//     and dt into the workspace, 0 past L; the chunk total); dy read once and written as two bf16 planes (hi, lo) in
//     the swizzled 64-row images the main kernels bulk-copy, the next block's
//     rows in flight during this one's product; the chunk's own state term
//     (exp(cs) dy)^T C on wgmma (as C^T (exp(cs) dy), both operands
//     MN-major).
//  3. ssd_bwd_pass_kernel, per (b, head, 1024 state elements): the chunks in
//     reverse, dH_out of each written as two bf16 planes, h_in as two more,
//     <dH_out, h_in> as warp partials, and dh0.
//  4. ssd_bwd_jside_kernel (dK/dV's analogue in K4's backward): a work item
//     is (b, chunk, 64-row j block, group of 8 heads). Per head: the leaving
//     state's terms (dx_j = w_j dH_out B_j, dB_j += w_j dH_out^T x_j, u_j),
//     then the i blocks >= j: dM^T = x_j dy_i^T, M^T and P^T in registers,
//     d cs's and ddt's sums over i, dx_j += M^T dy_i, dB_j += P^T C_i. dx_j
//     goes out once a head; dB_j stays in f32 registers for the group and
//     goes out once an item, as the group's partial.
//  5. ssd_bwd_iside_kernel (dQ's analogue): a work item is (b, chunk, i
//     block, group). Per head: the entering state's R = exp(cs_i) dy_i h_in
//     into dC_i and C_i . R_i into d cs_i, then the j blocks <= i: dM = dy_i
//     x_j^T again, M from CB, P, G's row sums, dC_i += P B_j; dC_i in
//     registers for the group, out once an item.
//  6. ssd_bwd_tail_kernel, per (b, head, chunk): d cs from its row and column
//     parts and the state terms at T, its reverse cumsum dl as the same warp
//     scan, ddt = the direct part + a dl, the chunk's dA = dt . dl.
//  7. ssd_bwd_sum_kernel: dB and dC, the head groups' partials summed in
//     group order, in x's dtype; dA over the chunks in order.
// The j-side and i-side kernels are persistent (one CTA of 384 threads an
// SM: a producer warp whose one thread issues the copies while its
// warpgroup gives its registers away with setmaxnreg, and two consumer
// warpgroups) and take their work items longest walk first from the host's
// plan (kernels/ssd_scan.py::bwd_plan), in rounds of alternating direction.
// Within an item the heads go in pairs, warpgroup w taking head 2k + w of
// pair k, so both read one copy of the item's B_j (C_i), of each C_i, B_j
// and CB block and of the pair's rows. x, B and C arrive by TMA boxes of the
// model's strided (B, S, .) slices; the workspace's planes, cs rows and CB
// by bulk copies and an f32 tensor map; through a ring of two slots, each
// with a full and an empty mbarrier, a pair step (i blocks on the j side) or
// a state step (the pair's dH_out or h_in planes). B_j (C_i) and the pair's
// x_j (dy_i planes) have two buffers each, so the next item's and pair's
// loads overlap this one's work. Where TMA's alignment refuses x, B or C
// (not vec), the producer warp copies their rows itself, bounds-checked,
// into the same swizzled images. Rows past L in a ragged chunk are the next
// chunk's (or TMA's zero fill): the masks and the zero rows of the
// workspace keep them out of every sum. A consumer issues a step's dM^T
// (dM) product, then makes the fragments of M^T and P^T (P) one k-step of
// 16 at a time, issuing each k-step's products while it makes the next
// one's. That elementwise work, not the tensor cores or the ring, bounds
// the kernels (clock counters in an instrumented build on the H100: the
// consumers barely wait on their dM products), so a pair masked off takes
// ex = 0 and no other select: CB, dM and dy are finite there (TMA's zero
// rows past L; CB zeroed past L in a ragged chunk). No float atomics: every sum over heads, groups, rows and chunks
// has a fixed order, and two launches give the same bits.
// f32 inputs and the other bf16 shapes take the FMA route, four kernels:
// ssd_bwd_dstate_kernel (each chunk's own term and total), the pass
// (writing dH_out in f32 over the term), ssd_bwd_chunk_kernel (per (b, head,
// chunk): 64-row blocks of j outside, i >= j inside, the head's dC_i in its
// workspace rows, d cs and ddt's direct part in shared memory, a one-thread
// reverse cumsum) and the sums over the heads.
//
// Each f32 operand of a tensor-core product goes in as two bf16 terms (hi,
// lo); a product with one exact bf16 operand takes two products, M^T dy and
// dy h_in take three (hi hi, hi lo, lo hi), as tests/test_torch_ssd_scan_bwd.py
// settles: one term leaves ddt and dA off by up to 1e-2 of their max, two
// within 1e-5.
//
// Budgets at (hd, ds) = (64, 128): shared memory 199,776 bytes (j side: two
// B_j, two x_j pairs, two 65 KB slots), 230,496 (i side: two C_i, two dy_i
// pairs, two 64 KB slots), 35,872 (pre-pass); consumer registers (of 232
// after setmaxnreg, the producer keeping 40): j side dB 64 + dx 32 + dM^T 32
// + fragments 64, the leaving state's x_j dH_out 64 in place of dM^T and
// the fragments; i side dC 64 + dM 32 + fragments 32, R 64.
//
// Bound on the H100 at mamba2-370m's training shape (B, S, nh, hd, ds) =
// (4, 2048, 32, 64, 128), L = 256, bf16: the function needs 43 GFLOP (the
// causal pairs' products, CB once per (b, chunk), and four (L x hd x ds)
// products a chunk): 44 us at 989 TFLOP/s; its inputs and outputs (x, dy
// in f32, h_in, dx, B, C, dB, dC, dt, ddt, dh0) are 182 MB: 54 us at
// 3.35 TB/s, so bytes bound it. The route runs 119.5 GFLOP of wgmma work
// (whole 64 x 64 blocks, two or three products a term pair, dM twice) and
// moves about 485 MB of workspace (216 MB resident: dy's and the states'
// planes, the own terms, CB, the groups' dB and dC of 34 MB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
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
// cs_s, in order on one thread (any L; the FMA route); returns after a
// barrier
__device__ __forceinline__ void serial_cumsum(const float* dt, float a, float* dt_s,
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
  serial_cumsum(dt, A[b * st.ab + h], dt_s, cs_s, b, h, s0, L, st);
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

// the f32 values v as two bf16 planes (hi: v rounded; lo: the remainder
// rounded), four elements at element `at` of planes `plane` elements apart
__device__ __forceinline__ void store_planes(bf16* dst, long long plane, long long at,
                                             float4 v) {
  const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
  const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
  *reinterpret_cast<uint2*>(dst + at) = make_uint2(pack(h01), pack(h23));
  *reinterpret_cast<uint2*>(dst + plane + at) =
      make_uint2(pack(__floats2bfloat162_rn(v.x - f01.x, v.y - f01.y)),
                 pack(__floats2bfloat162_rn(v.z - f23.x, v.w - f23.y)));
}

// byte offset of (row r, column col) in the swizzled image of a (rows x W)
// bf16 operand: W / atom column blocks of rows x 2 atom bytes, each 16-byte
// piece of a row at its index XOR the row's swizzle phase, as TMA's
// 128-byte (atom 64) and 64-byte (atom 32) swizzles place them
__host__ __device__ constexpr int img_off(int atom, int rows, int r, int col) {
  return (col / atom) * (rows * 2 * atom) + r * 2 * atom +
         ((((col % atom) >> 3) ^ (atom == 64 ? (r & 7) : ((r >> 1) & 3))) << 4) +
         (col & 7) * 2;
}

// Phase 2, per (b, head, 1024 state elements): the chunks in reverse from
// dh_final (or zeros). Chunk c's slot holds its own term on entry; dH_in =
// exp(T_c) dH_out + term is the previous chunk's dH_out, and chunk 0's is
// dh0. The FMA route (dhp null) writes each chunk's dH_out over its slot.
// The tensor-core route writes it instead as two bf16 planes in the
// swizzled (HD x DS) image its kernels bulk-copy, the entering state h_in
// as two more, and <dH_out, h_in> as one partial a warp (128 elements),
// which the tail sums in order.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_pass_kernel(const float* __restrict__ dhf, float* __restrict__ dstate,
                    const float* __restrict__ totals, float* __restrict__ dh0, int nc, int E,
                    const float* __restrict__ hin, bf16* __restrict__ dhp,
                    bf16* __restrict__ hinp, float* __restrict__ dotw, int HD, int DS) {
  const long long bh = static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int e = (blockIdx.x * THREADS + threadIdx.x) * 4;
  if (e >= E) return;  // whole warps on the tensor-core route (E a multiple of 1024)
  float4 g = dhf ? *reinterpret_cast<const float4*>(dhf + bh * E + e)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  const int at = dhp ? img_off(64, HD, e / DS, e % DS) / 2 : 0;
  for (int c = nc - 1; c >= 0; --c) {
    const long long bhc = bh * nc + c;
    float4* slot = reinterpret_cast<float4*>(dstate + bhc * E + e);
    const float4 s = *slot;
    if (dhp) {
      const float4 hv = *reinterpret_cast<const float4*>(hin + bhc * E + e);
      store_planes(dhp + bhc * 2 * E, E, at, g);
      store_planes(hinp + bhc * 2 * E, E, at, hv);
      float d = fmaf(g.w, hv.w, fmaf(g.z, hv.z, fmaf(g.y, hv.y, g.x * hv.x)));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
      if ((threadIdx.x & 31) == 0) dotw[bhc * (E / 128) + blockIdx.x * 8 + threadIdx.x / 32] = d;
    } else {
      *slot = g;
    }
    const float d = expf(totals[bhc]);
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
  serial_cumsum(dt, a, dt_s, cs_s, b, h, s0, L, st);
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

// Phase 4: dB and dC (b, s, n) summed over their np partials (b, p, s, n)
// in order (the heads on the FMA route, the head groups on the tensor-core
// route), in x's dtype; dA (b, h) summed over the chunks in order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_sum_kernel(const float* __restrict__ dBp, const float* __restrict__ dCp,
                   const float* __restrict__ dAc, T* __restrict__ dB, T* __restrict__ dC,
                   float* __restrict__ dA, int np, int nh, int nc, long long N) {
  const int b = blockIdx.y;
  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (e < N) {
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < np; ++h) {
      sb += dBp[(static_cast<long long>(b) * np + h) * N + e];
      sc += dCp[(static_cast<long long>(b) * np + h) * N + e];
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

// ---------------------------------------------------------------------------
// The tensor-core route (bf16 x, B and C, chunks of at most 256, d_state of
// at least 64): wgmma on operands that TMA and bulk copies bring into
// shared memory (see the note at the top).
// ---------------------------------------------------------------------------

constexpr int kThreadsTc = 384;  // a producer warpgroup and two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 * 40 + 256 * 232 <= 65536
constexpr int kStages = 2;                              // ring slots of each main kernel

constexpr int round1024(int x) { return (x + 1023) / 1024 * 1024; }

// a (rows x W) bf16 operand in shared memory, as img_off lays it out
template <int W>
struct Img {
  static constexpr int ATOM = W >= 64 ? 64 : 32;  // bf16 columns of a swizzle row
  static constexpr int ROWB = 2 * ATOM;
  static constexpr uint64_t MODE = ROWB == 128 ? 1 : 2;  // descriptor: 128 or 64 B swizzle
  static constexpr int KSTEPS = ATOM / 16;
  // k-step kk of a K-major image of R rows (K along W)
  static __device__ __forceinline__ uint64_t kdesc(uint32_t base, int R, int kk) {
    return sdesc(base + (kk / KSTEPS) * R * ROWB + (kk % KSTEPS) * 32, 16, 8 * ROWB, MODE);
  }
  // k-step kk of an MN-major image of R rows (K along its rows, N along W)
  static __device__ __forceinline__ uint64_t mdesc(uint32_t base, int R, int kk) {
    return sdesc(base + kk * 16 * ROWB, R * ROWB, 8 * ROWB, MODE);
  }
  // the two bf16 at (r, col), col even, as one register
  static __device__ __forceinline__ float2 pair(const unsigned char* img, int R, int r, int col) {
    return unpack(*reinterpret_cast<const uint32_t*>(img + img_off(ATOM, R, r, col)));
  }
};

// Sizes in bytes; every operand image starts on a 1024-byte boundary.
template <int HD, int DS>
struct TcCfg {
  static constexpr int X = 64 * HD * 2;   // x_j, or one plane of dy_i (64 rows)
  static constexpr int BC = 64 * DS * 2;  // B_j or C_i (64 rows)
  static constexpr int ST = HD * DS * 2;  // one plane of dH_out or h_in
  static constexpr int CB = 64 * 64 * 4;  // a CB block: two 128-byte-swizzled column halves
  static constexpr int ROWS = 64 * 4;     // an f32 vector over a block's rows
  // j-side: two B_j buffers (this item's and the next's), two x_j buffers
  // of a head pair, the ring. A pair step is
  // C_i, CB, dy_i's planes of both heads, cs_i of both heads; a state step
  // is both heads' dH_out planes.
  static constexpr int J_STEP = BC + CB + 4 * X + 2 * ROWS;
  static constexpr int J_SLOT = round1024(J_STEP > 4 * ST ? J_STEP : 4 * ST);
  static constexpr int J_HB = round1024(2 * X);
  static constexpr int J_RING = 2 * BC + 2 * J_HB;
  static constexpr int J_BAR = J_RING + kStages * J_SLOT;
  static constexpr int J_SMEM = J_BAR + 8 * (8 + 2 * kStages) + 1024;
  // i-side: two C_i buffers, two dy_i buffers (both planes of both heads),
  // the ring. A
  // pair step is B_j, CB, x_j of both heads, cs_j and dt_j of both heads; a
  // state step is both heads' h_in planes.
  static constexpr int I_STEP = BC + CB + 2 * X + 4 * ROWS;
  static constexpr int I_SLOT = round1024(I_STEP > 4 * ST ? I_STEP : 4 * ST);
  static constexpr int I_HB = round1024(4 * X);
  static constexpr int I_RING = 2 * BC + 2 * I_HB;
  static constexpr int I_BAR = I_RING + kStages * I_SLOT;
  static constexpr int I_SMEM = I_BAR + 8 * (8 + 2 * kStages) + 1024;
  // pre-pass: C_i, exp(cs_i) dy_i's planes, dt, cs and the warps' totals
  static constexpr int P_SMEM = BC + 2 * X + 4 * (2 * THREADS + 8) + 1024;
};

struct TcGeom {
  int Bb, S, nh, L, nc, nb, ng, G, items, bcg, LP;
  const int* order;     // [nb] j blocks, then [nb] i blocks, longest walk first
  const float* cs;      // (Bb, nh, nc, LP) the cumsum in log2 units (cs log2(e)), 0 past L
  const float* dtc;     // (Bb, nh, nc, LP) dt, 0 past L
  const float* totals;  // (Bb, nh, nc) cs_{L-1}
  const bf16* dyp;      // (Bb, nh, nc, nb, 2, 64 x HD image) dy's planes
  const bf16* stp;      // (Bb, nh, nc, 2, HD x DS image) dH_out's (j) or h_in's (i) planes
  bf16* dx;             // (Bb, S, nh, HD)
  float* part;          // (Bb, ng, S, DS) dB (j) or dC (i) of each head group
  float* r0;            // (Bb, nh, S): j: d cs's column part; i: its row part
  float* r1;            // j: ddt's direct part
  float* r2;            // j: w_j u_j
  const bf16* xm;       // x, B, C and their element strides, for the copies
  const bf16* bm;       // the producer makes itself where TMA refuses them
  const bf16* cm;       // (not vec)
  long long xb, xs, xh, bb, bs, cb, cs_;
  int vec;
};

struct TcItem {
  int b, c, blk, h0, nhg, g;
};

// work item t of side 0 (j) or 1 (i): its block from the plan's order, then
// (b, chunk, head group) with the group fastest, so that neighbouring items
// share their (b, chunk)'s B, C and CB in L2
__device__ __forceinline__ TcItem tc_item(int t, const TcGeom& gm, int side) {
  TcItem it;
  it.blk = gm.order[side * gm.nb + t / gm.bcg];
  const int rest = t % gm.bcg, bc = rest / gm.ng;
  it.g = rest % gm.ng;
  it.c = bc % gm.nc;
  it.b = bc / gm.nc;
  it.h0 = it.g * gm.G;
  it.nhg = min(gm.G, gm.nh - it.h0);
  return it;
}

// rows [row0, row0 + 64) of a bf16 matrix (row stride rs, 16-byte pieces of
// 8 elements) into its (64 x W) image at `dst`, zero from row `valid` on,
// by `n` threads from index `i`; 16-byte loads where `vec`
template <int W>
__device__ __forceinline__ void copy_rows(unsigned char* dst, const bf16* src, long long rs,
                                          int valid, bool vec, int i, int n) {
  constexpr int PR = W / 8;
  for (int q = i; q < 64 * PR; q += n) {
    const int r = q / PR, col = (q % PR) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) {
      const bf16* p = src + r * rs + col;
      if (vec) {
        v = *reinterpret_cast<const uint4*>(p);
      } else {
        bf16 tmp[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) tmp[k] = p[k];
        memcpy(&v, tmp, sizeof(v));
      }
    }
    *reinterpret_cast<uint4*>(dst + img_off(Img<W>::ATOM, 64, r, col)) = v;
  }
}

// CB[i][j] of a CB block in shared memory (rows i, two 32-column halves)
__device__ __forceinline__ const float* cb_at(const unsigned char* cb, int i, int j) {
  return reinterpret_cast<const float*>(cb + (j >> 5) * 8192 + i * 128 +
                                        ((((j & 31) >> 2) ^ (i & 7)) << 4) + (j & 3) * 4);
}

// (v0, v1) as a hi and a lo bf16 pair: the values rounded, the remainders
// rounded
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(h);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(v0 - f.x, v1 - f.y));
}

// columns 16 kb .. 16 kb + 15 of a 64 x 64 accumulator as the hi and lo A
// fragments of k-step kb of a product whose k runs over its columns
__device__ __forceinline__ void split_frags(const float* acc, int kb, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
#pragma unroll
  for (int n = 2 * kb; n < 2 * kb + 2; ++n) {
    split2(acc[4 * n], acc[4 * n + 1], hi[(n & 1) * 2], lo[(n & 1) * 2]);
    split2(acc[4 * n + 2], acc[4 * n + 3], hi[(n & 1) * 2 + 1], lo[(n & 1) * 2 + 1]);
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// sum over the four lanes of a row of an accumulator fragment
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Pre-pass, per (b, head, chunk): the chunk's cumsum as the forward's warp
// scan (cs and dt written, 0 past L, and the total); dy's two bf16 planes
// into the workspace's 64-row images; the chunk's own state term
// dstate = (exp(cs) dy)^T C, as dstate^T = C^T (exp(cs) dy) on wgmma with
// both operands MN-major: warpgroup w takes the 64 state columns w.
template <int HD, int DS>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_prep_kernel(const float* __restrict__ dy, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Cm,
                    float* __restrict__ dstate, float* __restrict__ totals,
                    float* __restrict__ cs_out, float* __restrict__ dt_out,
                    bf16* __restrict__ dyp, int S, int nh, int L, int LP, Strides st, bool vec) {
  using C = TcCfg<HD, DS>;
  using IH = Img<HD>;
  using IS = Img<DS>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gb = smem_raw + (base - raw);
  unsigned char* c_img = gb;               // (64 x DS) C_i
  unsigned char* e_img = gb + C::BC;       // 2 x (64 x HD) exp(cs_i) dy_i
  float* dt_s = reinterpret_cast<float*>(gb + C::BC + 2 * C::X);
  float* cs_s = dt_s + THREADS;
  float* warp_tot = cs_s + THREADS;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int s0 = c * L, t = threadIdx.x;
  const long long bhc = (static_cast<long long>(b) * nh + h) * nc + c;
  dt_s[t] = t < L ? dt[b * st.db + (s0 + t) * st.ds + h * st.dh] : 0.f;
  __syncthreads();
  chunk_cumsum(dt_s, A[b * st.ab + h], cs_s, warp_tot, L);
  if (t < LP) {
    cs_out[bhc * LP + t] = t < L ? cs_s[t] * kLog2e : 0.f;  // in log2 units
    dt_out[bhc * LP + t] = dt_s[t];
  }
  if (t == 0) totals[bhc] = cs_s[L - 1];
  const int wg = t / 128, warp = (t % 128) / 32, lane = t % 32;
  float acc[HD / 2];
#pragma unroll
  for (int k = 0; k < HD / 2; ++k) acc[k] = 0.f;
  const long long dys = static_cast<long long>(nh) * HD;
  const float* dyc = dy + (static_cast<long long>(b) * S + s0) * dys + h * HD;
  const int nb = LP / 64;
  constexpr int NV = 64 * HD / (4 * THREADS);  // a thread's 16-byte pieces of a dy block
  float4 v[NV];
  auto load_dy = [&](int i0) {  // in flight while the previous block's product runs
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int e = 4 * (t + k * THREADS), r = e / HD;
      v[k] = i0 + r < L ? *reinterpret_cast<const float4*>(dyc + (i0 + r) * dys + e % HD)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  load_dy(0);
  for (int blk = 0; blk < nb; ++blk) {
    const int i0 = 64 * blk;
    bf16* out = dyp + (bhc * nb + blk) * 2 * (64 * HD);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int e = 4 * (t + k * THREADS), r = e / HD;
      const int at = img_off(IH::ATOM, 64, r, e % HD) / 2;
      store_planes(out, 64 * HD, at, v[k]);
      const float ex = i0 + r < L ? expf(cs_s[i0 + r]) : 0.f;
      store_planes(reinterpret_cast<bf16*>(e_img), 64 * HD, at,
                   make_float4(v[k].x * ex, v[k].y * ex, v[k].z * ex, v[k].w * ex));
    }
    copy_rows<DS>(c_img, Cm + b * st.cb + (s0 + i0) * st.cs, st.cs, L - i0, vec, t, THREADS);
    fence_proxy_async();
    __syncthreads();
    if (blk + 1 < nb) load_dy(i0 + 64);
    if (wg < DS / 64) {
      const uint32_t ca = base + wg * 64 * IS::ROWB, ea = base + C::BC;
      wgmma_fence();
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_sst<HD, 1, 1>(acc, IS::mdesc(ca, 64, kk), IH::mdesc(ea + pl * C::X, 64, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<HD / 2>(acc);
    }
    __syncthreads();
  }
  if (wg < DS / 64) {
    float* o = dstate + bhc * HD * DS;
    const int n0 = 64 * wg + 16 * warp + lane / 4;
#pragma unroll
    for (int k = 0; k < HD / 8; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[(8 * k + 2 * (lane % 4) + (e & 1)) * DS + n0 + 8 * (e >> 1)] = acc[4 * k + e];
  }
}

// The j-side kernel: a work item is (b, chunk, 64-row j block, head group).
// B_j arrives once an item; the heads go in pairs, warpgroup w taking head
// 2k + w of pair k, with x_j of the pair in one of two buffers. Per head: a
// state step (its dH_out planes) for the leaving state's terms, then a pair
// step for each i block >= j (C_i, CB, dy_i's planes, cs_i) through the
// ring: dM^T = x_j dy_i^T, M^T and P^T masked before exp, d cs's and ddt's
// row sums (columns of the (i, j) pair), dx_j += M^T dy_i, dB_j += P^T C_i.
// dx_j goes out once a head, dB_j once an item (warpgroup 0's sum plus
// warpgroup 1's, in that order).
template <int HD, int DS>
__global__ void __launch_bounds__(kThreadsTc, 1)
ssd_bwd_jside_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap tcb,
                     const TcGeom gm) {
  using C = TcCfg<HD, DS>;
  using IH = Img<HD>;
  using IS = Img<DS>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gb = smem_raw + (base - raw);
  const uint32_t bar = base + C::J_BAR;  // [2] each: bj_full, bj_empty, hb_full, hb_empty
  const uint32_t bj_full = bar, bj_empty = bar + 16, hb_full = bar + 32, hb_empty = bar + 48;
  const uint32_t full0 = bar + 64, empty0 = full0 + 8 * kStages;
  const int L = gm.L, nb = gm.nb;
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      mbar_init(bj_full + 8 * k, 1);
      mbar_init(bj_empty + 8 * k, kConsumerWarps);
      mbar_init(hb_full + 8 * k, 1);
      mbar_init(hb_empty + 8 * k, kConsumerWarps);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: warp 0 (one thread issues; all 32 copy where TMA cannot) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const bool vec = gm.vec != 0;
      int s = 0, hbn = 0;
      uint32_t ph = 0;
      auto next = [&]() {
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      };
      for (int r = 0;; ++r) {
        const int t = round_item(r, gm.items);
        if (t < 0) break;
        const TcItem it = tc_item(t, gm, 0);
        const int s0 = it.c * L, j0 = 64 * it.blk, b = it.b, bb = r & 1;
        mbar_wait(bj_empty + 8 * bb, ((r >> 1) & 1) ^ 1);  // the item before last is done
        if (!vec) {
          copy_rows<DS>(gb + bb * C::BC, gm.bm + b * gm.bb + (s0 + j0) * gm.bs, gm.bs, L - j0,
                        false, lane, 32);
          fence_proxy_async();
        }
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(bj_full + 8 * bb, vec ? C::BC : 0);
          if (vec)
            for (int sub = 0; sub < DS / 64; ++sub)
              tma_load_3d(base + bb * C::BC + sub * 64 * 128, &tb, bj_full + 8 * bb, 64 * sub,
                          s0 + j0, b);
        }
        for (int k = 0; 2 * k < it.nhg; ++k, ++hbn) {
          const int nh2 = min(2, it.nhg - 2 * k);  // heads of this pair
          const int buf = hbn & 1;
          const uint32_t hb = base + 2 * C::BC + buf * C::J_HB;
          mbar_wait(hb_empty + 8 * buf, ((hbn >> 1) & 1) ^ 1);
          if (!vec) {
            for (int w = 0; w < nh2; ++w)
              copy_rows<HD>(gb + (hb - base) + w * C::X,
                            gm.xm + b * gm.xb + (it.h0 + 2 * k + w) * gm.xh + (s0 + j0) * gm.xs,
                            gm.xs, L - j0, false, lane, 32);
            fence_proxy_async();
          }
          __syncwarp();
          if (lane == 0) {
            mbar_expect_tx(hb_full + 8 * buf, vec ? nh2 * C::X : 0);
            if (vec)
              for (int w = 0; w < nh2; ++w)
                tma_load_4d(hb + w * C::X, &tx, hb_full + 8 * buf, 0, s0 + j0, it.h0 + 2 * k + w, b);
          }
          // the state step: both heads' dH_out planes
          mbar_wait(empty0 + 8 * s, ph ^ 1);
          if (lane == 0) {
            const uint32_t fb = full0 + 8 * s;
            mbar_expect_tx(fb, nh2 * 2 * C::ST);
            for (int w = 0; w < nh2; ++w) {
              const long long bhc =
                  (static_cast<long long>(b) * gm.nh + it.h0 + 2 * k + w) * gm.nc + it.c;
              bulk_load(base + C::J_RING + s * C::J_SLOT + w * 2 * C::ST,
                        gm.stp + bhc * 2 * HD * DS, 2 * C::ST, fb);
            }
          }
          next();
          // the pair steps: i blocks from j's on
          for (int ib = it.blk; ib < nb; ++ib) {
            const int i0 = 64 * ib;
            const uint32_t st = base + C::J_RING + s * C::J_SLOT, fb = full0 + 8 * s;
            mbar_wait(empty0 + 8 * s, ph ^ 1);
            if (!vec) {
              copy_rows<DS>(gb + (st - base), gm.cm + b * gm.cb + (s0 + i0) * gm.cs_, gm.cs_,
                            L - i0, false, lane, 32);
              fence_proxy_async();
            }
            __syncwarp();
            if (lane == 0) {
              mbar_expect_tx(fb, (vec ? C::BC : 0) + C::CB + nh2 * (2 * C::X + C::ROWS));
              if (vec)
                for (int sub = 0; sub < DS / 64; ++sub)
                  tma_load_3d(st + sub * 64 * 128, &tc, fb, 64 * sub, s0 + i0, b);
              tma_load_3d(st + C::BC, &tcb, fb, j0, i0, b * gm.nc + it.c);
              tma_load_3d(st + C::BC + 8192, &tcb, fb, j0 + 32, i0, b * gm.nc + it.c);
              for (int w = 0; w < nh2; ++w) {
                const long long bhc =
                    (static_cast<long long>(b) * gm.nh + it.h0 + 2 * k + w) * gm.nc + it.c;
                bulk_load(st + C::BC + C::CB + w * 2 * C::X, gm.dyp + (bhc * nb + ib) * 2 * 64 * HD,
                          2 * C::X, fb);
                bulk_load(st + C::BC + C::CB + 4 * C::X + w * C::ROWS, gm.cs + bhc * gm.LP + i0,
                          C::ROWS, fb);
              }
            }
            next();
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t128 = threadIdx.x - 128, wg = t128 / 128, warp = (t128 % 128) / 32;
    const int lane = t128 % 32, tid = lane % 4;
    auto release = [&](uint32_t b_) {
      __syncwarp();
      if (lane == 0) mbar_arrive(b_);
    };
    int s = 0, hbn = 0;
    uint32_t ph = 0;
    auto next = [&]() {
      if (++s == kStages) {
        s = 0;
        ph ^= 1;
      }
    };
    const int jl[2] = {16 * warp + lane / 4, 16 * warp + lane / 4 + 8};  // the thread's rows
    float dB[DS / 2], dx[HD / 2], dm[32], mv[32];
    for (int r = 0;; ++r) {
      const int t = round_item(r, gm.items);
      if (t < 0) break;
      const TcItem it = tc_item(t, gm, 0);
      const int s0 = it.c * L, j0 = 64 * it.blk, b = it.b, bb = r & 1;
      const uint32_t bj = base + bb * C::BC;
      const unsigned char* gbj = gb + bb * C::BC;
#pragma unroll
      for (int k = 0; k < DS / 2; ++k) dB[k] = 0.f;
      mbar_wait(bj_full + 8 * bb, (r >> 1) & 1);
      for (int k = 0; 2 * k < it.nhg; ++k, ++hbn) {
        const int h = it.h0 + 2 * k + wg;
        const bool mine = 2 * k + wg < it.nhg;
        const int buf = hbn & 1;
        const uint32_t xj = base + 2 * C::BC + buf * C::J_HB + wg * C::X;
        mbar_wait(hb_full + 8 * buf, (hbn >> 1) & 1);
        const long long bhc = (static_cast<long long>(b) * gm.nh + (mine ? h : 0)) * gm.nc + it.c;
        const float T = gm.totals[bhc] * kLog2e;  // log2 units, as cs
        float csj[2], dtj[2], rowq[2] = {0.f, 0.f}, wu[2], eu[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          csj[q] = gm.cs[bhc * gm.LP + j0 + jl[q]];
          dtj[q] = gm.dtc[bhc * gm.LP + j0 + jl[q]];
        }
        // the state step: the leaving state's terms of this warpgroup's head
        {
          mbar_wait(full0 + 8 * s, ph);
          if (mine) {
            const uint32_t dh = base + C::J_RING + s * C::J_SLOT + wg * 2 * C::ST;
            float tmp[DS / 2];
            wgmma_fence();
            // dx = B_j dH_out^T (dH_out K-major over DS), tmp = x_j dH_out
#pragma unroll
            for (int pl = 0; pl < 2; ++pl)
#pragma unroll
              for (int kk = 0; kk < DS / 16; ++kk)
                wgmma_ss<HD>(dx, IS::kdesc(bj, 64, kk), IS::kdesc(dh + pl * C::ST, HD, kk),
                             pl + kk > 0);
#pragma unroll
            for (int pl = 0; pl < 2; ++pl)
#pragma unroll
              for (int kk = 0; kk < HD / 16; ++kk)
                wgmma_sst<DS, 0, 1>(tmp, IH::kdesc(xj, 64, kk),
                                    IS::mdesc(dh + pl * C::ST, HD, kk), pl + kk > 0);
            wgmma_commit();
            wgmma_wait_all();
            fence_regs<HD / 2>(dx);
            fence_regs<DS / 2>(tmp);
#pragma unroll
            for (int q2 = 0; q2 < 2; ++q2) {
              float u = 0.f;
#pragma unroll
              for (int n = 0; n < DS / 8; ++n) {
                const float2 bv = IS::pair(gbj, 64, jl[q2], 8 * n + 2 * tid);
                u = fmaf(tmp[4 * n + 2 * q2], bv.x, fmaf(tmp[4 * n + 2 * q2 + 1], bv.y, u));
              }
              u = quad_sum(u);
              const bool on = j0 + jl[q2] < L;
              const float et = on ? ex2(T - csj[q2]) : 0.f;
              const float wj = et * dtj[q2];
              wu[q2] = wj * u;
              eu[q2] = et * u;
#pragma unroll
              for (int n = 0; n < HD / 8; ++n) {
                dx[4 * n + 2 * q2] *= wj;
                dx[4 * n + 2 * q2 + 1] *= wj;
              }
#pragma unroll
              for (int n = 0; n < DS / 8; ++n) {
                dB[4 * n + 2 * q2] = fmaf(wj, tmp[4 * n + 2 * q2], dB[4 * n + 2 * q2]);
                dB[4 * n + 2 * q2 + 1] = fmaf(wj, tmp[4 * n + 2 * q2 + 1], dB[4 * n + 2 * q2 + 1]);
              }
            }
          }
          release(empty0 + 8 * s);
          next();
        }
        // the pair steps
        bool pending = false;  // a dx, dB product still reads stage `prev`
        int prev = 0;
        for (int ib = it.blk; ib < nb; ++ib) {
          const int i0 = 64 * ib;
          mbar_wait(full0 + 8 * s, ph);
          if (mine) {
            const uint32_t st = base + C::J_RING + s * C::J_SLOT;
            const uint32_t dyh = st + C::BC + C::CB + wg * 2 * C::X, dyl = dyh + C::X;
            const unsigned char* gst = gb + (st - base);
            const float* csi = reinterpret_cast<const float*>(gst + C::BC + C::CB + 4 * C::X +
                                                              wg * C::ROWS);
            wgmma_fence();
            // dM^T = x_j dy_i^T, dy_i's two planes
#pragma unroll
            for (int pl = 0; pl < 2; ++pl)
#pragma unroll
              for (int kk = 0; kk < HD / 16; ++kk)
                wgmma_ss<64>(dm, IH::kdesc(xj, 64, kk), IH::kdesc(pl ? dyl : dyh, 64, kk),
                             pl + kk > 0);
            wgmma_commit();
            wgmma_wait_all();  // the previous step's dx, dB and this dM^T are done
            fence_regs<32>(dm);
            fence_regs<HD / 2>(dx);
            fence_regs<DS / 2>(dB);
            if (pending) release(empty0 + 8 * prev);
            // M^T, P^T: row j (the thread's two), column i = i0 + 8n + 2 tid + (e & 1),
            // 16 columns (one k-step) at a time, each k-step's products issued
            // while the next one's fragments are made:
            // dx += M^T dy_i (hi hi, hi lo, lo hi), dB += P^T C_i (hi, lo)
            uint32_t mh[4][4], ml[4][4], pa[4][4], pb[4][4];
#pragma unroll
            for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
              for (int n = 2 * kb; n < 2 * kb + 2; ++n) {
                const float2 ci = *reinterpret_cast<const float2*>(csi + 8 * n + 2 * tid);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  // on: j <= i < L, as one unsigned compare; off pairs take ex = 0,
                  // and CB and dM are finite there (rows past L: TMA's zeros)
                  const int q = e >> 1, il = 8 * n + 2 * tid + (e & 1);
                  const bool on = static_cast<unsigned>(il + i0 - j0 - jl[q]) <=
                                  static_cast<unsigned>(L - 1 - j0 - jl[q]);
                  const float ex = on ? ex2(((e & 1) ? ci.y : ci.x) - csj[q]) : 0.f;  // masked first
                  const float exd = ex * dtj[q];
                  const float cbv = *cb_at(gst + C::BC, il, jl[q]);
                  rowq[q] = fmaf(dm[4 * n + e], cbv * ex, rowq[q]);  // dM CB decay
                  mv[4 * n + e] = cbv * exd;
                  dm[4 * n + e] *= exd;
                }
              }
              split_frags(mv, kb, mh[kb], ml[kb]);
              split_frags(dm, kb, pa[kb], pb[kb]);
              wgmma_fence();
              wgmma_rs<HD>(dx, mh[kb], IH::mdesc(dyh, 64, kb));
              wgmma_rs<HD>(dx, mh[kb], IH::mdesc(dyl, 64, kb));
              wgmma_rs<HD>(dx, ml[kb], IH::mdesc(dyh, 64, kb));
              wgmma_rs<DS>(dB, pa[kb], IS::mdesc(st, 64, kb));
              wgmma_rs<DS>(dB, pb[kb], IS::mdesc(st, 64, kb));
            }
            wgmma_commit();
            pending = true;
            prev = s;
          } else {
            release(empty0 + 8 * s);
          }
          next();
        }
        if (pending) {
          wgmma_wait_all();
          fence_regs<HD / 2>(dx);
          fence_regs<DS / 2>(dB);
          release(empty0 + 8 * prev);
        }
        release(hb_empty + 8 * buf);
        if (mine) {
          bf16* dxr = gm.dx + (static_cast<long long>(b) * gm.S + s0 + j0) * gm.nh * HD + h * HD;
          const long long rb = (static_cast<long long>(b) * gm.nh + h) * gm.S + s0 + j0;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float qs = quad_sum(rowq[q]), g = qs * dtj[q];  // G = Q dt_j: dt is j's
            if (j0 + jl[q] >= L) continue;
#pragma unroll
            for (int n = 0; n < HD / 8; ++n)
              *reinterpret_cast<uint32_t*>(dxr + jl[q] * gm.nh * HD + 8 * n + 2 * tid) =
                  pack_bf16(dx[4 * n + 2 * q], dx[4 * n + 2 * q + 1]);
            if (tid == 0) {
              gm.r0[rb + jl[q]] = -(wu[q] + g);
              gm.r1[rb + jl[q]] = eu[q] + qs;
              gm.r2[rb + jl[q]] = wu[q];
            }
          }
        }
      }
      release(bj_empty + 8 * bb);
      // the group's dB_j: warpgroup 0's plus warpgroup 1's
      float* part = gm.part + ((static_cast<long long>(b) * gm.ng + it.g) * gm.S + s0 + j0) * DS;
      if (wg == 1) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (j0 + jl[q] < L)
#pragma unroll
            for (int n = 0; n < DS / 8; ++n)
              *reinterpret_cast<float2*>(part + jl[q] * DS + 8 * n + 2 * tid) =
                  make_float2(dB[4 * n + 2 * q], dB[4 * n + 2 * q + 1]);
        __threadfence_block();
      }
      named_sync(1);
      if (wg == 0) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (j0 + jl[q] < L)
#pragma unroll
            for (int n = 0; n < DS / 8; ++n) {
              float2* p = reinterpret_cast<float2*>(part + jl[q] * DS + 8 * n + 2 * tid);
              const float2 o = *p;
              *p = make_float2(dB[4 * n + 2 * q] + o.x, dB[4 * n + 2 * q + 1] + o.y);
            }
      }
    }
  }
}

// The i-side kernel: a work item is (b, chunk, 64-row i block, head group).
// C_i arrives once an item; the heads go in pairs as on the j side, with dy_i's
// planes of the pair in one of two buffers. Per head: a state step (its
// h_in planes) for the entering state's terms R = exp(cs_i) dy_i h_in
// (three products) into dC_i and C_i . R_i into d cs_i, then a pair step for
// each j block <= i (B_j, CB, x_j, cs_j, dt_j): dM = dy_i x_j^T, M, P, G's
// row sums, dC_i += P B_j. dC_i goes out once an item, as dB_j does.
template <int HD, int DS>
__global__ void __launch_bounds__(kThreadsTc, 1)
ssd_bwd_iside_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap tcb,
                     const TcGeom gm) {
  using C = TcCfg<HD, DS>;
  using IH = Img<HD>;
  using IS = Img<DS>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gb = smem_raw + (base - raw);
  const uint32_t bar = base + C::I_BAR;  // [2] each: ci_full, ci_empty, hb_full, hb_empty
  const uint32_t ci_full = bar, ci_empty = bar + 16, hb_full = bar + 32, hb_empty = bar + 48;
  const uint32_t full0 = bar + 64, empty0 = full0 + 8 * kStages;
  const int L = gm.L, nb = gm.nb;
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      mbar_init(ci_full + 8 * k, 1);
      mbar_init(ci_empty + 8 * k, kConsumerWarps);
      mbar_init(hb_full + 8 * k, 1);
      mbar_init(hb_empty + 8 * k, kConsumerWarps);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const bool vec = gm.vec != 0;
      int s = 0, hbn = 0;
      uint32_t ph = 0;
      auto next = [&]() {
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      };
      for (int r = 0;; ++r) {
        const int t = round_item(r, gm.items);
        if (t < 0) break;
        const TcItem it = tc_item(t, gm, 1);
        const int s0 = it.c * L, i0 = 64 * it.blk, b = it.b, cc = r & 1;
        mbar_wait(ci_empty + 8 * cc, ((r >> 1) & 1) ^ 1);  // the item before last is done
        if (!vec) {
          copy_rows<DS>(gb + cc * C::BC, gm.cm + b * gm.cb + (s0 + i0) * gm.cs_, gm.cs_, L - i0,
                        false, lane, 32);
          fence_proxy_async();
        }
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(ci_full + 8 * cc, vec ? C::BC : 0);
          if (vec)
            for (int sub = 0; sub < DS / 64; ++sub)
              tma_load_3d(base + cc * C::BC + sub * 64 * 128, &tc, ci_full + 8 * cc, 64 * sub,
                          s0 + i0, b);
        }
        for (int k = 0; 2 * k < it.nhg; ++k, ++hbn) {
          const int nh2 = min(2, it.nhg - 2 * k);
          const int buf = hbn & 1;
          const uint32_t hb = base + 2 * C::BC + buf * C::I_HB;
          mbar_wait(hb_empty + 8 * buf, ((hbn >> 1) & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(hb_full + 8 * buf, nh2 * 2 * C::X);
            for (int w = 0; w < nh2; ++w) {
              const long long bhc =
                  (static_cast<long long>(b) * gm.nh + it.h0 + 2 * k + w) * gm.nc + it.c;
              bulk_load(hb + w * 2 * C::X, gm.dyp + (bhc * nb + it.blk) * 2 * 64 * HD,
                        2 * C::X, hb_full + 8 * buf);
            }
          }
          mbar_wait(empty0 + 8 * s, ph ^ 1);  // the state step: both heads' h_in planes
          if (lane == 0) {
            const uint32_t fb = full0 + 8 * s;
            mbar_expect_tx(fb, nh2 * 2 * C::ST);
            for (int w = 0; w < nh2; ++w) {
              const long long bhc =
                  (static_cast<long long>(b) * gm.nh + it.h0 + 2 * k + w) * gm.nc + it.c;
              bulk_load(base + C::I_RING + s * C::I_SLOT + w * 2 * C::ST,
                        gm.stp + bhc * 2 * HD * DS, 2 * C::ST, fb);
            }
          }
          next();
          for (int jb = 0; jb <= it.blk; ++jb) {
            const int j0 = 64 * jb;
            const uint32_t st = base + C::I_RING + s * C::I_SLOT, fb = full0 + 8 * s;
            mbar_wait(empty0 + 8 * s, ph ^ 1);
            if (!vec) {
              copy_rows<DS>(gb + (st - base), gm.bm + b * gm.bb + (s0 + j0) * gm.bs, gm.bs,
                            L - j0, false, lane, 32);
              for (int w = 0; w < nh2; ++w)
                copy_rows<HD>(gb + (st - base) + C::BC + C::CB + w * C::X,
                              gm.xm + b * gm.xb + (it.h0 + 2 * k + w) * gm.xh + (s0 + j0) * gm.xs,
                              gm.xs, L - j0, false, lane, 32);
              fence_proxy_async();
            }
            __syncwarp();
            if (lane == 0) {
              mbar_expect_tx(fb, (vec ? C::BC + nh2 * C::X : 0) + C::CB + nh2 * 2 * C::ROWS);
              if (vec) {
                for (int sub = 0; sub < DS / 64; ++sub)
                  tma_load_3d(st + sub * 64 * 128, &tb, fb, 64 * sub, s0 + j0, b);
                for (int w = 0; w < nh2; ++w)
                  tma_load_4d(st + C::BC + C::CB + w * C::X, &tx, fb, 0, s0 + j0,
                              it.h0 + 2 * k + w, b);
              }
              tma_load_3d(st + C::BC, &tcb, fb, j0, i0, b * gm.nc + it.c);
              tma_load_3d(st + C::BC + 8192, &tcb, fb, j0 + 32, i0, b * gm.nc + it.c);
              for (int w = 0; w < nh2; ++w) {
                const long long bhc =
                    (static_cast<long long>(b) * gm.nh + it.h0 + 2 * k + w) * gm.nc + it.c;
                const uint32_t rows = st + C::BC + C::CB + 2 * C::X;
                bulk_load(rows + w * C::ROWS, gm.cs + bhc * gm.LP + j0, C::ROWS, fb);
                bulk_load(rows + (2 + w) * C::ROWS, gm.dtc + bhc * gm.LP + j0, C::ROWS, fb);
              }
            }
            next();
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t128 = threadIdx.x - 128, wg = t128 / 128, warp = (t128 % 128) / 32;
    const int lane = t128 % 32, tid = lane % 4;
    auto release = [&](uint32_t b_) {
      __syncwarp();
      if (lane == 0) mbar_arrive(b_);
    };
    int s = 0, hbn = 0;
    uint32_t ph = 0;
    auto next = [&]() {
      if (++s == kStages) {
        s = 0;
        ph ^= 1;
      }
    };
    const int il[2] = {16 * warp + lane / 4, 16 * warp + lane / 4 + 8};
    float dC[DS / 2], dm[32];
    for (int r = 0;; ++r) {
      const int t = round_item(r, gm.items);
      if (t < 0) break;
      const TcItem it = tc_item(t, gm, 1);
      const int s0 = it.c * L, i0 = 64 * it.blk, b = it.b, cc = r & 1;
      const unsigned char* gci = gb + cc * C::BC;
#pragma unroll
      for (int k = 0; k < DS / 2; ++k) dC[k] = 0.f;
      mbar_wait(ci_full + 8 * cc, (r >> 1) & 1);
      for (int k = 0; 2 * k < it.nhg; ++k, ++hbn) {
        const int h = it.h0 + 2 * k + wg;
        const bool mine = 2 * k + wg < it.nhg;
        const int buf = hbn & 1;
        const uint32_t dyh = base + 2 * C::BC + buf * C::I_HB + wg * 2 * C::X, dyl = dyh + C::X;
        mbar_wait(hb_full + 8 * buf, (hbn >> 1) & 1);
        const long long bhc = (static_cast<long long>(b) * gm.nh + (mine ? h : 0)) * gm.nc + it.c;
        float csi[2], rowg[2] = {0.f, 0.f};
#pragma unroll
        for (int q = 0; q < 2; ++q) csi[q] = gm.cs[bhc * gm.LP + i0 + il[q]];
        {
          mbar_wait(full0 + 8 * s, ph);
          if (mine) {
            const uint32_t hp = base + C::I_RING + s * C::I_SLOT + wg * 2 * C::ST;
            float R[DS / 2];
            wgmma_fence();
            // R = dy_i h_in: hi hi, hi lo, lo hi
#pragma unroll
            for (int p = 0; p < 3; ++p)
#pragma unroll
              for (int kk = 0; kk < HD / 16; ++kk)
                wgmma_sst<DS, 0, 1>(R, IH::kdesc(p == 2 ? dyl : dyh, 64, kk),
                                    IS::mdesc(hp + (p == 1 ? C::ST : 0), HD, kk), p + kk > 0);
            wgmma_commit();
            wgmma_wait_all();
            fence_regs<DS / 2>(R);
            fence_regs<DS / 2>(dC);
#pragma unroll
            for (int q2 = 0; q2 < 2; ++q2) {
              const float ei = i0 + il[q2] < L ? ex2(csi[q2]) : 0.f;
              float sdot = 0.f;
#pragma unroll
              for (int n = 0; n < DS / 8; ++n) {
                const float2 cv = IS::pair(gci, 64, il[q2], 8 * n + 2 * tid);
                const float v0 = ei * R[4 * n + 2 * q2], v1 = ei * R[4 * n + 2 * q2 + 1];
                sdot = fmaf(v0, cv.x, fmaf(v1, cv.y, sdot));
                dC[4 * n + 2 * q2] += v0;
                dC[4 * n + 2 * q2 + 1] += v1;
              }
              rowg[q2] = sdot;
            }
          }
          release(empty0 + 8 * s);
          next();
        }
        bool pending = false;
        int prev = 0;
        for (int jb = 0; jb <= it.blk; ++jb) {
          const int j0 = 64 * jb;
          mbar_wait(full0 + 8 * s, ph);
          if (mine) {
            const uint32_t st = base + C::I_RING + s * C::I_SLOT;
            const uint32_t xj = st + C::BC + C::CB + wg * C::X;
            const unsigned char* gst = gb + (st - base);
            const float* csj = reinterpret_cast<const float*>(gst + C::BC + C::CB + 2 * C::X +
                                                              wg * C::ROWS);
            const float* dtj = csj + 2 * 64;
            wgmma_fence();
            // dM = dy_i x_j^T, dy_i's two planes
#pragma unroll
            for (int pl = 0; pl < 2; ++pl)
#pragma unroll
              for (int kk = 0; kk < HD / 16; ++kk)
                wgmma_ss<64>(dm, IH::kdesc(pl ? dyl : dyh, 64, kk), IH::kdesc(xj, 64, kk),
                             pl + kk > 0);
            wgmma_commit();
            wgmma_wait_all();
            fence_regs<32>(dm);
            fence_regs<DS / 2>(dC);
            if (pending) release(empty0 + 8 * prev);
            // P: row i (the thread's two), column j = j0 + 8n + 2 tid + (e & 1),
            // a k-step at a time as on the j side: dC += P B_j (hi, lo)
            uint32_t pa[4][4], pb[4][4];
#pragma unroll
            for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
              for (int n = 2 * kb; n < 2 * kb + 2; ++n) {
                const int j2 = 8 * n + 2 * tid;  // the thread's two columns j2, j2 + 1
                const float2 cj = *reinterpret_cast<const float2*>(csj + j2);
                const float2 tj = *reinterpret_cast<const float2*>(dtj + j2);
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                  const float2 cb2 = *reinterpret_cast<const float2*>(cb_at(gst + C::BC, il[q], j2));
#pragma unroll
                  for (int k = 0; k < 2; ++k) {
                    // on: j <= i (rows past L are never written out); off pairs take
                    // ex = 0, and CB is finite there (zeroed past L in a ragged chunk)
                    const int e = 2 * q + k;
                    const bool on = j2 + k <= i0 + il[q] - j0;
                    const float ex = on ? ex2(csi[q] - (k ? cj.y : cj.x)) : 0.f;  // masked first
                    const float exd = ex * (k ? tj.y : tj.x);
                    rowg[q] = fmaf(dm[4 * n + e], (k ? cb2.y : cb2.x) * exd, rowg[q]);  // G = dM M
                    dm[4 * n + e] *= exd;
                  }
                }
              }
              split_frags(dm, kb, pa[kb], pb[kb]);
              wgmma_fence();
              wgmma_rs<DS>(dC, pa[kb], IS::mdesc(st, 64, kb));
              wgmma_rs<DS>(dC, pb[kb], IS::mdesc(st, 64, kb));
            }
            wgmma_commit();
            pending = true;
            prev = s;
          } else {
            release(empty0 + 8 * s);
          }
          next();
        }
        if (pending) {
          wgmma_wait_all();
          fence_regs<DS / 2>(dC);
          release(empty0 + 8 * prev);
        }
        release(hb_empty + 8 * buf);
        if (mine) {
          const long long rb = (static_cast<long long>(b) * gm.nh + h) * gm.S + s0 + i0;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float g = quad_sum(rowg[q]);
            if (tid == 0 && i0 + il[q] < L) gm.r0[rb + il[q]] = g;
          }
        }
      }
      release(ci_empty + 8 * cc);
      float* part = gm.part + ((static_cast<long long>(b) * gm.ng + it.g) * gm.S + s0 + i0) * DS;
      if (wg == 1) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (i0 + il[q] < L)
#pragma unroll
            for (int n = 0; n < DS / 8; ++n)
              *reinterpret_cast<float2*>(part + il[q] * DS + 8 * n + 2 * tid) =
                  make_float2(dC[4 * n + 2 * q], dC[4 * n + 2 * q + 1]);
        __threadfence_block();
      }
      named_sync(1);
      if (wg == 0) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (i0 + il[q] < L)
#pragma unroll
            for (int n = 0; n < DS / 8; ++n) {
              float2* p = reinterpret_cast<float2*>(part + il[q] * DS + 8 * n + 2 * tid);
              const float2 o = *p;
              *p = make_float2(dC[4 * n + 2 * q] + o.x, dC[4 * n + 2 * q + 1] + o.y);
            }
      }
    }
  }
}

// sum of v over the CTA's threads in a fixed order (a butterfly in each
// warp, then the warps in order), returned to every thread
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;
}

// The tail, per (b, head, chunk), a thread a row: d cs from its row and
// column parts and, at the chunk's last row, exp(T) <dH_out, h_in> + sum_j
// w_j u_j; dl its reverse cumsum (the warp scan over the reversed rows); ddt
// = the direct part + a dl; the chunk's dA = dt . dl, summed over the chunks
// by ssd_bwd_sum_kernel.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_tail_kernel(const TcGeom gm, const float* __restrict__ A, long long ab,
                    const float* __restrict__ dotw, int nw, const float* __restrict__ dcs_row,
                    float* __restrict__ ddt, float* __restrict__ dAc) {
  __shared__ float rev_s[THREADS], scan_s[THREADS], warp_tot[8], red[8];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x, L = gm.L;
  const long long bhc = (static_cast<long long>(b) * gm.nh + h) * gm.nc + c;
  const long long row = (static_cast<long long>(b) * gm.nh + h) * gm.S + c * L + t;
  const bool in = t < L;
  float v = in ? dcs_row[row] + gm.r0[row] : 0.f;
  const float wu = block_sum(in ? gm.r2[row] : 0.f, red);
  if (t == L - 1) {
    float d = 0.f;
    for (int k = 0; k < nw; ++k) d += dotw[bhc * nw + k];
    v += expf(gm.totals[bhc]) * d + wu;
  }
  if (in) rev_s[L - 1 - t] = v;
  __syncthreads();
  chunk_cumsum(rev_s, 1.f, scan_s, warp_tot, L);  // scan_s[r]: rows L-1-r .. L-1
  const float dl = in ? scan_s[L - 1 - t] : 0.f;
  const float dtv = in ? gm.dtc[bhc * gm.LP + t] : 0.f;
  if (in)
    ddt[(static_cast<long long>(b) * gm.S + c * L + t) * gm.nh + h] = gm.r1[row] +
                                                                    A[b * ab + h] * dl;
  const float da = block_sum(dtv * dl, red);
  if (t == 0) dAc[bhc] = da;
}

// the tensor-core route takes bf16 with d_state >= 64 and chunks <= 256
bool tc_route(int dtype, int ds, int L) { return dtype == 1 && ds >= 64 && L <= kMaxL; }

constexpr long long rup(long long n) { return (n + 255) / 256 * 256; }  // whole KB of floats

// The tensor-core route's workspace, in floats, each region whole KB:
// the chunks' own state terms (Bb, nh, nc, hd, ds); the chunk totals and dA
// parts (Bb, nh, nc) each; cs and dt (Bb, nh, nc, LP) each; dy's planes (Bb, nh, nc,
// LP, hd) bf16 pairs; dH_out's and h_in's planes (Bb, nh, nc, hd, ds) bf16
// pairs each; CB (Bb, nc, L, ldc); <dH_out, h_in>'s warp partials (Bb, nh,
// nc, hd ds / 128); d cs's row and column parts, ddt's direct part and
// w u (Bb, nh, S) each; the head groups' dB and dC (Bb, ng, S, ds) each.
struct TcWs {
  float *dstate, *totals, *dAc, *cs, *dtc, *cb, *dotw, *dcs_row, *dcs_col, *ddt_dir, *wu, *dBp, *dCp;
  bf16 *dyp, *dhp, *hinp;
  long long floats;
};

TcWs tc_workspace(float* ws, int Bb, int S, int nh, int hd, int ds, int L, int G) {
  const long long nc = S / L, LP = (L + 63) / 64 * 64, ldc = (L + 3) & ~3;
  const long long bhc = static_cast<long long>(Bb) * nh * nc, ng = (nh + G - 1) / G;
  const long long sizes[16] = {bhc * hd * ds, bhc, bhc, bhc * LP, bhc * LP, bhc * LP * hd,
                               bhc * hd * ds, bhc * hd * ds, Bb * nc * L * ldc,
                               bhc * hd * ds / 128, 1LL * Bb * nh * S, 1LL * Bb * nh * S,
                               1LL * Bb * nh * S, 1LL * Bb * nh * S, ng * Bb * S * ds,
                               ng * Bb * S * ds};
  float* p[16];
  long long at = 0;
  for (int k = 0; k < 16; ++k) {
    p[k] = ws ? ws + at : nullptr;
    at += rup(sizes[k]);
  }
  TcWs w;
  w.dstate = p[0]; w.totals = p[1]; w.dAc = p[2]; w.cs = p[3]; w.dtc = p[4];
  w.dyp = reinterpret_cast<bf16*>(p[5]);
  w.dhp = reinterpret_cast<bf16*>(p[6]);
  w.hinp = reinterpret_cast<bf16*>(p[7]);
  w.cb = p[8]; w.dotw = p[9]; w.dcs_row = p[10]; w.dcs_col = p[11]; w.ddt_dir = p[12];
  w.wu = p[13]; w.dBp = p[14]; w.dCp = p[15];
  w.floats = at;
  return w;
}

// The FMA route's workspace (floats): each chunk's own state term, then its
// dH_out (Bb, nh, nc, HD, DS); the chunk totals and dA partials (Bb, nh,
// nc) each; the per-head dB and dC (Bb, nh, S, DS)
long long fma_workspace(int Bb, int S, int nh, int hd, int ds, int L) {
  const long long nc = S / L, bh = static_cast<long long>(Bb) * nh;
  return bh * nc * hd * ds + 2 * bh * nc + 2 * bh * S * ds;
}

template <typename T, int HD, int DS>
int launch_fma(const T* x, const float* dt, const float* A, const T* Bm, const T* Cm,
               const float* hin, const float* dy, const float* dhf, T* dx, float* ddt,
               float* dA, T* dB, T* dC, float* dh0, float* ws, int Bb, int S, int nh, int L,
               const Strides& st, cudaStream_t stream) {
  const int nc = S / L;
  const long long bh = static_cast<long long>(Bb) * nh;
  float* dstate = ws;
  float* totals = dstate + bh * nc * HD * DS;
  float* dAc = totals + bh * nc;
  float* dBp = dAc + bh * nc;
  float* dCp = dBp + bh * S * DS;
  const dim3 grid(nc, nh, Bb);
  static int cap_d[64], cap_c[64];
  cudaError_t err = allow_smem(ssd_bwd_dstate_kernel<T, HD, DS>, dstate_smem<HD, DS>(L), cap_d);
  if (err == cudaSuccess)
    err = allow_smem(ssd_bwd_chunk_kernel<T, HD, DS>, chunk_smem<HD, DS>(L), cap_c);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dstate_kernel<T, HD, DS><<<grid, THREADS, dstate_smem<HD, DS>(L), stream>>>(
      dy, dt, A, Cm, dstate, totals, S, nh, L, st);
  constexpr int E = HD * DS;
  ssd_bwd_pass_kernel<<<dim3((E + 4 * THREADS - 1) / (4 * THREADS), nh, Bb), THREADS, 0,
                        stream>>>(dhf, dstate, totals, dh0, nc, E, nullptr, nullptr, nullptr,
                                  nullptr, HD, DS);
  ssd_bwd_chunk_kernel<T, HD, DS><<<grid, THREADS, chunk_smem<HD, DS>(L), stream>>>(
      x, dt, A, Bm, Cm, hin, dy, dstate, dx, ddt, dBp, dCp, dAc, S, nh, L, st);
  const long long N = static_cast<long long>(S) * DS;
  ssd_bwd_sum_kernel<T><<<dim3(static_cast<unsigned>((N + THREADS - 1) / THREADS), Bb),
                          THREADS, 0, stream>>>(dBp, dCp, dAc, dB, dC, dA, nh, nh, nc, N);
  return static_cast<int>(cudaGetLastError());
}

// a tensor map over a model tensor of rows of `width` bf16 (the rows of
// batch b at byte stride rs, batches at bs, heads at hs where `heads`), a
// box of 64 rows by one swizzle row
int map_rows(CUtensorMap* map, const void* p, int width, int S, int heads, int Bb, long long rs,
             long long hs, long long bs) {
  const int atom = width >= 64 ? 64 : 32;
  const CUtensorMapSwizzle sw = atom == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint64_t e = sizeof(bf16);
  if (heads > 0) {
    const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)S, (cuuint64_t)heads,
                                (cuuint64_t)Bb};
    const cuuint64_t strides[3] = {rs * e, hs * e, bs * e};
    const cuuint32_t box[4] = {(cuuint32_t)atom, 64, 1, 1};
    return encode_map(map, p, 4, dims, strides, box, sw);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)S, (cuuint64_t)Bb};
  const cuuint64_t strides[2] = {rs * e, bs * e};
  const cuuint32_t box[3] = {(cuuint32_t)atom, 64, 1};
  return encode_map(map, p, 3, dims, strides, box, sw);
}

template <int HD, int DS>
int launch_tc(const bf16* x, const float* dt, const float* A, const bf16* Bm, const bf16* Cm,
              const float* hin, const float* dy, const float* dhf, bf16* dx, float* ddt,
              float* dA, bf16* dB, bf16* dC, float* dh0, float* ws, int Bb, int S, int nh,
              int L, const Strides& st, bool vec, const int* order, int j_grid, int i_grid,
              int G, cudaStream_t stream) {
  using C = TcCfg<HD, DS>;
  const int nc = S / L, nb = (L + 63) / 64, LP = 64 * nb, ldc = (L + 3) & ~3;
  if (order == nullptr || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int ng = (nh + G - 1) / G;
  const long long items = static_cast<long long>(Bb) * nc * nb * ng;
  if (items > 0x7fffffffLL || j_grid < 1 || j_grid > items || i_grid < 1 || i_grid > items)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const TcWs w = tc_workspace(ws, Bb, S, nh, HD, DS, L, G);
  static int cap_p[64], cap_j[64], cap_i[64];
  cudaError_t err = allow_smem(ssd_bwd_prep_kernel<HD, DS>, C::P_SMEM, cap_p);
  if (err == cudaSuccess) err = allow_smem(ssd_bwd_jside_kernel<HD, DS>, C::J_SMEM, cap_j);
  if (err == cudaSuccess) err = allow_smem(ssd_bwd_iside_kernel<HD, DS>, C::I_SMEM, cap_i);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mx, mb, mc, mcb;
  memset(&mx, 0, sizeof(mx));
  memset(&mb, 0, sizeof(mb));
  memset(&mc, 0, sizeof(mc));
  if (vec) {
    if (int r = map_rows(&mx, x, HD, S, nh, Bb, st.xs, st.xh, st.xb)) return r;
    if (int r = map_rows(&mb, Bm, DS, S, 0, Bb, st.bs, 0, st.bb)) return r;
    if (int r = map_rows(&mc, Cm, DS, S, 0, Bb, st.cs, 0, st.cb)) return r;
  }
  {
    const cuuint64_t dims[3] = {(cuuint64_t)ldc, (cuuint64_t)L, (cuuint64_t)Bb * nc};
    const cuuint64_t strides[2] = {(cuuint64_t)ldc * 4, (cuuint64_t)L * ldc * 4};
    const cuuint32_t box[3] = {32, 64, 1};
    if (int r = encode_map(&mcb, w.cb, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
      return r;
  }
  if (L % 64) {  // the i side reads CB past L in the last block (times 0): make it 0
    err = cudaMemsetAsync(w.cb, 0, sizeof(float) * Bb * nc * L * ldc, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_cb_kernel<DS><<<dim3(nb * (nb + 1) / 2, nc, Bb), THREADS, 0, stream>>>(Bm, Cm, w.cb, L,
                                                                             ldc, st, vec);
  ssd_bwd_prep_kernel<HD, DS><<<dim3(nc, nh, Bb), THREADS, C::P_SMEM, stream>>>(
      dy, dt, A, Cm, w.dstate, w.totals, w.cs, w.dtc, w.dyp, S, nh, L, LP, st, vec);
  constexpr int E = HD * DS;
  ssd_bwd_pass_kernel<<<dim3(E / (4 * THREADS), nh, Bb), THREADS, 0, stream>>>(
      dhf, w.dstate, w.totals, dh0, nc, E, hin, w.dhp, w.hinp, w.dotw, HD, DS);
  TcGeom gj;
  gj.Bb = Bb; gj.S = S; gj.nh = nh; gj.L = L; gj.nc = nc; gj.nb = nb; gj.ng = ng; gj.G = G;
  gj.items = static_cast<int>(items); gj.bcg = Bb * nc * ng; gj.LP = LP;
  gj.order = order; gj.cs = w.cs; gj.dtc = w.dtc; gj.totals = w.totals; gj.dyp = w.dyp;
  gj.stp = w.dhp; gj.dx = dx; gj.part = w.dBp;
  gj.r0 = w.dcs_col; gj.r1 = w.ddt_dir; gj.r2 = w.wu;
  gj.xm = x; gj.bm = Bm; gj.cm = Cm;
  gj.xb = st.xb; gj.xs = st.xs; gj.xh = st.xh; gj.bb = st.bb; gj.bs = st.bs; gj.cb = st.cb;
  gj.cs_ = st.cs; gj.vec = vec ? 1 : 0;
  TcGeom gi = gj;
  gi.stp = w.hinp; gi.part = w.dCp; gi.r0 = w.dcs_row; gi.r1 = gi.r2 = nullptr;
  ssd_bwd_jside_kernel<HD, DS><<<j_grid, kThreadsTc, C::J_SMEM, stream>>>(mx, mb, mc, mcb, gj);
  ssd_bwd_iside_kernel<HD, DS><<<i_grid, kThreadsTc, C::I_SMEM, stream>>>(mx, mb, mc, mcb, gi);
  ssd_bwd_tail_kernel<<<dim3(nc, nh, Bb), THREADS, 0, stream>>>(gj, A, st.ab, w.dotw, E / 128,
                                                                 w.dcs_row, ddt, w.dAc);
  const long long N = static_cast<long long>(S) * DS;
  ssd_bwd_sum_kernel<bf16><<<dim3(static_cast<unsigned>((N + THREADS - 1) / THREADS), Bb),
                             THREADS, 0, stream>>>(w.dBp, w.dCp, w.dAc, dB, dC, dA, ng, nh, nc,
                                                   N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int DS>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const float* hin, const float* dy, const float* dhf, void* dx, float* ddt,
           float* dA, void* dB, void* dC, float* dh0, float* ws, int Bb, int S, int nh,
           int L, const Strides& st, bool vec, const int* order, int j_grid, int i_grid, int G,
           cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16> && DS >= 64) {
    if (L <= kMaxL)
      return launch_tc<HD, DS>(static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
                               static_cast<const bf16*>(Cm), hin, dy, dhf, static_cast<bf16*>(dx),
                               ddt, dA, static_cast<bf16*>(dB), static_cast<bf16*>(dC), dh0, ws,
                               Bb, S, nh, L, st, vec, order, j_grid, i_grid, G, stream);
  }
  return launch_fma<T, HD, DS>(static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
                               static_cast<const T*>(Cm), hin, dy, dhf, static_cast<T*>(dx), ddt,
                               dA, static_cast<T*>(dB), static_cast<T*>(dC), dh0, ws, Bb, S, nh,
                               L, st, stream);
}

}  // namespace

extern "C" {

// Floats of workspace `ssd_scan_bwd_launch` needs at this shape, dtype (0
// f32, 1 bf16) and head-group size.
long long ssd_scan_bwd_workspace(int Bb, int S, int nh, int hd, int ds, int L, int dtype,
                                 int group) {
  if (tc_route(dtype, ds, L))
    return tc_workspace(nullptr, Bb, S, nh, hd, ds, L, group < 1 ? 1 : group).floats;
  return fma_workspace(Bb, S, nh, hd, ds, L);
}

// The tensor-core route's shared memory for (hd, ds), which the host's plan
// (kernels/ssd_scan.py::bwd_plan) mirrors: out = {j-side kernel's bytes,
// i-side kernel's, pre-pass's, ring slots of each main kernel}. Returns 0,
// or cudaErrorInvalidValue for a pair the route does not take.
int ssd_scan_bwd_config(int hd, int ds, int* out) {
  auto fill = [&](auto cfg) {
    using C = decltype(cfg);
    out[0] = C::J_SMEM;
    out[1] = C::I_SMEM;
    out[2] = C::P_SMEM;
    out[3] = kStages;
    return 0;
  };
  if (hd == 32 && ds == 64) return fill(TcCfg<32, 64>{});
  if (hd == 32 && ds == 128) return fill(TcCfg<32, 128>{});
  if (hd == 64 && ds == 64) return fill(TcCfg<64, 64>{});
  if (hd == 64 && ds == 128) return fill(TcCfg<64, 128>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// The inputs as ssd_scan_launch takes them (x, B, C f32 or bf16 by
// `dtype`, through `strides`, the eleven of Strides; A (nh,) or (Bb, nh)),
// hin the forward's entering states (Bb, nh, S / L, hd, ds), dy
// (Bb, S, nh, hd) and dhf (Bb, nh, hd, ds, or null: zeros), f32 contiguous
// and 16-byte aligned. Writes dx (Bb, S, nh, hd), dB and dC (Bb, S, ds) in
// x's dtype, ddt (Bb, S, nh), dA (Bb, nh: each batch row's part) and dh0
// (Bb, nh, hd, ds) in f32, all contiguous. `ws` is ssd_scan_bwd_workspace
// floats, 16-byte aligned; `vec` says every row of x, B and C is 16-byte
// aligned. The tensor-core route also takes the plan's `order` (int32 on the
// device: the j blocks, then the i blocks, longest walk first), its grids
// (1 to the work items each) and head-group size; the FMA route ignores
// them. Launches on `stream` and does not synchronise; returns the launch
// error, 1000 + the CUresult of a tensor map that could not be encoded, or 0.
int ssd_scan_bwd_launch(const void* x, const float* dt, const float* A, const void* Bm,
                        const void* Cm, const float* hin, const float* dy, const float* dhf,
                        void* dx, float* ddt, float* dA, void* dB, void* dC, float* dh0,
                        float* ws, int Bb, int S, int nh, int hd, int ds, int L,
                        const long long* strides, int dtype, int vec, const int* order,
                        int j_grid, int i_grid, int group, cudaStream_t stream) {
  Strides st{strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
             strides[6], strides[7], strides[8], strides[9], strides[10]};
#define SSD_BWD_CASE(T_, HD_, DS_)                                                       \
  if (hd == HD_ && ds == DS_)                                                            \
    return launch<T_, HD_, DS_>(x, dt, A, Bm, Cm, hin, dy, dhf, dx, ddt, dA, dB, dC, dh0, \
                                ws, Bb, S, nh, L, st, vec != 0, order, j_grid, i_grid,   \
                                group, stream);
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
