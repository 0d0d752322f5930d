// K4's backward on Hopper: the gradients dq, dk and dv of causal GQA flash
// attention (full, sliding or chunked masks) from q, k, v, the forward's
// output o, its per-row log-sum-exp lse and the output gradient do.
//
// It replaces no TPU kernel: the reference's Pallas kernel
// (src/repro/kernels/flash_attention.py::flash_attention) has no VJP, and the
// reference trains with it switched off, differentiating its jnp attention.
// The port's training forward is K4 itself (flash_attention.cu, with lse),
// so its gradient is this kernel: the formulas of FlashAttention-2's
// backward, P recomputed from lse instead of stored.
//
//   P  = exp(s * scale - lse) on allowed pairs, 0 elsewhere (the forward's
//        -1e30 sentinel gives exactly 0 there)
//   dV = P^T dO          dP = dO V^T          Dl = rowsum(dO o o) (f32)
//   dS = P o (dP - Dl)   dQ = scale dS K      dK = scale dS^T Q
//
// Three kernels, run in this order by one C call:
//  - delta_kernel: Dl for every row, one warp a row, in f32.
//  - dkdv: one CTA per key tile of one (batch, kv head), walking all G
//    query heads of its kv head and, for each, the query tiles that can see
//    its keys, in a fixed order. dK and dV stay in f32 registers over the
//    whole walk and are written once, so the GQA sum over G needs no
//    atomics and a launch repeats bitwise.
//  - dq: one CTA per query tile of one (batch, query head), walking the key
//    tiles its rows can see; dQ written once.
// No float atomics anywhere. The mask is the forward's predicate
// (allowed(): k <= q; sliding k > q - window; chunked k / window ==
// q / window), and key or query tiles wholly outside it are skipped.
//
// bf16: mma.sync m16n8k16 (mma_tiles.cuh) with f32 accumulators, four warps
// of 16 rows each; q, k, v, o and do tiles are staged in padded shared
// rows and reach the tensor cores through ldmatrix. P and dS are rounded to
// bf16 as the operands of their products; the score, exp and the
// dP - Dl step are f32. f32: plain FMA, 256 threads, 32 x 32 pair tiles.
//
// Bound on the H100: the five products of 2 D flops over each causal
// (query, key) pair of every query head, 10 D flops a pair (the dK/dV
// kernel does S, dV, dP and dK; the dQ kernel recomputes S and dP and does
// dQ: seven products here), against reading q, k, v, o, do and writing dq,
// dk, dv once: bound by operations at the training shape.
//
// Plain C interface for ctypes: flash_attention_bwd_launch returns the CUDA
// error of the first launch that failed (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct BwdGeom {
  int Hk, G, S, kind, window;
  float scale;
  long long q_b, q_h, q_g, q_s;
  long long k_b, k_h, k_s;
  long long v_b, v_h, v_s;
  long long o_b, o_h, o_g, o_s;
  long long do_b, do_h, do_g, do_s;
  long long dq_b, dq_h, dq_g, dq_s;
  long long dk_b, dk_h, dk_s;
  long long dv_b, dv_h, dv_s;
};

__device__ __forceinline__ bool allowed(int qp, int kp, int kind, int window) {
  bool ok = kp <= qp;
  if (kind == 1 && window > 0) ok = ok && kp > qp - window;
  else if (kind == 2 && window > 0) ok = ok && (kp / window) == (qp / window);
  return ok;
}

// first key any of the query positions [qmin, ...] may attend to
__device__ __forceinline__ int first_key(int qmin, int kind, int window) {
  if (kind == 1 && window > 0) return max(0, qmin - window + 1);
  if (kind == 2 && window > 0) return (qmin / window) * window;
  return 0;
}

// last query position that may attend to any of the keys [..., kmax]
__device__ __forceinline__ int last_query(int kmax, int S, int kind, int window) {
  if (kind == 1 && window > 0) return min(S - 1, kmax + window - 1);
  if (kind == 2 && window > 0) return min(S - 1, (kmax / window + 1) * window - 1);
  return S - 1;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// Dl = rowsum(do o o): one warp a (b, h, g, position) row, lanes over D in a
// fixed order, then a butterfly; rows in the order of lse (B, Hk, G, S).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             int B, int D, BwdGeom gm) {
  const long long rows = static_cast<long long>(B) * gm.Hk * gm.G * gm.S;
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int s = static_cast<int>(row % gm.S);
  const long long bhg = row / gm.S;
  const int g = static_cast<int>(bhg % gm.G);
  const long long bh = bhg / gm.G;
  const int h = static_cast<int>(bh % gm.Hk), b = static_cast<int>(bh / gm.Hk);
  const T* orow = o + b * gm.o_b + h * gm.o_h + g * gm.o_g + s * gm.o_s;
  const T* drow = dout + b * gm.do_b + h * gm.do_h + g * gm.do_g + s * gm.do_s;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(orow[d]), to_f(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// bf16 route: 128 threads, warp w owns rows 16w .. 16w + 15 of its tile.
// Fragment layouts (PTX ISA, mma.m16n8k16; gid = lane / 4, t4 = lane % 4):
//   accumulator c[n][0, 1] (row gid, cols 8n + 2 t4, +1), c[n][2, 3] (row
//   gid + 8, the same cols), so n-tiles 2j, 2j + 1 are the A registers of
//   k-step j of a product whose k runs over these columns.
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;  // keys of a dK/dV CTA, queries of a dQ CTA

template <int D>
struct Bf16Cfg {
  static constexpr int LD = D + 8;  // padded row: an odd number of 16-byte units
  // queries per step of the dK/dV walk (32 at D = 128 keeps dK, dV, S and
  // dP of a warp in registers)
  static constexpr int BM = D == 128 ? 32 : 64;
  static constexpr int BN = 64;  // keys per step of the dQ walk
  static constexpr int DKDV_SMEM = (2 * kTile + 2 * BM) * LD * 2 + 2 * BM * 4;
  static constexpr int DQ_SMEM = (2 * kTile + 2 * BN) * LD * 2 + 2 * kTile * 4;
};

// rows [r0, r0 + ROWS) of a strided bf16 (rows, D) view into a padded
// shared tile, zeros past row n; 16-byte loads (rows 16-byte aligned)
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int r0, int n) {
  constexpr int CH = D / 8, LD = D + 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

// acc (16 x 8 NT) = A (16 rows of `a` from row a0, k = D) * B^T, B the
// (8 NT, D) rows of `b`: the k dimension contiguous in both tiles
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const __nv_bfloat16* a, int a0,
                                        const __nv_bfloat16* b, int lane) {
  constexpr int LD = D + 8;
  const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm(af, a + (a0 + (mi & 1) * 8 + rr) * LD + 16 * kk + (mi >> 1) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bq[4];
      ldsm(bq, b + (16 * np + (mi >> 1) * 8 + rr) * LD + 16 * kk + (mi & 1) * 8);
      mma(acc[2 * np], af, bq[0], bq[1]);
      mma(acc[2 * np + 1], af, bq[2], bq[3]);
    }
  }
}

// acc (16 x D) += A (16 x 16 KS, bf16 fragments) * B, B the (16 KS, D)
// rows of `b` (D contiguous)
template <int D, int KS>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const uint32_t (&af)[KS][4],
                                       const __nv_bfloat16* b, int lane) {
  constexpr int LD = D + 8;
  const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bq[4];
      ldsm_t(bq, b + (16 * j + (mi & 1) * 8 + rr) * LD + 16 * np + (mi >> 1) * 8);
      mma(acc[2 * np], af[j], bq[0], bq[1]);
      mma(acc[2 * np + 1], af[j], bq[2], bq[3]);
    }
}

// the A fragments of an accumulator whose columns are the next product's k
template <int NT>
__device__ __forceinline__ void to_frags(uint32_t (&af)[NT / 2][4], const float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    af[n / 2][(n & 1) * 2 + 0] = pack_bf16(acc[n][0], acc[n][1]);
    af[n / 2][(n & 1) * 2 + 1] = pack_bf16(acc[n][2], acc[n][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, BwdGeom gm) {
  using C = Bf16Cfg<D>;
  constexpr int LD = C::LD, BM = C::BM, NT = BM / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kTile * LD;
  __nv_bfloat16* Qs = Vs + kTile * LD;
  __nv_bfloat16* Ds = Qs + BM * LD;  // do
  float* ls = reinterpret_cast<float*>(Ds + BM * LD);  // lse in log2 units
  float* dl = ls + BM;

  const int S = gm.S, G = gm.G, kind = gm.kind, w = gm.window;
  const int bh = blockIdx.x, b = bh / gm.Hk, h = bh % gm.Hk;
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4, t4 = lane % 4;
  const float c = gm.scale * kLog2e;
  load_tile<D, kTile>(Ks, k + b * gm.k_b + h * gm.k_h, gm.k_s, k0, S);
  load_tile<D, kTile>(Vs, v + b * gm.v_b + h * gm.v_h, gm.v_s, k0, S);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const int kp_lo = k0 + 16 * warp + gid, kp_hi = kp_lo + 8;
  const int q_first = k0 / BM * BM;
  const int q_last = last_query(min(k0 + kTile - 1, S - 1), S, kind, w);

  for (int g = 0; g < G; ++g) {
    const long long rb = (static_cast<long long>(bh) * G + g) * S;  // lse / delta row base
    for (int q0 = q_first; q0 <= q_last; q0 += BM) {
      __syncthreads();  // every warp is done with the previous tile
      load_tile<D, BM>(Qs, q + b * gm.q_b + h * gm.q_h + g * gm.q_g, gm.q_s, q0, S);
      load_tile<D, BM>(Ds, dout + b * gm.do_b + h * gm.do_h + g * gm.do_g, gm.do_s, q0, S);
      for (int i = threadIdx.x; i < BM; i += kThreads) {
        const bool in = q0 + i < S;
        ls[i] = in ? lse[rb + q0 + i] * kLog2e : 0.f;
        dl[i] = in ? delta[rb + q0 + i] : 0.f;
      }
      __syncthreads();
      // S^T = K Q^T (16 keys x BM queries a warp), then P^T in place
      float sa[NT][4];
      mma_abt<D, NT>(sa, Ks, 16 * warp, Qs, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * n + 2 * t4 + (e & 1), qp = q0 + qi;
          const int kp = e < 2 ? kp_lo : kp_hi;
          sa[n][e] = (qp < S && allowed(qp, kp, kind, w)) ? ex2(fmaf(sa[n][e], c, -ls[qi])) : 0.f;
        }
      {  // dV += P^T dO
        uint32_t pf[NT / 2][4];
        to_frags<NT>(pf, sa);
        mma_ab<D, NT / 2>(dva, pf, Ds, lane);
      }
      // dP^T = V dO^T, then dS^T = P^T o (dP^T - Dl)
      float dp[NT][4];
      mma_abt<D, NT>(dp, Vs, 16 * warp, Ds, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * n + 2 * t4 + (e & 1);
          dp[n][e] = sa[n][e] * (dp[n][e] - dl[qi]);
        }
      {  // dK += dS^T Q
        uint32_t sf[NT / 2][4];
        to_frags<NT>(sf, dp);
        mma_ab<D, NT / 2>(dka, sf, Qs, lane);
      }
    }
  }
  __nv_bfloat16* dkb = dk + b * gm.dk_b + h * gm.dk_h;
  __nv_bfloat16* dvb = dv + b * gm.dv_b + h * gm.dv_h;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kp = rr ? kp_hi : kp_lo;
    if (kp >= S) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int d = 8 * n + 2 * t4;
      *reinterpret_cast<uint32_t*>(dkb + kp * gm.dk_s + d) =
          pack_bf16(dka[n][2 * rr] * gm.scale, dka[n][2 * rr + 1] * gm.scale);
      *reinterpret_cast<uint32_t*>(dvb + kp * gm.dv_s + d) =
          pack_bf16(dva[n][2 * rr], dva[n][2 * rr + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, BwdGeom gm) {
  using C = Bf16Cfg<D>;
  constexpr int LD = C::LD, BN = C::BN, NT = BN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ds = Qs + kTile * LD;  // do
  __nv_bfloat16* Ks = Ds + kTile * LD;
  __nv_bfloat16* Vs = Ks + BN * LD;
  float* ls = reinterpret_cast<float*>(Vs + BN * LD);  // lse in log2 units
  float* dl = ls + kTile;

  const int S = gm.S, G = gm.G, kind = gm.kind, w = gm.window;
  const int bhg = blockIdx.x, g = bhg % G, bh = bhg / G, b = bh / gm.Hk, h = bh % gm.Hk;
  const int q0 = blockIdx.y * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4, t4 = lane % 4;
  const float c = gm.scale * kLog2e;
  const long long rb = static_cast<long long>(bhg) * S;
  load_tile<D, kTile>(Qs, q + b * gm.q_b + h * gm.q_h + g * gm.q_g, gm.q_s, q0, S);
  load_tile<D, kTile>(Ds, dout + b * gm.do_b + h * gm.do_h + g * gm.do_g, gm.do_s, q0, S);
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const bool in = q0 + i < S;
    ls[i] = in ? lse[rb + q0 + i] * kLog2e : 0.f;
    dl[i] = in ? delta[rb + q0 + i] : 0.f;
  }
  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
  const int r_lo = 16 * warp + gid, r_hi = r_lo + 8;
  const int qp_lo = q0 + r_lo, qp_hi = q0 + r_hi;
  const int k_first = first_key(q0, kind, w) / BN * BN;
  const int k_last = min(q0 + kTile - 1, S - 1);
  const __nv_bfloat16* kb = k + b * gm.k_b + h * gm.k_h;
  const __nv_bfloat16* vb = v + b * gm.v_b + h * gm.v_h;

  for (int kt = k_first; kt <= k_last; kt += BN) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D, BN>(Ks, kb, gm.k_s, kt, S);
    load_tile<D, BN>(Vs, vb, gm.v_s, kt, S);
    __syncthreads();
    // S = Q K^T (16 queries x BN keys a warp), then P in place
    float sa[NT][4];
    mma_abt<D, NT>(sa, Qs, 16 * warp, Ks, lane);
    const float l_lo = ls[r_lo], l_hi = ls[r_hi], d_lo = dl[r_lo], d_hi = dl[r_hi];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kt + 8 * n + 2 * t4 + (e & 1), qp = e < 2 ? qp_lo : qp_hi;
        sa[n][e] = (qp < S && allowed(qp, kp, kind, w))
                       ? ex2(fmaf(sa[n][e], c, -(e < 2 ? l_lo : l_hi))) : 0.f;
      }
    // dP = dO V^T, then dS = P o (dP - Dl)
    float dp[NT][4];
    mma_abt<D, NT>(dp, Ds, 16 * warp, Vs, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = sa[n][e] * (dp[n][e] - (e < 2 ? d_lo : d_hi));
    uint32_t sf[NT / 2][4];
    to_frags<NT>(sf, dp);
    mma_ab<D, NT / 2>(dqa, sf, Ks, lane);  // dQ += dS K
  }
  __nv_bfloat16* dqb = dq + b * gm.dq_b + h * gm.dq_h + g * gm.dq_g;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qp = rr ? qp_hi : qp_lo;
    if (qp >= S) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dqb + qp * gm.dq_s + 8 * n + 2 * t4) =
          pack_bf16(dqa[n][2 * rr] * gm.scale, dqa[n][2 * rr + 1] * gm.scale);
  }
}

// ---------------------------------------------------------------------------
// f32 route: 256 threads, 32 x 32 (key, query) pair tiles, plain FMA.
// Phase A: thread t scores rows t / 8 against columns t % 8 + 8u (u < 4);
// phase B: thread t accumulates row t / 8 at dims t % 8 + 8u (u < D / 8).
// ---------------------------------------------------------------------------

constexpr int kFT = 32;         // rows and columns of an f32 pair tile
constexpr int kFThreads = 256;

template <int D>
__device__ __forceinline__ void load_f32(float* dst, const float* src, long long stride,
                                         int r0, int n) {
  for (int i = threadIdx.x; i < kFT * D; i += kFThreads) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = r0 + r < n ? src[(r0 + r) * stride + d] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

template <int D>
__global__ void __launch_bounds__(kFThreads)
dkdv_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, BwdGeom gm) {
  constexpr int P = D + 1, DJ = D / 8;
  extern __shared__ float fsm[];
  float* Ks = fsm;
  float* Vs = Ks + kFT * P;
  float* Qs = Vs + kFT * P;
  float* Ds = Qs + kFT * P;
  float* Ps = Ds + kFT * P;          // [key][query]
  float* Ss = Ps + kFT * (kFT + 1);  // dS [key][query]
  float* ls = Ss + kFT * (kFT + 1);
  float* dl = ls + kFT;

  const int S = gm.S, G = gm.G, kind = gm.kind, w = gm.window;
  const int bh = blockIdx.x, b = bh / gm.Hk, h = bh % gm.Hk;
  const int k0 = blockIdx.y * kFT;
  const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;
  load_f32<D>(Ks, k + b * gm.k_b + h * gm.k_h, gm.k_s, k0, S);
  load_f32<D>(Vs, v + b * gm.v_b + h * gm.v_h, gm.v_s, k0, S);
  float dka[DJ], dva[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) dka[j] = dva[j] = 0.f;
  const int q_last = last_query(min(k0 + kFT - 1, S - 1), S, kind, w);

  for (int g = 0; g < G; ++g) {
    const long long rb = (static_cast<long long>(bh) * G + g) * S;
    for (int q0 = k0; q0 <= q_last; q0 += kFT) {
      __syncthreads();
      load_f32<D>(Qs, q + b * gm.q_b + h * gm.q_h + g * gm.q_g, gm.q_s, q0, S);
      load_f32<D>(Ds, dout + b * gm.do_b + h * gm.do_h + g * gm.do_g, gm.do_s, q0, S);
      for (int i = threadIdx.x; i < kFT; i += kFThreads) {
        ls[i] = q0 + i < S ? lse[rb + q0 + i] : 0.f;
        dl[i] = q0 + i < S ? delta[rb + q0 + i] : 0.f;
      }
      __syncthreads();
      const int kp = k0 + tr;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int qi = tc + 8 * u, qp = q0 + qi;
        float p = 0.f, ds = 0.f;
        if (qp < S && allowed(qp, kp, kind, w)) {
          p = expf(dot<D>(Ks + tr * P, Qs + qi * P) * gm.scale - ls[qi]);
          ds = p * (dot<D>(Vs + tr * P, Ds + qi * P) - dl[qi]);
        }
        Ps[tr * (kFT + 1) + qi] = p;
        Ss[tr * (kFT + 1) + qi] = ds;
      }
      __syncthreads();
      for (int qi = 0; qi < kFT; ++qi) {
        const float p = Ps[tr * (kFT + 1) + qi], ds = Ss[tr * (kFT + 1) + qi];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dva[j] = fmaf(p, Ds[qi * P + tc + 8 * j], dva[j]);
          dka[j] = fmaf(ds, Qs[qi * P + tc + 8 * j], dka[j]);
        }
      }
    }
  }
  const int kp = k0 + tr;
  if (kp < S) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[b * gm.dk_b + h * gm.dk_h + kp * gm.dk_s + tc + 8 * j] = dka[j] * gm.scale;
      dv[b * gm.dv_b + h * gm.dv_h + kp * gm.dv_s + tc + 8 * j] = dva[j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads)
dq_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, BwdGeom gm) {
  constexpr int P = D + 1, DJ = D / 8;
  extern __shared__ float fsm[];
  float* Qs = fsm;
  float* Ds = Qs + kFT * P;
  float* Ks = Ds + kFT * P;
  float* Vs = Ks + kFT * P;
  float* Ss = Vs + kFT * P;  // dS [query][key]

  const int S = gm.S, G = gm.G, kind = gm.kind, w = gm.window;
  const int bhg = blockIdx.x, g = bhg % G, bh = bhg / G, b = bh / gm.Hk, h = bh % gm.Hk;
  const int q0 = blockIdx.y * kFT;
  const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;
  load_f32<D>(Qs, q + b * gm.q_b + h * gm.q_h + g * gm.q_g, gm.q_s, q0, S);
  load_f32<D>(Ds, dout + b * gm.do_b + h * gm.do_h + g * gm.do_g, gm.do_s, q0, S);
  const int qp = q0 + tr;
  const long long rb = static_cast<long long>(bhg) * S;
  const float l = qp < S ? lse[rb + qp] : 0.f, dlt = qp < S ? delta[rb + qp] : 0.f;
  float dqa[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) dqa[j] = 0.f;
  const int k_first = first_key(q0, kind, w) / kFT * kFT;
  const int k_last = min(q0 + kFT - 1, S - 1);

  for (int kt = k_first; kt <= k_last; kt += kFT) {
    __syncthreads();
    load_f32<D>(Ks, k + b * gm.k_b + h * gm.k_h, gm.k_s, kt, S);
    load_f32<D>(Vs, v + b * gm.v_b + h * gm.v_h, gm.v_s, kt, S);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int ki = tc + 8 * u, kp = kt + ki;
      float ds = 0.f;
      if (qp < S && allowed(qp, kp, kind, w)) {
        const float p = expf(dot<D>(Qs + tr * P, Ks + ki * P) * gm.scale - l);
        ds = p * (dot<D>(Ds + tr * P, Vs + ki * P) - dlt);
      }
      Ss[tr * (kFT + 1) + ki] = ds;
    }
    __syncthreads();
    for (int ki = 0; ki < kFT; ++ki) {
      const float ds = Ss[tr * (kFT + 1) + ki];
#pragma unroll
      for (int j = 0; j < DJ; ++j) dqa[j] = fmaf(ds, Ks[ki * P + tc + 8 * j], dqa[j]);
    }
  }
  if (qp < S) {
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dq[b * gm.dq_b + h * gm.dq_h + g * gm.dq_g + qp * gm.dq_s + tc + 8 * j] =
          dqa[j] * gm.scale;
  }
}

template <typename KernelT>
cudaError_t set_smem(KernelT kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch_bf16(cudaStream_t st, const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta, void* dq,
                        void* dk, void* dv, int B, const BwdGeom& gm) {
  using C = Bf16Cfg<D>;
  using bf = __nv_bfloat16;
  // x over (batch, head), y over tiles: x takes 2^31 - 1 blocks, y 65535
  const dim3 grid_kv(B * gm.Hk, (gm.S + kTile - 1) / kTile);
  const dim3 grid_q(B * gm.Hk * gm.G, (gm.S + kTile - 1) / kTile);
  cudaError_t err = set_smem(dkdv_mma_kernel<D>, C::DKDV_SMEM);
  if (err != cudaSuccess) return err;
  dkdv_mma_kernel<D><<<grid_kv, kThreads, C::DKDV_SMEM, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv), gm);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(dq_mma_kernel<D>, C::DQ_SMEM)) != cudaSuccess) return err;
  dq_mma_kernel<D><<<grid_q, kThreads, C::DQ_SMEM, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), lse, delta, static_cast<bf*>(dq), gm);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(cudaStream_t st, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta, void* dq,
                       void* dk, void* dv, int B, const BwdGeom& gm) {
  constexpr int P = D + 1;
  const int kv_smem = (4 * kFT * P + 2 * kFT * (kFT + 1) + 2 * kFT) * 4;
  const int q_smem = (4 * kFT * P + kFT * (kFT + 1)) * 4;
  const dim3 grid_kv(B * gm.Hk, (gm.S + kFT - 1) / kFT);
  const dim3 grid_q(B * gm.Hk * gm.G, (gm.S + kFT - 1) / kFT);
  const float* f = nullptr;
  cudaError_t err = set_smem(dkdv_fma_kernel<D>, kv_smem);
  if (err != cudaSuccess) return err;
  dkdv_fma_kernel<D><<<grid_kv, kFThreads, kv_smem, st>>>(
      static_cast<decltype(f)>(q), static_cast<decltype(f)>(k), static_cast<decltype(f)>(v),
      static_cast<decltype(f)>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), gm);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(dq_fma_kernel<D>, q_smem)) != cudaSuccess) return err;
  dq_fma_kernel<D><<<grid_q, kFThreads, q_smem, st>>>(
      static_cast<decltype(f)>(q), static_cast<decltype(f)>(k), static_cast<decltype(f)>(v),
      static_cast<decltype(f)>(dout), lse, delta, static_cast<float*>(dq), gm);
  return cudaGetLastError();
}

}  // namespace

// q, o, do, dq (B, Hk, G, S, D), k, v, dk, dv (B, Hk, S, D), all through
// strides in elements with the last dim contiguous: st = {q_b, q_h, q_g,
// q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_g, o_s, do_b, do_h, do_g,
// do_s, dq_b, dq_h, dq_g, dq_s, dk_b, dk_h, dk_s, dv_b, dv_h, dv_s}. lse:
// the forward's f32 (B, Hk, G, S), contiguous; delta: f32 scratch of the
// same shape, written here. kind: 0 full, 1 sliding, 2 chunked. dtype: 0
// f32, 1 bf16 (every stride but the last a multiple of 8 elements, base
// pointers 16-byte aligned). D: 32, 64 or 128.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const float* lse,
                                          float* delta, void* dq, void* dk, void* dv, int B,
                                          int Hk, int G, int S, int D, const long long* st,
                                          float scale, int kind, int window, int dtype,
                                          void* stream) {
  BwdGeom gm;
  gm.Hk = Hk; gm.G = G; gm.S = S; gm.kind = kind; gm.window = window; gm.scale = scale;
  gm.q_b = st[0]; gm.q_h = st[1]; gm.q_g = st[2]; gm.q_s = st[3];
  gm.k_b = st[4]; gm.k_h = st[5]; gm.k_s = st[6];
  gm.v_b = st[7]; gm.v_h = st[8]; gm.v_s = st[9];
  gm.o_b = st[10]; gm.o_h = st[11]; gm.o_g = st[12]; gm.o_s = st[13];
  gm.do_b = st[14]; gm.do_h = st[15]; gm.do_g = st[16]; gm.do_s = st[17];
  gm.dq_b = st[18]; gm.dq_h = st[19]; gm.dq_g = st[20]; gm.dq_s = st[21];
  gm.dk_b = st[22]; gm.dk_h = st[23]; gm.dk_s = st[24];
  gm.dv_b = st[25]; gm.dv_h = st[26]; gm.dv_s = st[27];
  if (D != 32 && D != 64 && D != 128) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if ((S + 31) / 32 > 65535) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * Hk * G * S;
  if (rows == 0) return cudaSuccess;
  const unsigned dgrid = static_cast<unsigned>((rows + 7) / 8);
  if (dtype == 1)
    delta_kernel<__nv_bfloat16><<<dgrid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), delta,
        B, D, gm);
  else
    delta_kernel<float><<<dgrid, 256, 0, s>>>(static_cast<const float*>(o),
                                              static_cast<const float*>(dout), delta, B, D, gm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (dtype == 1) {
    switch (D) {
      case 32: return launch_bf16<32>(s, q, k, v, dout, lse, delta, dq, dk, dv, B, gm);
      case 64: return launch_bf16<64>(s, q, k, v, dout, lse, delta, dq, dk, dv, B, gm);
      default: return launch_bf16<128>(s, q, k, v, dout, lse, delta, dq, dk, dv, B, gm);
    }
  }
  switch (D) {
    case 32: return launch_f32<32>(s, q, k, v, dout, lse, delta, dq, dk, dv, B, gm);
    case 64: return launch_f32<64>(s, q, k, v, dout, lse, delta, dq, dk, dv, B, gm);
    default: return launch_f32<128>(s, q, k, v, dout, lse, delta, dq, dk, dv, B, gm);
  }
}
