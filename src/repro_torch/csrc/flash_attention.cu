// K4 on Hopper: causal GQA flash attention forward, with the reference's
// three mask kinds (full; sliding: k > q - window; chunked: k / window ==
// q / window), an online softmax in f32 with the finite -1e30 sentinel,
// p rounded to the value dtype before the P.V product, l floored at
// 1e-30, and the output in q's dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel). It computes what that kernel computes;
// it is not carried over block by block.
//
// Both routes pack every query head of a kv head into one CTA's rows: row
// r is query position r / G of head r % G, so each K/V tile is read once
// for all G heads (the GQA saving the Pallas kernel is built around).
// Key tiles wholly above the diagonal, or wholly before the sliding window
// or the chunk of every row, are skipped: they would add exp(-1e30 - m) =
// 0, or be wiped by alpha = exp(-1e30 - m) once a valid key arrives,
// exactly as in the reference.
//
// bf16 (attn_wgmma_kernel), built for sm_90a:
//  - warp-specialised CTA of 384 threads: warpgroup 0 is the producer (one
//    thread issues TMA loads, the group gives its registers away with
//    setmaxnreg), warpgroups 1 and 2 are consumers of 64 rows each.
//  - a CTA holds P = 128 / G whole positions (P x G rows; padded rows up
//    to 128 are computed and never stored). Q arrives by a 5-D TMA box
//    {D, G, P} straight from the model's strided (B, S, H, D) view; K and V
//    arrive in tiles of 128 keys (64 at D = 128) through a ring of 4 to 6
//    stages, each with a full and an empty mbarrier. TMA fills keys past S
//    with zeros; the mask still drops them (kp < S).
//  - S = Q K^T by wgmma m64nNk16 with Q and K in shared memory, both
//    K-major; O += P V by wgmma m64nDk16 with P in registers (the S
//    accumulator's layout is the A-register layout) and V in shared memory
//    through the transpose bit (V is keys x D, D contiguous). f32
//    accumulators.
//  - each turn of a consumer issues S of key tile i and P V of tile i - 1
//    together, so the softmax of tile i overlaps the P V product; the two
//    consumers take turns (ping-pong on named barriers), so one's softmax
//    runs while the other's products hold the tensor cores.
//  - swizzle: 128 B rows at D = 64 and D = 128 (two 64-column blocks),
//    64 B at D = 32; the tensor maps and the wgmma descriptors use the
//    same mode, and every block is aligned to its swizzle atom.
//  - softmax in log2 units: p = exp2(s * scale * log2 e - m) as one FMA and
//    one ex2; the element mask (one key interval per row) runs only on
//    tiles that the diagonal, the window's edge, the chunk boundary or S
//    cut.
//  - persistent: one CTA per SM walks output tiles, longest first, in
//    rounds that alternate direction over the CTAs; one tile's epilogue
//    overlaps the next one's loads. Each output tile is one CTA's
//    fixed-order walk over its keys, so launches are bitwise repeatable
//    (no split over keys, no atomics).
// f32 (fma_kernel): plain FMA, 256 threads, 64-row tiles, each thread a
// 4 x 4 block of scores and a 4 x D/16 block of the output (the f32
// tolerance of 2e-5 rules out TF32 tensor-core tiles).
//
// With a non-null lse (the training forward), both routes also write each
// row's log-sum-exp of its scaled, masked scores, m + log(l) in natural
// units, f32 (B, Hk, G, S) contiguous, for the backward
// (flash_attention_bwd.cu). The write comes after the output's and takes
// nothing from it, so the output is bitwise the same with and without it.
//
// Bound on the H100: 4 * B * Hk * G * D * (causal key-query pairs) flops
// against reading q, k, v and writing o once; at the serving prefill
// shape it is bound by operations.
//
// Plain C interface for ctypes: flash_attention_launch returns the CUDA
// error of the launch (0 on success), or 1000 + the CUresult of a tensor
// map that could not be encoded. cuTensorMapEncodeTiled (libcuda) is looked
// up through the CUDA runtime at first use, so the library needs no -lcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBM = 64;  // rows (query position x head) per CTA of the FMA route
constexpr int kBN = 64;  // keys per tile of the FMA route

struct Geom {
  int Hk, G, S, kind, window;
  long long q_b, q_h, q_g, q_s;
  long long k_b, k_h, k_s;
  long long v_b, v_h, v_s;
  long long o_b, o_h, o_g, o_s;
  float scale;
};

__device__ __forceinline__ bool allowed(int qp, int kp, int kind, int window) {
  bool ok = kp <= qp;
  if (kind == 1 && window > 0) ok = ok && kp > qp - window;
  else if (kind == 2 && window > 0) ok = ok && (kp / window) == (qp / window);
  return ok;
}

// first key any row of positions [qmin, ...] may attend to
__device__ __forceinline__ int first_key(int qmin, int kind, int window) {
  if (kind == 1 && window > 0) return max(0, qmin - window + 1);
  if (kind == 2 && window > 0) return (qmin / window) * window;
  return 0;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ float round_to(float p, const float*) { return p; }

// ---------------------------------------------------------------------------
// FMA kernel: 16 x 16 threads; thread (ty, tx) owns rows 4ty..4ty+3, keys
// tx + 16j (j < 4) of a tile and output dims tx + 16j (j < D / 16).
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(256)
fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse, Geom gm) {
  constexpr int P = D + 1;  // padded row (no bank conflicts across keys)
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [kBM][P]
  float* Ks = Qs + kBM * P;      // [kBN][P]
  float* Vs = Ks + kBN * P;      // [kBN][P]
  float* Ps = Vs + kBN * P;      // [kBM][kBN + 1]

  const int G = gm.G, S = gm.S;
  const int bh = blockIdx.y, b = bh / gm.Hk, h = bh % gm.Hk;
  const int r0 = blockIdx.x * kBM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qb = q + b * gm.q_b + h * gm.q_h;
  const T* kb = k + b * gm.k_b + h * gm.k_h;
  const T* vb = v + b * gm.v_b + h * gm.v_h;

  for (int i = threadIdx.x; i < kBM * D; i += 256) {
    const int r = i / D, d = i % D, row = r0 + r, qp = row / G;
    Qs[r * P + d] = qp < S ? to_f(qb[(row % G) * gm.q_g + qp * gm.q_s + d]) : 0.f;
  }
  const int qmin = r0 / G;
  const int qmax = min((r0 + kBM - 1) / G, S - 1);
  const int kt0 = first_key(qmin, gm.kind, gm.window) / kBN * kBN;

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  for (int kt = kt0; kt <= qmax; kt += kBN) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBN * D; i += 256) {
      const int kk = i / D, d = i % D, kp = kt + kk;
      Ks[kk * P + d] = kp < S ? to_f(kb[kp * gm.k_s + d]) : 0.f;
      Vs[kk * P + d] = kp < S ? to_f(vb[kp * gm.v_s + d]) : 0.f;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * P + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * P + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = (r0 + 4 * ty + i) / G;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kt + tx + 16 * j;
        s[i][j] = allowed(qp, kp, gm.kind, gm.window) ? s[i][j] * gm.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        sum += p;
        Ps[(4 * ty + i) * (kBN + 1) + tx + 16 * j] = round_to(p, k);
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBN; ++kk) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(4 * ty + i) * (kBN + 1) + kk];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }
  T* ob = o + b * gm.o_b + h * gm.o_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i, qp = row / G;
    if (qp >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      from_f(ob + (row % G) * gm.o_g + qp * gm.o_s + tx + 16 * j, acc[i][j] * inv);
    if (lse != nullptr && tx == 0)
      lse[((static_cast<long long>(b) * gm.Hk + h) * G + row % G) * S + qp] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// wgmma kernel (bf16), on the building blocks of hopper.cuh (which also
// gives the fragment layouts: the S accumulator's n-tiles 2j, 2j + 1 are P's
// A registers of k-step j).
// ---------------------------------------------------------------------------

constexpr int kRows = 128;    // rows per CTA: two consumer warpgroups of 64
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 * 40 + 256 * 232 <= 65536
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct WgGeom {
  int S, G, P, Hk, n_qt, bhn, total, kind, window;
  float c;  // scale * log2(e): scores in log2 units
  long long o_b, o_h, o_g, o_s;
};

template <int D>
struct WgCfg {
  static constexpr int ATOM = D == 32 ? 32 : 64;  // bf16 columns of one swizzle row
  static constexpr int ROWB = ATOM * 2;           // bytes of a swizzle row: 64 or 128
  static constexpr int NSUB = D / ATOM;           // column blocks: 2 at D = 128
  static constexpr int KSTEPS = ATOM / 16;        // wgmma k-steps per column block
  // keys per K/V tile: 64 at D = 128, where S, O and P of 128 keys would not
  // all fit in a consumer's registers while a product is in flight
  static constexpr int TILE_N = D == 128 ? 64 : 128;
  static constexpr int STAGES = D == 128 ? 4 : (D == 64 ? 5 : 6);
  static constexpr int SUB_Q = kRows * ROWB;      // bytes of one column block of Q
  static constexpr int SUB_KV = TILE_N * ROWB;    // ... of K or V
  static constexpr int Q_BYTES = NSUB * SUB_Q;
  static constexpr int KV_BYTES = NSUB * SUB_KV;  // K (or V) of one stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (2 + 2 * STAGES) + 1024;  // + alignment slack
  static constexpr uint64_t MODE = ROWB == 128 ? 1 : 2;  // descriptor: 128 B or 64 B swizzle
};


// the geometry of one output tile: P positions x G heads of one (b, kv head)
struct Tile {
  int b, h, p0, kt0, n_tiles;
};

template <int BN>
__device__ __forceinline__ Tile tile_at(int t, const WgGeom& gm) {
  Tile tl;
  const int qt = gm.n_qt - 1 - t / gm.bhn;  // the q tiles with the most keys come first
  const int bh = t % gm.bhn;
  tl.b = bh / gm.Hk;
  tl.h = bh % gm.Hk;
  tl.p0 = qt * gm.P;
  const int pmax = min(tl.p0 + gm.P - 1, gm.S - 1);
  tl.kt0 = first_key(tl.p0, gm.kind, gm.window) / BN * BN;
  tl.n_tiles = pmax / BN - tl.kt0 / BN + 1;
  return tl;
}

// the output tile a persistent CTA takes in round r: rounds alternate
// direction over the CTAs, so the long tiles of early rounds pair with
// short ones (-1 when none is left)
__device__ __forceinline__ int tile_of_round(int r, const WgGeom& gm) {
  const int n = static_cast<int>(gridDim.x), c = static_cast<int>(blockIdx.x);
  const long long t = static_cast<long long>(r) * n + ((r & 1) ? n - 1 - c : c);
  return t < gm.total ? static_cast<int>(t) : -1;
}

// the keys row position qp may attend to form one interval [first, last]
// under every mask kind (last = min(qp, S - 1))
__device__ __forceinline__ int first_allowed(int qp, int kind, int w) {
  if (kind == 1) return max(0, qp - w + 1);
  if (kind == 2) return qp / w * w;
  return 0;
}

// online softmax of one 64 x BN score tile held as the wgmma accumulator:
// the scores become p = exp2(s * c - m) in place; m, l and the O rescale
// factors of the thread's two rows are updated
template <int BN>
__device__ __forceinline__ void softmax_tile(float* sacc, float& m_lo, float& m_hi, float& l_lo,
                                             float& l_hi, float& a_lo, float& a_hi, float c,
                                             bool clean, int kt, int S, int qp_lo, int qp_hi,
                                             int kind, int w, int tid) {
  if (!clean) {
    // column j = 8n + (e & 1) of this thread holds key kt + 2 tid + j
    const int k0 = kt + 2 * tid;
    const int lo_a = first_allowed(qp_lo, kind, w) - k0, lo_b = min(qp_lo, S - 1) - k0;
    const int hi_a = first_allowed(qp_hi, kind, w) - k0, hi_b = min(qp_hi, S - 1) - k0;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * n + (e & 1);
        const bool ok = e < 2 ? (j >= lo_a && j <= lo_b) : (j >= hi_a && j <= hi_b);
        if (!ok) sacc[4 * n + e] = -INFINITY;
      }
  }
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    mx_lo = fmaxf(mx_lo, fmaxf(sacc[4 * n], sacc[4 * n + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(sacc[4 * n + 2], sacc[4 * n + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off *= 2) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  // a row with no allowed key here keeps its m (mx = -inf); a row that has
  // seen none yet keeps the sentinel and is wiped by alpha = 0 later
  const float mn_lo = fmaxf(m_lo, mx_lo * c), mn_hi = fmaxf(m_hi, mx_hi * c);
  a_lo = ex2(m_lo - mn_lo);
  a_hi = ex2(m_hi - mn_hi);
  m_lo = mn_lo;
  m_hi = mn_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    sacc[4 * n] = ex2(fmaf(sacc[4 * n], c, -mn_lo));
    sacc[4 * n + 1] = ex2(fmaf(sacc[4 * n + 1], c, -mn_lo));
    sacc[4 * n + 2] = ex2(fmaf(sacc[4 * n + 2], c, -mn_hi));
    sacc[4 * n + 3] = ex2(fmaf(sacc[4 * n + 3], c, -mn_hi));
    sum_lo += sacc[4 * n] + sacc[4 * n + 1];
    sum_hi += sacc[4 * n + 2] + sacc[4 * n + 3];
  }
  l_lo = l_lo * a_lo + sum_lo;  // this thread's columns; summed over the quad at the end
  l_hi = l_hi * a_hi + sum_hi;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                  float* __restrict__ lse, const WgGeom gm) {
  using C = WgCfg<D>;
  constexpr int BN = C::TILE_N;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // every block on a swizzle-atom boundary
  unsigned char* gbase = smem_raw + (base - raw);
  // barriers: q_full, q_empty, then full[STAGES], then empty[STAGES]
  const uint32_t q_full = base + C::BAR_OFF, q_empty = q_full + 8;
  const uint32_t full0 = q_full + 16, empty0 = full0 + 8 * C::STAGES;
  const int S = gm.S, G = gm.G;
  const int real_rows = G * gm.P;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);                // the producer
    mbar_init(q_empty, kConsumerWarps);  // each consumer warp
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // padded rows of Q (G does not divide 128): zero, computed, never stored
  {
    const int pad = kRows - real_rows, chunks = C::ROWB / 16;
    for (int i = threadIdx.x; i < C::NSUB * pad * chunks; i += kThreads) {
      const int sub = i / (pad * chunks), r = real_rows + (i / chunks) % pad, c = i % chunks;
      *reinterpret_cast<uint4*>(gbase + sub * C::SUB_Q + r * C::ROWB + c * 16) =
          make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0, qph = 0;
      for (int r = 0;; ++r) {
        const int t = tile_of_round(r, gm);
        if (t < 0) break;
        const Tile tl = tile_at<BN>(t, gm);
        mbar_wait(q_empty, qph ^ 1);  // the previous tile's Q is no longer read
        mbar_expect_tx(q_full, C::NSUB * C::ROWB * real_rows);
#pragma unroll
        for (int sub = 0; sub < C::NSUB; ++sub)
          tma_load_5d(base + sub * C::SUB_Q, &tq, q_full, sub * C::ATOM, 0, tl.p0, tl.h, tl.b);
        qph ^= 1;
        for (int i = 0; i < tl.n_tiles; ++i) {
          const uint32_t ks = base + C::Q_BYTES + s * C::STAGE_BYTES;
          const int kt = tl.kt0 + i * BN;
          mbar_wait(empty0 + 8 * s, ph ^ 1);  // the first pass over the ring finds it free
          mbar_expect_tx(full0 + 8 * s, C::STAGE_BYTES);
#pragma unroll
          for (int sub = 0; sub < C::NSUB; ++sub) {
            tma_load_4d(ks + sub * C::SUB_KV, &tk, full0 + 8 * s, sub * C::ATOM, kt, tl.h, tl.b);
            tma_load_4d(ks + C::KV_BYTES + sub * C::SUB_KV, &tv, full0 + 8 * s, sub * C::ATOM,
                        kt, tl.h, tl.b);
          }
          if (++s == C::STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups of 64 rows ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t128 = threadIdx.x - 128, cw = t128 / 128, warp = (t128 % 128) / 32;
    const int lane = t128 % 32, tid = lane % 4;
    const int r_lo = cw * 64 + warp * 16 + lane / 4, r_hi = r_lo + 8;
    const int wr1 = min(cw * 64 + 63, real_rows - 1);  // this warpgroup's last real row
    const int kind = gm.window > 0 ? gm.kind : 0, w = gm.window;
    const float c = gm.c;
    const uint32_t qa = base + cw * 64 * C::ROWB;
    auto kaddr = [&](int st) { return base + C::Q_BYTES + st * C::STAGE_BYTES; };
    auto release = [&](int st) {  // this warp no longer reads stage st
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    };

    // ping-pong: the two warpgroups take turns to issue their products, so
    // one's softmax runs while the other's products hold the tensor cores
    if (cw == 1) named_arrive(1);  // warpgroup 0 goes first

    float sacc[BN / 2], oacc[D / 2];
    uint32_t pa[BN / 16][4];
    float m_lo, m_hi, l_lo, l_hi, a_lo = 1.f, a_hi = 1.f;  // m in log2 units
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sacc[i] = 0.f;
    int s = 0;
    uint32_t ph = 0, qph = 0;
    for (int r = 0;; ++r) {
      const int t = tile_of_round(r, gm);
      if (t < 0) break;
      const Tile tl = tile_at<BN>(t, gm);
      const int qp_lo = tl.p0 + r_lo / G, qp_hi = tl.p0 + r_hi / G;
      // this warpgroup's first and last real position; both warpgroups walk
      // every key tile of the CTA (rows masked out of a tile add exactly 0)
      const int wp0 = tl.p0 + cw * 64 / G, wp1 = min(tl.p0 + wr1 / G, S - 1);
      auto clean = [&](int kt) {  // every (row, key) pair of the tile allowed?
        return kt + BN <= S && kt + BN - 1 <= wp0 && (kind != 1 || kt > wp1 - w) &&
               (kind != 2 || kt / w == wp1 / w);
      };
      auto advance = [&]() {
        if (++s == C::STAGES) {
          s = 0;
          ph ^= 1;
        }
      };
      auto issue_s = [&](int st) {  // S = Q K^T from stage st
#pragma unroll
        for (int k = 0; k < D / 16; ++k) {
          const uint32_t off = (k % C::KSTEPS) * 32;  // 16 bf16 along the swizzled row
          wgmma_ss<BN>(
              sacc, sdesc(qa + (k / C::KSTEPS) * C::SUB_Q + off, 16, 8 * C::ROWB, C::MODE),
              sdesc(kaddr(st) + (k / C::KSTEPS) * C::SUB_KV + off, 16, 8 * C::ROWB, C::MODE),
              k > 0);
        }
        wgmma_commit();
      };
      auto issue_pv = [&](int st) {  // O += P V from stage st
        const uint32_t va = kaddr(st) + C::KV_BYTES;
#pragma unroll
        for (int k = 0; k < BN / 16; ++k)
          wgmma_rs<D>(oacc, pa[k], sdesc(va + k * 16 * C::ROWB, C::SUB_KV, 8 * C::ROWB, C::MODE));
        wgmma_commit();
      };
      auto pack_p = [&]() {
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
          pa[n / 2][(n & 1) * 2 + 0] = pack_bf16(sacc[4 * n], sacc[4 * n + 1]);
          pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(sacc[4 * n + 2], sacc[4 * n + 3]);
        }
      };
      auto softmax = [&](int kt) {
        softmax_tile<BN>(sacc, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, c, clean(kt),
                       kt, S, qp_lo, qp_hi, kind, w, tid);
      };

#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
      m_lo = m_hi = kNegInf;
      l_lo = l_hi = 0.f;
      mbar_wait(q_full, qph);
      qph ^= 1;
      // turn 0: S of the first key tile
      mbar_wait(full0 + 8 * s, ph);
      named_sync(1 + cw);
      wgmma_fence();
      issue_s(s);
      named_arrive(2 - cw);  // the other warpgroup's turn
      wgmma_wait_all();
      fence_regs<BN / 2>(sacc);
      softmax(tl.kt0);
      pack_p();
      int prev = s;
      advance();
      // turn i: S of tile i and P V of tile i - 1 in flight together; the
      // softmax of tile i overlaps the P V product
      for (int i = 1; i < tl.n_tiles; ++i) {
        const int kt = tl.kt0 + i * BN;
        mbar_wait(full0 + 8 * s, ph);
        named_sync(1 + cw);
        wgmma_fence();
        issue_s(s);
        issue_pv(prev);
        named_arrive(2 - cw);
        wgmma_wait_one();  // S is done
        fence_regs<BN / 2>(sacc);
        softmax(kt);
        wgmma_wait_all();  // P V is done
        fence_regs<D / 2>(oacc);
        release(prev);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          oacc[4 * n] *= a_lo;
          oacc[4 * n + 1] *= a_lo;
          oacc[4 * n + 2] *= a_hi;
          oacc[4 * n + 3] *= a_hi;
        }
        pack_p();
        prev = s;
        advance();
      }
      // last turn: P V of the last key tile
      named_sync(1 + cw);
      wgmma_fence();
      issue_pv(prev);
      named_arrive(2 - cw);
      wgmma_wait_all();
      fence_regs<D / 2>(oacc);
      release(prev);
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty);  // the producer may load the next Q

#pragma unroll
      for (int off = 1; off <= 2; off *= 2) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = rr ? r_hi : r_lo, qp = rr ? qp_hi : qp_lo;
        if (row >= real_rows || qp >= S) continue;
        const float inv = 1.f / fmaxf(rr ? l_hi : l_lo, 1e-30f);
        __nv_bfloat16* orow =
            o + tl.b * gm.o_b + tl.h * gm.o_h + (row % G) * gm.o_g + qp * gm.o_s;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * tid) =
              pack_bf16(oacc[4 * n + 2 * rr] * inv, oacc[4 * n + 2 * rr + 1] * inv);
        if (lse != nullptr && tid == 0)  // m is in log2 units: to natural ones
          lse[((static_cast<long long>(tl.b) * gm.Hk + tl.h) * G + row % G) * S + qp] =
              ((rr ? m_hi : m_lo) + log2f(fmaxf(rr ? l_hi : l_lo, 1e-30f))) * kLn2;
      }
    }
    if (cw == 0) named_sync(1);  // takes warpgroup 1's last turn
  }
}

template <typename T, int D>
cudaError_t launch_fma(dim3 grid, cudaStream_t stream, const void* q, const void* k,
                       const void* v, void* o, float* lse, const Geom& gm) {
  const size_t smem = (size_t)(3 * 64 * (D + 1) + 64 * (kBN + 1)) * sizeof(float);
  auto kern = fma_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, 256, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                    static_cast<const T*>(v), static_cast<T*>(o), lse, gm);
  return cudaGetLastError();
}


template <int D>
int launch_wgmma(cudaStream_t stream, const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int G, const Geom& gm) {
  using C = WgCfg<D>;
  if (G < 1 || G > kRows) return cudaErrorInvalidValue;
  const int S = gm.S, Hk = gm.Hk, P = kRows / G;
  const long long n_qt = (S + P - 1) / P, ctas = n_qt * B * Hk;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const CUtensorMapSwizzle sw =
      C::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  CUtensorMap tq, tk, tv;
  {  // q (B, Hk, G, S, D) as dims {D, G, S, Hk, B}; box {ATOM, G, P}: P positions x G heads
    const cuuint64_t dims[5] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)S, (cuuint64_t)Hk,
                                (cuuint64_t)B};
    const cuuint64_t st[4] = {gm.q_g * e, gm.q_s * e, gm.q_h * e, gm.q_b * e};
    const cuuint32_t box[5] = {(cuuint32_t)C::ATOM, (cuuint32_t)G, (cuuint32_t)P, 1, 1};
    if (int r = encode_map(&tq, q, 5, dims, st, box, sw)) return r;
  }
  {  // k, v (B, Hk, S, D) as dims {D, S, Hk, B}; box {ATOM, TILE_N keys}
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)Hk, (cuuint64_t)B};
    const cuuint32_t box[4] = {(cuuint32_t)C::ATOM, (cuuint32_t)C::TILE_N, 1, 1};
    const cuuint64_t sk[3] = {gm.k_s * e, gm.k_h * e, gm.k_b * e};
    const cuuint64_t sv[3] = {gm.v_s * e, gm.v_h * e, gm.v_b * e};
    if (int r = encode_map(&tk, k, 4, dims, sk, box, sw)) return r;
    if (int r = encode_map(&tv, v, 4, dims, sv, box, sw)) return r;
  }
  WgGeom wg;
  wg.S = S; wg.G = G; wg.P = P; wg.Hk = Hk; wg.n_qt = (int)n_qt;
  wg.bhn = B * Hk; wg.total = (int)ctas;
  wg.kind = gm.kind; wg.window = gm.window; wg.c = gm.scale * kLog2e;
  wg.o_b = gm.o_b; wg.o_h = gm.o_h; wg.o_g = gm.o_g; wg.o_s = gm.o_s;
  auto kern = attn_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::SMEM);
  if (err != cudaSuccess) return err;
  // persistent: one CTA per SM (the CTA fills an SM), each walking its
  // tiles (tile_of_round), so one tile's epilogue overlaps the next one's
  // loads
  const long long grid = ctas < num_sms() ? ctas : num_sms();
  kern<<<(unsigned)grid, kThreads, C::SMEM, stream>>>(tq, tk, tv,
                                                      static_cast<__nv_bfloat16*>(o), lse, wg);
  return cudaGetLastError();
}

}  // namespace

// q (B, Hk, G, S, D), k/v (B, Hk, S, D), o (B, Hk, G, S, D), all through
// strides in elements (the last dim contiguous): st = {q_b, q_h, q_g, q_s,
// k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_g, o_s}. kind: 0 full,
// 1 sliding, 2 chunked. dtype: 0 f32 (FMA kernel), 1 bf16 (wgmma kernel:
// 1 <= G <= 128, every stride but the last a multiple of 8 elements, the
// base pointers 16-byte aligned). lse: null, or f32 (B, Hk, G, S) contiguous
// to receive each row's log-sum-exp.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, float* lse, int B, int Hk, int G, int S,
                                      int D, const long long* st, float scale, int kind,
                                      int window, int dtype, void* stream) {
  Geom gm;
  gm.Hk = Hk; gm.G = G; gm.S = S; gm.kind = kind; gm.window = window;
  gm.q_b = st[0]; gm.q_h = st[1]; gm.q_g = st[2]; gm.q_s = st[3];
  gm.k_b = st[4]; gm.k_h = st[5]; gm.k_s = st[6];
  gm.v_b = st[7]; gm.v_h = st[8]; gm.v_s = st[9];
  gm.o_b = st[10]; gm.o_h = st[11]; gm.o_g = st[12]; gm.o_s = st[13];
  gm.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (D) {
      case 32: return launch_wgmma<32>(s, q, k, v, o, lse, B, G, gm);
      case 64: return launch_wgmma<64>(s, q, k, v, o, lse, B, G, gm);
      case 128: return launch_wgmma<128>(s, q, k, v, o, lse, B, G, gm);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 0) {
    const long long rows = (long long)G * S;
    dim3 grid((unsigned)((rows + kBM - 1) / kBM), (unsigned)(B * Hk));
    switch (D) {
      case 32: return launch_fma<float, 32>(grid, s, q, k, v, o, lse, gm);
      case 64: return launch_fma<float, 64>(grid, s, q, k, v, o, lse, gm);
      case 128: return launch_fma<float, 128>(grid, s, q, k, v, o, lse, gm);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}
