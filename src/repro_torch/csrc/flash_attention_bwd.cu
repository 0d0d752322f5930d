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
// The mask is the forward's predicate (k <= q; sliding k > q - window;
// chunked k / window == q / window). No float atomics anywhere: every
// gradient row is one CTA's fixed-order sum, so a launch repeats bitwise.
//
// bf16 route (sm_90a), three kernels run in this order by one C call, laid
// out as FlashAttention-3's backward and the forward's own wgmma kernel:
//  - prep_kernel: Dl = rowsum(dO o o) in f32 and lse * log2(e), written to a
//    workspace of two (B Hk G, s_pad) f32 arrays, s_pad = S rounded up to
//    128. Rows past S get lse = +inf and Dl = 0, so a padded query row has
//    P = exp2(-inf) = 0 without a mask. 16-byte loads, D / 8 lanes a row.
//  - dkdv_wgmma_kernel: a work item is (b, kv head, 128 keys). It walks, in
//    a fixed order, the query tiles of BM queries that can see its keys,
//    from the last down, and at each every query head g of its kv head: the
//    items of one (b, kv head) then read the same rows of Q and dO at about
//    the same time, which the 50 MB L2 keeps. K and V arrive by TMA once a
//    work item; Q, dO (5-D boxes straight from the model's strided
//    (B, S, H, D) views) and the lse and Dl rows (plain bulk copies) through
//    a ring of KV_STAGES stages, each with a full and an empty mbarrier.
//    Two consumer warpgroups own 64 keys each: S^T = K Q^T and
//    dP^T = V dO^T by wgmma with both operands in shared memory, P^T and
//    dS^T in registers (rounded to bf16 as the A operands of dV += P^T dO
//    and dK += dS^T Q, which read dO and Q through the transpose bit). dK
//    and dV stay in f32 registers for the whole walk and are written once:
//    the sum over G needs no atomics.
//  - dq_wgmma_kernel: a work item is (b, query head, 128 queries), walking
//    the key tiles its rows can see (BN keys a step); Q and dO by TMA once
//    a work item, K and V through the ring. S = Q K^T, dP = dO V^T (shared
//    operands), dQ += dS K (dS from registers, K through the transpose
//    bit); dQ in f32 registers, written once.
// Both main kernels are persistent (one CTA of 384 threads per SM: a
// producer warpgroup, one thread of which issues the TMA loads while the
// group gives its registers away with setmaxnreg, and two consumer
// warpgroups) and take their work items longest first: the host's plan
// (kernels/flash_attention.py::bwd_plan) sorts the key tiles and the query
// tiles by the length of their walks into `order` and sets each grid to
// min(items, the card's SMs), and the CTAs take items in rounds that
// alternate direction. Each consumer issues a step's S and
// dP products behind the previous step's dV and dK (dQ) products, so the
// tensor cores stay fed while it computes P; the element mask runs only on
// tiles that the diagonal, a window edge, a chunk boundary or S cut, and a
// warpgroup skips a step whose pairs the mask forbids entirely (finishing
// its pending product first, so a run of skips that wraps the ring never
// meets a stage it still holds).
// Measured on the card and left out: K and V (Q and dO) held as A
// fragments in registers gave wrong gradients at D = 64 past the first
// step of a walk (right ones at D = 32); the forward's ping-pong between
// the consumers, with or without its products on divergent paths, made
// ptxas serialize the wgmma chain and the kernels 1.4x slower.
//
// Budgets (bytes of shared memory per CTA, f32 registers of accumulators
// and bf16 fragments per consumer thread, of 232 after setmaxnreg; the
// producer keeps 40):
//   dK/dV  D = 32: BM 64, 6 stages,  71 KB; dK 16 + dV 16 + S 32 + dP 32 +
//                  P, dS 32 = 128
//          D = 64: BM 64, 5 stages, 118 KB; 32 + 32 + 32 + 32 + 32 = 160
//          D = 128: BM 32, 4 stages, 133 KB; 64 + 64 + 16 + 16 + 16 = 176
//   dQ     D = 32: BN 64, 8 stages,  81 KB; dQ 16 + S 32 + dP 32 + dS 16 = 96
//          D = 64: BN 128, 4 stages, 161 KB; 32 + 64 + 64 + 32 = 192
//          D = 128: BN 64, 4 stages, 193 KB; 64 + 32 + 32 + 16 = 144
//
// f32 route: plain FMA, 256 threads, 32 x 32 pair tiles, a Dl pre-pass of
// one warp a row (delta_kernel), the same walks without the ring.
//
// Bound on the H100: the five products of 2 D flops over each causal
// (query, key) pair of every query head, 10 D flops a pair, against reading
// q, k, v, o, do, lse and writing dq, dk, dv once: bound by operations at
// the training shape (4, 4, 8, 2048, 64), 172 GFLOP, 0.174 ms at 989
// TFLOP/s (bf16 dense, 700 W). The dQ kernel recomputes S and dP, so the
// route does 14 D flops a pair (240 GFLOP there).
//
// Plain C interface for ctypes: flash_attention_bwd_launch returns the CUDA
// error of the first launch that failed (0 on success), or 1000 + the
// CUresult of a tensor map that could not be encoded;
// flash_attention_bwd_config reports the tile sizes the host's plan mirrors.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// f32 Dl = rowsum(do o o): one warp a (b, h, g, position) row, lanes over D
// in a fixed order, then a butterfly; rows in the order of lse (B, Hk, G, S).
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
// bf16 route: wgmma on TMA rings (see the note at the top).
// ---------------------------------------------------------------------------

constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 * 40 + 256 * 232 <= 65536
constexpr int kPadTo = 128;  // the workspace's rows are S rounded up to this
constexpr int kSkip = 0, kMasked = 1, kClean = 2;  // a warpgroup's share of one step

constexpr int round1024(int x) { return (x + 1023) / 1024 * 1024; }

template <int D>
struct BwdCfg {
  static constexpr int ATOM = D == 32 ? 32 : 64;  // bf16 columns of one swizzle row
  static constexpr int ROWB = ATOM * 2;           // bytes of a swizzle row: 64 or 128
  static constexpr int NSUB = D / ATOM;           // column blocks: 2 at D = 128
  static constexpr int KSTEPS = ATOM / 16;        // wgmma k-steps per column block
  static constexpr uint64_t MODE = ROWB == 128 ? 1 : 2;  // descriptor: 128 B or 64 B swizzle
  // dK/dV: 128 keys a work item (64 a consumer warpgroup), BM queries a step
  static constexpr int KN = 128;
  static constexpr int BM = D == 128 ? 32 : 64;
  static constexpr int KV_SUB = KN * ROWB, KV_BYTES = NSUB * KV_SUB;  // K (or V)
  static constexpr int QT_SUB = BM * ROWB, QT_BYTES = NSUB * QT_SUB;  // Q (or dO) of a step
  static constexpr int KV_STEP = round1024(2 * QT_BYTES + 2 * BM * 4);  // + lse, Dl rows
  static constexpr int KV_STAGES = D == 128 ? 4 : (D == 64 ? 5 : 6);
  static constexpr int KV_RING = 2 * KV_BYTES;
  static constexpr int KV_BAR = KV_RING + KV_STAGES * KV_STEP;
  static constexpr int KV_SMEM = KV_BAR + 8 * (2 + 2 * KV_STAGES) + 1024;  // + alignment slack
  // dQ: 128 queries a work item (64 a consumer warpgroup), BN keys a step
  static constexpr int QN = 128;
  static constexpr int BN = D == 64 ? 128 : 64;
  static constexpr int QO_SUB = QN * ROWB, QO_BYTES = NSUB * QO_SUB;  // Q (or dO)
  static constexpr int KS_SUB = BN * ROWB, KS_BYTES = NSUB * KS_SUB;  // K (or V) of a step
  static constexpr int Q_STEP = 2 * KS_BYTES;
  static constexpr int Q_STAGES = D == 128 ? 4 : (D == 64 ? 4 : 8);
  static constexpr int Q_RING = 2 * QO_BYTES;
  static constexpr int Q_BAR = Q_RING + Q_STAGES * Q_STEP;
  static constexpr int Q_SMEM = Q_BAR + 8 * (2 + 2 * Q_STAGES) + 1024;
};

struct WgBwd {
  int S, G, Hk, bhn, bhgn, n_kt, kv_total, q_total, kind, window;
  int s_pad;
  float c;      // scale * log2(e): scores in log2 units
  float scale;  // dK and dQ's factor
  const int* order;  // [n_kt] key tiles, then [n_qt] query tiles, longest walk first
  const float* lse2;  // [B Hk G][s_pad] lse * log2(e), +inf past S
  const float* dl;    // [B Hk G][s_pad] Dl, 0 past S
  long long dq_b, dq_h, dq_g, dq_s, dk_b, dk_h, dk_s, dv_b, dv_h, dv_s;
};

// dK/dV: keys [kmin, kmin + 63] of one warpgroup against queries
// [q0, q0 + bm - 1]: no allowed pair (skip), some (element mask), or all
// (clean; a padded query row past S has P = 0 from its +inf lse). kind is 0
// when window is 0. tests/test_torch_flash_attention_bwd.py::kv_state
// mirrors it.
__device__ __forceinline__ int kv_state(int q0, int bm, int kmin, int S, int kind, int w) {
  if (kmin > S - 1) return kSkip;
  const int kmax = kmin + 63, qb = min(q0 + bm - 1, S - 1);
  // the queries that see any of the keys form [kmin, last_query(kmax)]
  if (max(q0, kmin) > min(qb, last_query(min(kmax, S - 1), S, kind, w))) return kSkip;
  const bool clean = kmax <= q0 && (kind != 1 || kmin > qb - w) &&
                     (kind != 2 || kmin / w == qb / w);
  return clean ? kClean : kMasked;
}

// dQ: queries [qa, qa + 63] of one warpgroup against keys [kt, kt + bn - 1];
// tests/test_torch_flash_attention_bwd.py::dq_state mirrors it
__device__ __forceinline__ int dq_state(int kt, int bn, int qa, int S, int kind, int w) {
  if (qa > S - 1) return kSkip;
  const int qb = min(qa + 63, S - 1), lo = max(qa, kt);
  // the keys a query q sees form [first_key(q), q], both ends rising with q
  if (lo > qb || first_key(lo, kind, w) > kt + bn - 1) return kSkip;
  const bool clean = kt + bn - 1 <= qa && first_key(qb, kind, w) <= kt;
  return clean ? kClean : kMasked;
}

struct KvItem {
  int b, h, bh, k0, n_q;  // n_q query tiles from k0 on
};

__device__ __forceinline__ KvItem kv_item(int t, int bm, const WgBwd& gm) {
  KvItem it;
  it.bh = t % gm.bhn;
  it.b = it.bh / gm.Hk;
  it.h = it.bh % gm.Hk;
  it.k0 = gm.order[t / gm.bhn] * 128;
  const int q_last = last_query(min(it.k0 + 127, gm.S - 1), gm.S, gm.kind, gm.window);
  it.n_q = q_last / bm - it.k0 / bm + 1;
  return it;
}

struct QItem {
  int b, h, g, bhg, q0, k_first, n_k;  // n_k key tiles from k_first on
};

__device__ __forceinline__ QItem q_item(int t, int bn, const WgBwd& gm) {
  QItem it;
  it.bhg = t % gm.bhgn;
  it.g = it.bhg % gm.G;
  const int bh = it.bhg / gm.G;
  it.b = bh / gm.Hk;
  it.h = bh % gm.Hk;
  it.q0 = gm.order[gm.n_kt + t / gm.bhgn] * 128;
  it.k_first = first_key(it.q0, gm.kind, gm.window) / bn * bn;
  it.n_k = min(it.q0 + 127, gm.S - 1) / bn - it.k_first / bn + 1;
  return it;
}

// an accumulator of N columns as the A fragments of a product whose k runs
// over those columns
template <int N>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[N / 16][4], const float* acc) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    a[n / 2][(n & 1) * 2 + 0] = pack_bf16(acc[4 * n], acc[4 * n + 1]);
    a[n / 2][(n & 1) * 2 + 1] = pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// Dl = rowsum(do o o) and lse * log2(e) into the workspace, D / 8 lanes a
// row, each a 16-byte load of o and of do; rows in the order of lse, padded
// to s_pad
template <int D>
__global__ void __launch_bounds__(256)
prep_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ lse2, float* __restrict__ dl,
            long long n_rows, int s_pad, BwdGeom gm) {
  constexpr int LPR = D / 8, RPW = 32 / LPR;  // lanes a row, rows a warp
  const int lane = threadIdx.x % 32;
  const long long row = (static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32) * RPW +
                        lane / LPR;
  if (row >= n_rows) return;  // n_rows is a multiple of 128: whole warps leave
  const int s = static_cast<int>(row % s_pad);
  const long long bhg = row / s_pad;
  float acc = 0.f;
  if (s < gm.S) {
    const int g = static_cast<int>(bhg % gm.G);
    const long long bh = bhg / gm.G;
    const int h = static_cast<int>(bh % gm.Hk), b = static_cast<int>(bh / gm.Hk);
    const int d = (lane % LPR) * 8;
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * gm.o_b + h * gm.o_h + g * gm.o_g + s * gm.o_s + d);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        dout + b * gm.do_b + h * gm.do_h + g * gm.do_g + s * gm.do_s + d);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(op[i]), df = __bfloat1622float2(dp[i]);
      acc = fmaf(of.x, df.x, acc);
      acc = fmaf(of.y, df.y, acc);
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane % LPR == 0) {
    lse2[row] = s < gm.S ? lse[bhg * gm.S + s] * kLog2e : INFINITY;
    dl[row] = s < gm.S ? acc : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                  const WgBwd gm) {
  using C = BwdCfg<D>;
  constexpr int BM = C::BM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // every block on a swizzle-atom boundary
  const unsigned char* gbase = smem_raw + (base - raw);
  // K, V, the ring; barriers: kv_full, kv_empty, full[STAGES], empty[STAGES]
  const uint32_t kv_full = base + C::KV_BAR, kv_empty = kv_full + 8;
  const uint32_t full0 = kv_full + 16, empty0 = full0 + 8 * C::KV_STAGES;
  const int S = gm.S, G = gm.G, kind = gm.kind, w = gm.window;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumerWarps);
    for (int s = 0; s < C::KV_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0, kvph = 0;
      for (int r = 0;; ++r) {
        const int t = round_item(r, gm.kv_total);
        if (t < 0) break;
        const KvItem it = kv_item(t, BM, gm);
        mbar_wait(kv_empty, kvph ^ 1);  // the previous item's K and V are no longer read
        mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
#pragma unroll
        for (int sub = 0; sub < C::NSUB; ++sub) {
          tma_load_4d(base + sub * C::KV_SUB, &tk, kv_full, sub * C::ATOM, it.k0, it.h, it.b);
          tma_load_4d(base + C::KV_BYTES + sub * C::KV_SUB, &tv, kv_full, sub * C::ATOM, it.k0,
                      it.h, it.b);
        }
        kvph ^= 1;
        for (int i = it.n_q - 1; i >= 0; --i) {
          const int q0 = it.k0 + i * BM;
          for (int g = 0; g < G; ++g) {
            const long long row = (static_cast<long long>(it.bh) * G + g) * gm.s_pad;
            const uint32_t st = base + C::KV_RING + s * C::KV_STEP, bar = full0 + 8 * s;
            mbar_wait(empty0 + 8 * s, ph ^ 1);  // the first pass over the ring finds it free
            mbar_expect_tx(bar, 2 * C::QT_BYTES + 2 * BM * 4);
#pragma unroll
            for (int sub = 0; sub < C::NSUB; ++sub) {
              tma_load_5d(st + sub * C::QT_SUB, &tq, bar, sub * C::ATOM, g, q0, it.h, it.b);
              tma_load_5d(st + C::QT_BYTES + sub * C::QT_SUB, &tdo, bar, sub * C::ATOM, g, q0,
                          it.h, it.b);
            }
            bulk_load(st + 2 * C::QT_BYTES, gm.lse2 + row + q0, BM * 4, bar);
            bulk_load(st + 2 * C::QT_BYTES + BM * 4, gm.dl + row + q0, BM * 4, bar);
            if (++s == C::KV_STAGES) {
              s = 0;
              ph ^= 1;
            }
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups of 64 keys ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t128 = threadIdx.x - 128, cw = t128 / 128, warp = (t128 % 128) / 32;
    const int lane = t128 % 32, tid = lane % 4;
    const float c = gm.c;
    auto release = [&](uint32_t bar) {  // this warp no longer reads what `bar` guards
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    float dka[D / 2], dva[D / 2], sacc[BM / 2], pacc[BM / 2];
    uint32_t pa[BM / 16][4], da[BM / 16][4];
    int s = 0;
    uint32_t ph = 0, kvph = 0;
    for (int r = 0;; ++r) {
      const int t = round_item(r, gm.kv_total);
      if (t < 0) break;
      const KvItem it = kv_item(t, BM, gm);
      const int kmin = it.k0 + 64 * cw;
      const int kp_lo = kmin + 16 * warp + lane / 4, kp_hi = kp_lo + 8;
      // the last query each of the thread's two keys is seen by
      auto last_q = [&](int kp) {
        if (kind == 1) return kp + w - 1;
        if (kind == 2) return (kp / w + 1) * w - 1;
        return 1 << 30;
      };
      const int ql_lo = last_q(kp_lo), ql_hi = last_q(kp_hi);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
      mbar_wait(kv_full, kvph);
      kvph ^= 1;
      const uint32_t ka = base + cw * 64 * C::ROWB, va = ka + C::KV_BYTES;
      bool pending = false;  // a dV, dK product still reads stage `prev`
      int prev = 0;
      for (int i = it.n_q - 1; i >= 0; --i) {
        const int q0 = it.k0 + i * BM;
        const int state = kv_state(q0, BM, kmin, S, kind, w);
        for (int g = 0; g < G; ++g) {
          mbar_wait(full0 + 8 * s, ph);
          if (state != kSkip) {
            const uint32_t qs = base + C::KV_RING + s * C::KV_STEP, ds = qs + C::QT_BYTES;
            const float* ls = reinterpret_cast<const float*>(gbase + C::KV_RING +
                                                             s * C::KV_STEP + 2 * C::QT_BYTES);
            const float* dls = ls + BM;
            wgmma_fence();
            // S^T = K Q^T, then dP^T = V dO^T (Q and dO K-major)
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
              const uint32_t off = (kk / C::KSTEPS) * C::QT_SUB + (kk % C::KSTEPS) * 32;
              const uint32_t ao = (kk / C::KSTEPS) * C::KV_SUB + (kk % C::KSTEPS) * 32;
              wgmma_ss<BM>(sacc, sdesc(ka + ao, 16, 8 * C::ROWB, C::MODE),
                           sdesc(qs + off, 16, 8 * C::ROWB, C::MODE), kk > 0);
            }
            wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
              const uint32_t off = (kk / C::KSTEPS) * C::QT_SUB + (kk % C::KSTEPS) * 32;
              const uint32_t ao = (kk / C::KSTEPS) * C::KV_SUB + (kk % C::KSTEPS) * 32;
              wgmma_ss<BM>(pacc, sdesc(va + ao, 16, 8 * C::ROWB, C::MODE),
                           sdesc(ds + off, 16, 8 * C::ROWB, C::MODE), kk > 0);
            }
            wgmma_commit();
            wgmma_wait_one();  // the previous step's dV, dK and this S^T are done
            fence_regs<BM / 2>(sacc);
            if (pending) release(empty0 + 8 * prev);
            // P^T: row key kp, column query q0 + 8n + 2 tid + (e & 1); the
            // mask keeps kp <= q <= last_q(kp)
            {
              const int x0 = q0 + 2 * tid;
              const int lo_a = kp_lo - x0, hi_a = ql_lo - x0, lo_b = kp_hi - x0, hi_b = ql_hi - x0;
#pragma unroll
              for (int n = 0; n < BM / 8; ++n) {
                const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * tid);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int j = 8 * n + (e & 1);
                  float p = ex2(fmaf(sacc[4 * n + e], c, -((e & 1) ? l2.y : l2.x)));
                  if (state == kMasked) {
                    const bool ok = e < 2 ? (j >= lo_a && j <= hi_a) : (j >= lo_b && j <= hi_b);
                    if (!ok) p = 0.f;
                  }
                  sacc[4 * n + e] = p;
                }
              }
            }
            wgmma_wait_all();  // dP^T is done
            fence_regs<BM / 2>(pacc);
            // dS^T = P^T o (dP^T - Dl)
#pragma unroll
            for (int n = 0; n < BM / 8; ++n) {
              const float2 d2 = *reinterpret_cast<const float2*>(dls + 8 * n + 2 * tid);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                pacc[4 * n + e] = sacc[4 * n + e] * (pacc[4 * n + e] - ((e & 1) ? d2.y : d2.x));
            }
            pack_frags<BM>(pa, sacc);
            pack_frags<BM>(da, pacc);
            wgmma_fence();
            // dV += P^T dO, dK += dS^T Q (dO and Q N-major: the transpose bit)
#pragma unroll
            for (int j = 0; j < BM / 16; ++j)
              wgmma_rs<D>(dva, pa[j], sdesc(ds + j * 16 * C::ROWB, C::QT_SUB, 8 * C::ROWB, C::MODE));
#pragma unroll
            for (int j = 0; j < BM / 16; ++j)
              wgmma_rs<D>(dka, da[j], sdesc(qs + j * 16 * C::ROWB, C::QT_SUB, 8 * C::ROWB, C::MODE));
            wgmma_commit();
            pending = true;
            prev = s;
          } else {
            // nothing of this stage is read; a pending product is finished
            // first, so a run of skipped steps that wraps the ring never
            // finds its own earlier stage still held
            if (pending) {
              wgmma_wait_all();
              release(empty0 + 8 * prev);
              pending = false;
            }
            release(empty0 + 8 * s);
          }
          if (++s == C::KV_STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
      wgmma_wait_all();
      fence_regs<D / 2>(dka);
      fence_regs<D / 2>(dva);
      if (pending) release(empty0 + 8 * prev);
      release(kv_empty);  // the producer may load the next item's K and V
      __nv_bfloat16* dkb = dk + it.b * gm.dk_b + it.h * gm.dk_h;
      __nv_bfloat16* dvb = dv + it.b * gm.dv_b + it.h * gm.dv_h;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int kp = rr ? kp_hi : kp_lo;
        if (kp >= S) continue;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const int d = 8 * n + 2 * tid;
          *reinterpret_cast<uint32_t*>(dkb + kp * gm.dk_s + d) =
              pack_bf16(dka[4 * n + 2 * rr] * gm.scale, dka[4 * n + 2 * rr + 1] * gm.scale);
          *reinterpret_cast<uint32_t*>(dvb + kp * gm.dv_s + d) =
              pack_bf16(dva[4 * n + 2 * rr], dva[4 * n + 2 * rr + 1]);
        }
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ dq, const WgBwd gm) {
  using C = BwdCfg<D>;
  constexpr int BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // Q, dO, the ring; barriers: q_full, q_empty, full[STAGES], empty[STAGES]
  const uint32_t q_full = base + C::Q_BAR, q_empty = q_full + 8;
  const uint32_t full0 = q_full + 16, empty0 = full0 + 8 * C::Q_STAGES;
  const int S = gm.S, kind = gm.kind, w = gm.window;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < C::Q_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0, qph = 0;
      for (int r = 0;; ++r) {
        const int t = round_item(r, gm.q_total);
        if (t < 0) break;
        const QItem it = q_item(t, BN, gm);
        mbar_wait(q_empty, qph ^ 1);  // the previous item's Q and dO are no longer read
        mbar_expect_tx(q_full, 2 * C::QO_BYTES);
#pragma unroll
        for (int sub = 0; sub < C::NSUB; ++sub) {
          tma_load_5d(base + sub * C::QO_SUB, &tq, q_full, sub * C::ATOM, it.g, it.q0, it.h,
                      it.b);
          tma_load_5d(base + C::QO_BYTES + sub * C::QO_SUB, &tdo, q_full, sub * C::ATOM, it.g,
                      it.q0, it.h, it.b);
        }
        qph ^= 1;
        for (int i = 0; i < it.n_k; ++i) {
          const int kt = it.k_first + i * BN;
          const uint32_t st = base + C::Q_RING + s * C::Q_STEP, bar = full0 + 8 * s;
          mbar_wait(empty0 + 8 * s, ph ^ 1);
          mbar_expect_tx(bar, C::Q_STEP);
#pragma unroll
          for (int sub = 0; sub < C::NSUB; ++sub) {
            tma_load_4d(st + sub * C::KS_SUB, &tk, bar, sub * C::ATOM, kt, it.h, it.b);
            tma_load_4d(st + C::KS_BYTES + sub * C::KS_SUB, &tv, bar, sub * C::ATOM, kt, it.h,
                        it.b);
          }
          if (++s == C::Q_STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups of 64 queries ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t128 = threadIdx.x - 128, cw = t128 / 128, warp = (t128 % 128) / 32;
    const int lane = t128 % 32, tid = lane % 4;
    const float c = gm.c;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    float dqa[D / 2], sacc[BN / 2], pacc[BN / 2];
    uint32_t da[BN / 16][4];
    int s = 0;
    uint32_t ph = 0, qph = 0;
    for (int r = 0;; ++r) {
      const int t = round_item(r, gm.q_total);
      if (t < 0) break;
      const QItem it = q_item(t, BN, gm);
      const int qa = it.q0 + 64 * cw;
      const int qp_lo = qa + 16 * warp + lane / 4, qp_hi = qp_lo + 8;
      const long long row = static_cast<long long>(it.bhg) * gm.s_pad;
      const float l_lo = gm.lse2[row + qp_lo], l_hi = gm.lse2[row + qp_hi];
      const float d_lo = gm.dl[row + qp_lo], d_hi = gm.dl[row + qp_hi];
      const int fk_lo = first_key(qp_lo, kind, w), fk_hi = first_key(qp_hi, kind, w);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
      mbar_wait(q_full, qph);
      qph ^= 1;
      const uint32_t qa_s = base + cw * 64 * C::ROWB, oa_s = qa_s + C::QO_BYTES;
      bool pending = false;  // a dQ product still reads stage `prev`
      int prev = 0;
      for (int i = 0; i < it.n_k; ++i) {
        const int kt = it.k_first + i * BN;
        const int state = dq_state(kt, BN, qa, S, kind, w);
        mbar_wait(full0 + 8 * s, ph);
        if (state != kSkip) {
          const uint32_t ks = base + C::Q_RING + s * C::Q_STEP, vs = ks + C::KS_BYTES;
          wgmma_fence();
          // S = Q K^T, then dP = dO V^T (K and V K-major)
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off = (kk / C::KSTEPS) * C::KS_SUB + (kk % C::KSTEPS) * 32;
            const uint32_t ao = (kk / C::KSTEPS) * C::QO_SUB + (kk % C::KSTEPS) * 32;
            wgmma_ss<BN>(sacc, sdesc(qa_s + ao, 16, 8 * C::ROWB, C::MODE),
                         sdesc(ks + off, 16, 8 * C::ROWB, C::MODE), kk > 0);
          }
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off = (kk / C::KSTEPS) * C::KS_SUB + (kk % C::KSTEPS) * 32;
            const uint32_t ao = (kk / C::KSTEPS) * C::QO_SUB + (kk % C::KSTEPS) * 32;
            wgmma_ss<BN>(pacc, sdesc(oa_s + ao, 16, 8 * C::ROWB, C::MODE),
                         sdesc(vs + off, 16, 8 * C::ROWB, C::MODE), kk > 0);
          }
          wgmma_commit();
          wgmma_wait_one();  // the previous step's dQ and this S are done
          fence_regs<BN / 2>(sacc);
          if (pending) release(empty0 + 8 * prev);
          // P: row query qp, column key kt + 8n + 2 tid + (e & 1); the mask
          // keeps first_key(qp) <= k <= qp
          {
            const int x0 = kt + 2 * tid;
            const int lo_a = fk_lo - x0, hi_a = qp_lo - x0, lo_b = fk_hi - x0, hi_b = qp_hi - x0;
#pragma unroll
            for (int n = 0; n < BN / 8; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int j = 8 * n + (e & 1);
                float p = ex2(fmaf(sacc[4 * n + e], c, -(e < 2 ? l_lo : l_hi)));
                if (state == kMasked) {
                  const bool ok = e < 2 ? (j >= lo_a && j <= hi_a) : (j >= lo_b && j <= hi_b);
                  if (!ok) p = 0.f;
                }
                sacc[4 * n + e] = p;
              }
          }
          wgmma_wait_all();  // dP is done
          fence_regs<BN / 2>(pacc);
          // dS = P o (dP - Dl)
#pragma unroll
          for (int n = 0; n < BN / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              pacc[4 * n + e] = sacc[4 * n + e] * (pacc[4 * n + e] - (e < 2 ? d_lo : d_hi));
          pack_frags<BN>(da, pacc);
          wgmma_fence();
          // dQ += dS K (K N-major: the transpose bit)
#pragma unroll
          for (int j = 0; j < BN / 16; ++j)
            wgmma_rs<D>(dqa, da[j], sdesc(ks + j * 16 * C::ROWB, C::KS_SUB, 8 * C::ROWB, C::MODE));
          wgmma_commit();
          pending = true;
          prev = s;
        } else {
          if (pending) {  // as in the dK/dV walk
            wgmma_wait_all();
            release(empty0 + 8 * prev);
            pending = false;
          }
          release(empty0 + 8 * s);
        }
        if (++s == C::Q_STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait_all();
      fence_regs<D / 2>(dqa);
      if (pending) release(empty0 + 8 * prev);
      release(q_empty);  // the producer may load the next item's Q and dO
      __nv_bfloat16* dqb = dq + it.b * gm.dq_b + it.h * gm.dq_h + it.g * gm.dq_g;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int qp = rr ? qp_hi : qp_lo;
        if (qp >= S) continue;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(dqb + qp * gm.dq_s + 8 * n + 2 * tid) =
              pack_bf16(dqa[4 * n + 2 * rr] * gm.scale, dqa[4 * n + 2 * rr + 1] * gm.scale);
      }
    }
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

// q or dO (B, Hk, G, S, D) as dims {D, G, S, Hk, B}, a box of `rows`
// positions of one head; k or v (B, Hk, S, D) as {D, S, Hk, B}, a box of
// `rows` keys
int map_5d(CUtensorMap* map, const void* p, int B, int Hk, int G, int S, int D,
           const long long* st, int atom, int rows, CUtensorMapSwizzle sw) {
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t dims[5] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)S, (cuuint64_t)Hk,
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {st[2] * e, st[3] * e, st[1] * e, st[0] * e};  // g, s, h, b
  const cuuint32_t box[5] = {(cuuint32_t)atom, 1, (cuuint32_t)rows, 1, 1};
  return encode_map(map, p, 5, dims, strides, box, sw);
}

int map_4d(CUtensorMap* map, const void* p, int B, int Hk, int S, int D, const long long* st,
           int atom, int rows, CUtensorMapSwizzle sw) {
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)Hk, (cuuint64_t)B};
  const cuuint64_t strides[3] = {st[2] * e, st[1] * e, st[0] * e};  // s, h, b
  const cuuint32_t box[4] = {(cuuint32_t)atom, (cuuint32_t)rows, 1, 1};
  return encode_map(map, p, 4, dims, strides, box, sw);
}

template <int D>
int launch_wgmma(cudaStream_t st, const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* ws, const int* order, int kv_grid,
                 int q_grid, void* dq, void* dk, void* dv, int B, const BwdGeom& gm,
                 const long long* strides) {
  using C = BwdCfg<D>;
  using bf = __nv_bfloat16;
  const int S = gm.S, Hk = gm.Hk, G = gm.G;
  const int s_pad = (S + kPadTo - 1) / kPadTo * kPadTo, n_t = s_pad / kPadTo;
  const long long n_rows = static_cast<long long>(B) * Hk * G * s_pad;
  const long long kv_total = static_cast<long long>(B) * Hk * n_t;
  const long long q_total = static_cast<long long>(B) * Hk * G * n_t;
  if (q_total > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (kv_grid < 1 || kv_grid > kv_total || q_grid < 1 || q_grid > q_total)
    return cudaErrorInvalidConfiguration;
  float* lse2 = ws;
  float* dl = ws + n_rows;
  {
    constexpr int RPB = 8 * (32 / (D / 8));  // rows a block of eight warps
    prep_kernel<D><<<static_cast<unsigned>((n_rows + RPB - 1) / RPB), 256, 0, st>>>(
        static_cast<const bf*>(o), static_cast<const bf*>(dout), lse, lse2, dl, n_rows, s_pad,
        gm);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const CUtensorMapSwizzle sw =
      C::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const long long* sq = strides;        // q_b, q_h, q_g, q_s
  const long long* sk = strides + 4;    // k_b, k_h, k_s
  const long long* sv = strides + 7;    // v_b, v_h, v_s
  const long long* sdo = strides + 14;  // do_b, do_h, do_g, do_s
  CUtensorMap kq, kdo, kk, kv, qq, qdo, qk, qv;  // the dK/dV kernel's maps, then dQ's
  if (int r = map_5d(&kq, q, B, Hk, G, S, D, sq, C::ATOM, C::BM, sw)) return r;
  if (int r = map_5d(&kdo, dout, B, Hk, G, S, D, sdo, C::ATOM, C::BM, sw)) return r;
  if (int r = map_4d(&kk, k, B, Hk, S, D, sk, C::ATOM, C::KN, sw)) return r;
  if (int r = map_4d(&kv, v, B, Hk, S, D, sv, C::ATOM, C::KN, sw)) return r;
  if (int r = map_5d(&qq, q, B, Hk, G, S, D, sq, C::ATOM, C::QN, sw)) return r;
  if (int r = map_5d(&qdo, dout, B, Hk, G, S, D, sdo, C::ATOM, C::QN, sw)) return r;
  if (int r = map_4d(&qk, k, B, Hk, S, D, sk, C::ATOM, C::BN, sw)) return r;
  if (int r = map_4d(&qv, v, B, Hk, S, D, sv, C::ATOM, C::BN, sw)) return r;
  WgBwd wg;
  wg.S = S; wg.G = G; wg.Hk = Hk; wg.bhn = B * Hk; wg.bhgn = B * Hk * G; wg.n_kt = n_t;
  wg.kv_total = static_cast<int>(kv_total); wg.q_total = static_cast<int>(q_total);
  wg.kind = gm.window > 0 ? gm.kind : 0; wg.window = gm.window;
  wg.s_pad = s_pad;
  wg.c = gm.scale * kLog2e; wg.scale = gm.scale;
  wg.order = order; wg.lse2 = lse2; wg.dl = dl;
  wg.dq_b = gm.dq_b; wg.dq_h = gm.dq_h; wg.dq_g = gm.dq_g; wg.dq_s = gm.dq_s;
  wg.dk_b = gm.dk_b; wg.dk_h = gm.dk_h; wg.dk_s = gm.dk_s;
  wg.dv_b = gm.dv_b; wg.dv_h = gm.dv_h; wg.dv_s = gm.dv_s;
  cudaError_t err = set_smem(dkdv_wgmma_kernel<D>, C::KV_SMEM);
  if (err != cudaSuccess) return err;
  dkdv_wgmma_kernel<D><<<kv_grid, kThreads, C::KV_SMEM, st>>>(
      kq, kdo, kk, kv, static_cast<bf*>(dk), static_cast<bf*>(dv), wg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(dq_wgmma_kernel<D>, C::Q_SMEM)) != cudaSuccess) return err;
  dq_wgmma_kernel<D><<<q_grid, kThreads, C::Q_SMEM, st>>>(qq, qdo, qk, qv,
                                                          static_cast<bf*>(dq), wg);
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

// The bf16 route's tile sizes for head dim D, which the host's plan
// (kernels/flash_attention.py::bwd_plan) mirrors: out = {keys a dK/dV work
// item, queries a step of its walk, its stages, its shared bytes, queries a
// dQ work item, keys a step of its walk, its stages, its shared bytes, the
// workspace's row padding}. Returns 0, or cudaErrorInvalidValue for a D the
// kernels are not built for.
extern "C" int flash_attention_bwd_config(int D, int* out) {
  auto fill = [&](auto cfg) {
    using C = decltype(cfg);
    const int vals[9] = {C::KN, C::BM, C::KV_STAGES, C::KV_SMEM, C::QN, C::BN, C::Q_STAGES,
                         C::Q_SMEM, kPadTo};
    for (int i = 0; i < 9; ++i) out[i] = vals[i];
    return 0;
  };
  switch (D) {
    case 32: return fill(BwdCfg<32>{});
    case 64: return fill(BwdCfg<64>{});
    case 128: return fill(BwdCfg<128>{});
    default: return cudaErrorInvalidValue;
  }
}

// q, o, do, dq (B, Hk, G, S, D), k, v, dk, dv (B, Hk, S, D), all through
// strides in elements with the last dim contiguous: st = {q_b, q_h, q_g,
// q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_g, o_s, do_b, do_h, do_g,
// do_s, dq_b, dq_h, dq_g, dq_s, dk_b, dk_h, dk_s, dv_b, dv_h, dv_s}. lse:
// the forward's f32 (B, Hk, G, S), contiguous. kind: 0 full, 1 sliding, 2
// chunked. D: 32, 64 or 128. dtype 0 (f32): ws is f32 scratch of lse's
// shape (Dl), order is unused. dtype 1 (bf16; every stride but the last a
// positive multiple of 8 elements, base pointers 16-byte aligned): ws is f32
// scratch of 2 B Hk G s_pad (s_pad = S rounded up to 128), order the plan's
// int32 key tiles then query tiles, on the device, and kv_grid, q_grid the
// plan's persistent grids (1 to the kernel's work items each).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const float* lse,
                                          float* ws, const int* order, int kv_grid,
                                          int q_grid, void* dq, void* dk, void* dv, int B,
                                          int Hk, int G, int S, int D,
                                          const long long* st, float scale, int kind,
                                          int window, int dtype, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * Hk * G * S;
  if (rows == 0) return cudaSuccess;
  if (dtype == 1) {
    if (order == nullptr) return cudaErrorInvalidValue;
    switch (D) {
      case 32:
        return launch_wgmma<32>(s, q, k, v, o, dout, lse, ws, order, kv_grid, q_grid, dq, dk,
                                 dv, B, gm, st);
      case 64:
        return launch_wgmma<64>(s, q, k, v, o, dout, lse, ws, order, kv_grid, q_grid, dq, dk,
                                 dv, B, gm, st);
      default:
        return launch_wgmma<128>(s, q, k, v, o, dout, lse, ws, order, kv_grid, q_grid, dq, dk,
                                 dv, B, gm, st);
    }
  }
  if ((S + 31) / 32 > 65535) return cudaErrorInvalidConfiguration;
  const unsigned dgrid = static_cast<unsigned>((rows + 7) / 8);
  delta_kernel<float><<<dgrid, 256, 0, s>>>(static_cast<const float*>(o),
                                            static_cast<const float*>(dout), ws, B, D, gm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (D) {
    case 32: return launch_f32<32>(s, q, k, v, dout, lse, ws, dq, dk, dv, B, gm);
    case 64: return launch_f32<64>(s, q, k, v, dout, lse, ws, dq, dk, dv, B, gm);
    default: return launch_f32<128>(s, q, k, v, dout, lse, ws, dq, dk, dv, B, gm);
  }
}
