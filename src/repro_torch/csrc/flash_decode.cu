// K5 on Hopper: one query token per (batch, kv head), with its G grouped
// query heads, against a KV cache; slots at or past valid_len are masked.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::flash_decode
// (_decode_kernel). What it computes is the reference's: f32 scores times
// `scale`, a softmax with the finite -1e30 sentinel, p rounded to the value
// dtype before the P.V product, l floored at 1e-30, the output in q's
// dtype. valid_len is a 0-d or (B,) int32 tensor read on the device.
//
// Bound on the H100: it must read the valid part of K and V once. At the
// serving decode shape (B, Hk, G, L, D) = (8, 4, 8, 640, 64) in bf16 with
// the cache full that is 5.3 MB, 1.6 us at 3.35 TB/s: bound by bytes, and
// at this size in practice by the latency of one pass over the cache and
// of the launch.
//
// Design: split the cache over a thread-block cluster.
//  - Each (b, kv head, group of up to 8 query heads) is a cluster of
//    `nsplit` CTAs (at most 8, the portable size); CTA r takes the slots
//    [r * split, (r + 1) * split). The split depends on L alone (the
//    wrapper's plan_splits), never on B or on valid_len, so a row's result
//    depends on that row alone: 8 x 32 = 256 CTAs of 80 slots at the shape
//    above.
//  - A CTA issues its valid slots of K, then of V, as two cp.async groups
//    with every 16-byte load in flight (a tile of up to 128 slots; 20 KB
//    at the shape above), in the caller's layout through strides, so the
//    model's (B, L, Hk, D) ring cache needs no transpose and the ragged
//    tail is never read; Q's load overlaps valid_len's.
//  - bf16: S = Q K^T and O += P V on the tensor cores (mma.sync m16n8k16,
//    Q's heads as the 16 rows), scores kept in registers; f32: FMA, one
//    slot per lane group. Softmax by block: the tile's max over the warps,
//    one exp a score, one rescale a tile. p is rounded to the value dtype
//    before P.V, as the reference does.
//  - A split that starts at or past valid_len reads nothing and sends the
//    sentinel (m = -1e30, l = 0).
//  - The partials meet in distributed shared memory. The output's elements
//    are shared out over the ranks; each CTA sends each rank that rank's
//    slice of its (acc, m, l) by st.async, which completes a transaction
//    count on the receiver's mbarrier, and then merges its own slice in
//    rank order once its bytes have come. One cluster barrier (everyone
//    started) precedes the first remote store. One launch, no workspace,
//    no atomics: launches repeat bitwise.
//
// Plain C interface for ctypes: flash_decode_launch returns the CUDA error
// of the launch (0 on success).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxSplits = 8;  // the portable cluster size
constexpr int kGroup = 8;      // query heads of a CTA, at most

struct Strides {  // elements; the last dim is contiguous
  long long q_b, q_h, q_g, k_b, k_h, k_l, v_b, v_h, v_l;
};

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load16(const float* p, float* out) {
  float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// mbarrier and remote-store helpers: a partial goes to another rank by
// st.async, whose bytes complete a transaction count on that rank's mbarrier
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_async(uint32_t addr, float a, float b, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n"
      ::"r"(addr), "f"(a), "f"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, float a, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n"
               ::"r"(addr), "f"(a), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// The split cluster barrier: arrive early, wait late
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared memory of a CTA. Rows of K, V and Q are padded by 16 bytes so
// the eight rows of an ldmatrix fall in distinct banks; Q and P have 16
// rows (the query heads, zero past G) for the m16 tensor-core tile.
template <typename T, int D>
struct Smem {
  static constexpr int kPad = 16 / static_cast<int>(sizeof(T));
  static constexpr int kLd = D + kPad;  // row stride of K, V and Q
  static constexpr int kPerRow = 16384 / (D * static_cast<int>(sizeof(T)));
  static constexpr int kSlots = kPerRow < 128 ? kPerRow : 128;  // slots a tile
  static constexpr int kLdp = kSlots + 8;  // row stride of P in bf16
  static constexpr int k_off = 0;
  static constexpr int v_off = k_off + kSlots * kLd * sizeof(T);
  static constexpr int q_off = v_off + kSlots * kLd * sizeof(T);
  // f32 route: the tile's scores, then p; bf16: each warp's max and sum
  static constexpr int s_off = q_off + 16 * kLd * sizeof(T);
  static constexpr int pb_off = s_off + kGroup * kSlots * 4;   // bf16 P
  static constexpr int part_off = pb_off + 16 * kLdp * 2;      // the partials
  static constexpr int pm_off = part_off + kMaxSplits * kGroup * D * 4;
  static constexpr int pl_off = pm_off + kMaxSplits * kGroup * 4;
  static constexpr int m_off = pl_off + kMaxSplits * kGroup * 4;
  static constexpr int bar_off = m_off + 4 * kGroup * 4;  // 8-byte aligned
  static constexpr int bytes = bar_off + 8;
};

template <typename T, int D, int kThreads>
__global__ void __launch_bounds__(kThreads)
split_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ vlen,
                    int vlen_stride, T* __restrict__ out, int Hk, int G, int L,
                    int split, Strides st, float scale) {
  using SM = Smem<T, D>;
  constexpr int kWarps = kThreads / 32;
  constexpr bool kTensor = sizeof(T) == 2;  // bf16: QK^T and PV on mma.sync
  constexpr int VEC = Vec<T>::N;
  constexpr int LPS = D / VEC;   // lanes per slot (f32 route)
  constexpr int SPW = 32 / LPS;  // slots per warp step (f32 route)
  constexpr int TS = SM::kSlots, LD = SM::kLd;
  constexpr int PAIRS = kGroup * D / 2;                   // (head, 2 dims)
  constexpr int PPT = (PAIRS + kThreads - 1) / kThreads;  // pairs a thread
  constexpr int NPW = (D / 8 + kWarps - 1) / kWarps;     // PV n-tiles a warp
  constexpr int NSW = (SM::kSlots / 8 + kWarps - 1) / kWarps;  // S n-tiles a warp
  static_assert(LPS >= 1 && LPS <= 32 && 32 % LPS == 0, "unsupported D");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw + SM::k_off);
  T* v_s = reinterpret_cast<T*>(smem_raw + SM::v_off);
  T* q_s = reinterpret_cast<T*>(smem_raw + SM::q_off);
  float* p_s = reinterpret_cast<float*>(smem_raw + SM::s_off);  // (kGroup, TS)
  __nv_bfloat16* pb_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + SM::pb_off);
  float* part_acc = reinterpret_cast<float*>(smem_raw + SM::part_off);
  float* part_m = reinterpret_cast<float*>(smem_raw + SM::pm_off);
  float* part_l = reinterpret_cast<float*>(smem_raw + SM::pl_off);
  float* m_s = reinterpret_cast<float*>(smem_raw + SM::m_off);
  float* l_s = m_s + kGroup;
  float* alpha_s = l_s + kGroup;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + SM::bar_off);

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  if (threadIdx.x == 0) mbar_init(bar, 1);
  cluster_arrive_relaxed();  // "started": waited on before the first remote store
  const int nsplit = gridDim.x;  // the cluster spans the grid's x
  const int b = blockIdx.y / Hk, h = blockIdx.y % Hk;
  const int g0 = blockIdx.z * kGroup;
  const int gn = min(kGroup, G - g0);  // query heads of this CTA
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row and column pair

  int n = vlen[static_cast<long long>(b) * vlen_stride];
  // Q in flight while valid_len arrives (f32 route: in registers; bf16: a
  // 16-byte piece a thread, for 16 shared rows, zero past the heads)
  const int sg = lane / LPS, li = lane % LPS, d0 = li * VEC;
  float qr[kTensor ? 1 : kGroup][VEC];
  constexpr int QPT = (16 * (D / VEC) + kThreads - 1) / kThreads;  // Q pieces a thread
  uint4 qv[QPT];
  if constexpr (kTensor) {
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int e = threadIdx.x + i * kThreads, row = e / (D / VEC);
      qv[i] = row < gn ? *reinterpret_cast<const uint4*>(q + b * st.q_b + h * st.q_h +
                                                        (g0 + row) * st.q_g +
                                                        (e % (D / VEC)) * VEC)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
#pragma unroll
    for (int gg = 0; gg < kGroup; ++gg) {
      if (gg < gn) {
        load16(q + b * st.q_b + h * st.q_h + (g0 + gg) * st.q_g + d0, qr[gg]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) qr[gg][j] = 0.f;
      }
    }
  }
  // no valid slot: every score is the sentinel, and the plain softmax is
  // uniform over all L slots; take them all with equal scores
  const bool none_valid = n <= 0;
  n = none_valid ? L : min(n, L);
  const int s_lo = rank * split, s_hi = min(s_lo + split, n);

  // K, then V, of the tile from t0: each a cp.async group, every load in flight
  const T* kb = k + b * st.k_b + h * st.k_h;
  const T* vb = v + b * st.v_b + h * st.v_h;
  constexpr int CPR = D / VEC;  // 16-byte pieces a row
  auto issue = [&](int t0, int nt) {
    for (int e = threadIdx.x; e < nt * CPR; e += kThreads) {
      const int r = e / CPR, c = (e % CPR) * VEC;
      cp_async16(k_s + r * LD + c, kb + (t0 + r) * st.k_l + c);
    }
    cp_async_commit();
    for (int e = threadIdx.x; e < nt * CPR; e += kThreads) {
      const int r = e / CPR, c = (e % CPR) * VEC;
      cp_async16(v_s + r * LD + c, vb + (t0 + r) * st.v_l + c);
    }
    cp_async_commit();
  };
  if (s_lo < s_hi) issue(s_lo, min(TS, s_hi - s_lo));
  if constexpr (kTensor) {
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int e = threadIdx.x + i * kThreads, row = e / (D / VEC);
      if (row < 16) *reinterpret_cast<uint4*>(q_s + row * LD + (e % (D / VEC)) * VEC) = qv[i];
    }
    for (int e = threadIdx.x; e < 16 * SM::kLdp; e += kThreads)
      pb_s[e] = __float2bfloat16(0.f);
  }
  if (threadIdx.x < kGroup) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }
  float acc[PPT][2];   // f32 route: (head, 2 dims) pairs
  float oacc[NPW][4];  // bf16 route: the PV tiles of this warp
#pragma unroll
  for (int e = 0; e < PPT; ++e) acc[e][0] = acc[e][1] = 0.f;
#pragma unroll
  for (int e = 0; e < NPW; ++e) oacc[e][0] = oacc[e][1] = oacc[e][2] = oacc[e][3] = 0.f;

  for (int t0 = s_lo; t0 < s_hi; t0 += TS) {
    const int nt = min(TS, s_hi - t0);
    const int ntp = (nt + 15) & ~15;  // slots rounded up to the mma depth
    if (t0 != s_lo) issue(t0, nt);
    // V rows past the tile up to the mma depth are zero (their p is zero)
    for (int e = threadIdx.x; e < (ntp - nt) * D; e += kThreads)
      v_s[(nt + e / D) * LD + e % D] = T(0.f);
    cp_async_wait<1>();  // K has landed
    __syncthreads();
    float alpha = 0.f;  // bf16 route: the rescale of this thread's head g
    if constexpr (kTensor) {
      // S = Q K^T: warp w takes the 8-slot columns w, w + 8, ... and keeps
      // them in registers (head g, slots 8 nb + 2 t4 and + 1); the softmax
      // meets across warps through red_s: each warp's max, then its sum
      float* red_s = p_s;  // (2, kWarps, kGroup)
      uint32_t qa[D / 16][4];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm(qa[kk], q_s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 16 * kk +
                         8 * (lane >> 4));
      // every column block of the shared tile, with no branch: the ones past
      // the slots (stale rows of K) are computed and dropped
      float sacc[NSW][4];
#pragma unroll
      for (int e = 0; e < NSW; ++e) sacc[e][0] = sacc[e][1] = sacc[e][2] = sacc[e][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
#pragma unroll
        for (int e = 0; e < NSW; ++e) {
          uint32_t kf[4];  // K stored (slot, d): the col operand, no transpose
          ldsm(kf, k_s + (8 * (warp + e * kWarps) + (lane & 7)) * LD + 16 * kk +
                       8 * (lane >> 3));
          mma(sacc[e], qa[kk], kf[0], kf[1]);
          mma(sacc[e], qa[kk + 1], kf[2], kf[3]);
        }
      }
      float sv[NSW][2];
      float wmax = kNegInf;
#pragma unroll
      for (int e = 0; e < NSW; ++e) {
        const int j = 8 * (warp + e * kWarps) + 2 * t4;
        sv[e][0] = j < nt ? (none_valid ? 0.f : sacc[e][0] * scale) : kNegInf;
        sv[e][1] = j + 1 < nt ? (none_valid ? 0.f : sacc[e][1] * scale) : kNegInf;
        wmax = fmaxf(wmax, fmaxf(sv[e][0], sv[e][1]));
      }
      wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, 1));
      wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, 2));
      if (t4 == 0) red_s[warp * kGroup + g] = wmax;
      __syncthreads();
      float m_new = m_s[g];
      for (int w = 0; w < kWarps; ++w) m_new = fmaxf(m_new, red_s[w * kGroup + g]);
      alpha = expf(m_s[g] - m_new);
      // p rounded to bf16 for P.V, as the reference's p.astype(v.dtype);
      // zero past the tile up to the mma depth and in the rows past the heads
      float wsum = 0.f;
#pragma unroll
      for (int e = 0; e < NSW; ++e) {
        const int nb = warp + e * kWarps;
        if (nb * 8 < ntp) {
          const float p0 = g < gn ? expf(sv[e][0] - m_new) : 0.f;
          const float p1 = g < gn ? expf(sv[e][1] - m_new) : 0.f;
          wsum += p0 + p1;
          *reinterpret_cast<__nv_bfloat162*>(pb_s + g * SM::kLdp + 8 * nb + 2 * t4) =
              __floats2bfloat162_rn(p0, p1);
        }
      }
      wsum += __shfl_xor_sync(0xffffffffu, wsum, 1);
      wsum += __shfl_xor_sync(0xffffffffu, wsum, 2);
      if (t4 == 0) red_s[(kWarps + warp) * kGroup + g] = wsum;
      cp_async_wait<0>();  // V has landed
      __syncthreads();
      if (threadIdx.x < gn) {  // the head's running (m, l), warps in order
        const int gg = threadIdx.x;
        float mn = m_s[gg], sum = 0.f;
        for (int w = 0; w < kWarps; ++w) mn = fmaxf(mn, red_s[w * kGroup + gg]);
        for (int w = 0; w < kWarps; ++w) sum += red_s[(kWarps + w) * kGroup + gg];
        l_s[gg] = l_s[gg] * expf(m_s[gg] - mn) + sum;
        m_s[gg] = mn;
      }
    } else {
      // scores: LPS lanes a slot, every query head per slot
      for (int base = warp * SPW; base < nt; base += kWarps * SPW) {
        const int slot = base + sg;
        float kr[VEC];
        if (slot < nt) {
          load16(k_s + slot * LD + d0, kr);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) kr[j] = 0.f;
        }
        float sc[kGroup];
#pragma unroll
        for (int gg = 0; gg < kGroup; ++gg) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < VEC; ++j) dot = fmaf(qr[gg][j], kr[j], dot);
          sc[gg] = dot;
        }
#pragma unroll
        for (int off = LPS / 2; off > 0; off /= 2) {
#pragma unroll
          for (int gg = 0; gg < kGroup; ++gg)
            sc[gg] += __shfl_xor_sync(0xffffffffu, sc[gg], off);
        }
        if (slot < nt && li == 0) {
#pragma unroll
          for (int gg = 0; gg < kGroup; ++gg)
            p_s[gg * TS + slot] = none_valid ? 0.f : sc[gg] * scale;
        }
      }
      __syncthreads();
      // softmax of the tile by block: warp w takes head w
      for (int gg = warp; gg < gn; gg += kWarps) {
        float mx = kNegInf;
        for (int j = lane; j < nt; j += 32) mx = fmaxf(mx, p_s[gg * TS + j]);
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = m_s[gg], m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int j = lane; j < nt; j += 32) {
          const float p = expf(p_s[gg * TS + j] - m_new);
          sum += p;
          p_s[gg * TS + j] = p;
        }
#pragma unroll
        for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          const float a = expf(m_old - m_new);
          alpha_s[gg] = a;
          l_s[gg] = l_s[gg] * a + sum;
          m_s[gg] = m_new;
        }
      }
      cp_async_wait<0>();  // V has landed
      __syncthreads();
    }
    if constexpr (kTensor) {
      // O += P V: warp w takes the 8-dim columns w, w + 8, ...
#pragma unroll
      for (int e = 0; e < NPW; ++e) {
        const int nb = warp + e * kWarps;
        if (nb * 8 >= D) break;
        // two accumulators, the even and the odd 16-slot steps, then summed
        float odd[4] = {0.f, 0.f, 0.f, 0.f};
        oacc[e][0] *= alpha;
        oacc[e][1] *= alpha;
        auto step = [&](int k0, float (&d)[4]) {
          uint32_t pa[4], vf[2];
          ldsm(pa, pb_s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * SM::kLdp + k0 +
                       8 * (lane >> 4));
          // V stored (slot, d): the col operand, transposed
          ldsm2_t(vf, v_s + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * nb);
          mma(d, pa, vf[0], vf[1]);
        };
        for (int k0 = 0; k0 < ntp; k0 += 32) {
          step(k0, oacc[e]);
          if (k0 + 16 < ntp) step(k0 + 16, odd);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) oacc[e][r] += odd[r];
      }
    } else {
      // each thread two adjacent dims of one head, slots in order
#pragma unroll
      for (int e = 0; e < PPT; ++e) {
        const int pair = threadIdx.x + e * kThreads;
        const int gg = pair / (D / 2), d = 2 * (pair % (D / 2));
        if (pair >= PAIRS || gg >= gn) continue;
        const float alpha = alpha_s[gg];
        float a0 = acc[e][0] * alpha, a1 = acc[e][1] * alpha;
        for (int j = 0; j < nt; ++j) {
          const float pr = p_s[gg * TS + j];
          const float2 vv = load2(v_s + j * LD + d);
          a0 = fmaf(pr, vv.x, a0);
          a1 = fmaf(pr, vv.y, a1);
        }
        acc[e][0] = a0;
        acc[e][1] = a1;
      }
    }
    if (t0 + TS < s_hi) __syncthreads();  // the next tile overwrites the shared tiles
  }

  // every CTA has started and set up its mbarrier. The output's gn x D
  // elements are shared out over the ranks in slices of `slice`; each CTA
  // sends each rank that rank's slice of its partial, with its (m, l) of
  // every head, by st.async (its own by plain stores), then waits for the
  // other ranks' bytes and merges its slice in rank order.
  cluster_wait();
  const int slice = ((gn * D + nsplit - 1) / nsplit + 1) & ~1;  // even: whole pairs
  float* slot_acc = part_acc + rank * kGroup * D;
  float* slot_m = part_m + rank * kGroup;
  float* slot_l = part_l + rank * kGroup;
  auto put2 = [&](int el, float a0, float a1) {
    const int dst = el / slice;
    if (dst == rank) {
      *reinterpret_cast<float2*>(slot_acc + el) = make_float2(a0, a1);
    } else {
      st_async(mapa(smem_u32(slot_acc + el), dst), a0, a1, mapa(smem_u32(bar), dst));
    }
  };
  if constexpr (kTensor) {
#pragma unroll
    for (int e = 0; e < NPW; ++e) {
      const int nb = warp + e * kWarps;
      if (nb * 8 < D && g < gn) put2(g * D + 8 * nb + 2 * t4, oacc[e][0], oacc[e][1]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < PPT; ++e) {
      const int pair = threadIdx.x + e * kThreads;
      if (pair < PAIRS && pair / (D / 2) < gn) put2(2 * pair, acc[e][0], acc[e][1]);
    }
  }
  if (threadIdx.x < gn * nsplit) {  // (m, l) of head gg to rank dst
    const int gg = threadIdx.x % gn, dst = threadIdx.x / gn;
    if (dst == rank) {
      slot_m[gg] = m_s[gg];
      slot_l[gg] = l_s[gg];
    } else {
      const uint32_t rbar = mapa(smem_u32(bar), dst);
      st_async(mapa(smem_u32(slot_m + gg), dst), m_s[gg], rbar);
      st_async(mapa(smem_u32(slot_l + gg), dst), l_s[gg], rbar);
    }
  }
  const int lo = rank * slice, hi = min(lo + slice, gn * D);  // this rank's slice
  if (threadIdx.x == 0)  // from each other rank: its slice and gn (m, l)
    mbar_arrive_expect_tx(bar, (nsplit - 1) * (max(hi - lo, 0) + 2 * gn) * 4);
  mbar_wait(bar, 0);
  __syncthreads();  // this CTA's own part
  // per head the common max, the sum of l and each rank's scale, in rank
  // order; then the elements of the slice
  if (threadIdx.x < gn) {
    const int gg = threadIdx.x;
    float mx = kNegInf;
    for (int r = 0; r < nsplit; ++r) mx = fmaxf(mx, part_m[r * kGroup + gg]);
    float lsum = 0.f;
    for (int r = 0; r < nsplit; ++r) {
      const float c = expf(part_m[r * kGroup + gg] - mx);
      lsum += part_l[r * kGroup + gg] * c;
      part_m[r * kGroup + gg] = c;
    }
    l_s[gg] = fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  for (int el = lo + threadIdx.x; el < hi; el += kThreads) {
    const int gg = el / D;
    float a = 0.f;
    for (int r = 0; r < nsplit; ++r)
      a += part_acc[r * kGroup * D + el] * part_m[r * kGroup + gg];
    const long long row = (static_cast<long long>(b) * Hk + h) * G + g0 + gg;
    store(out + row * D + el % D, a / l_s[gg]);
  }
}

// Raises `kernel`'s dynamic shared memory cap to `bytes` on the current
// device once (a bit a device in `done`).
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* vlen,
                   int vlen_stride, void* out, int B, int Hk, int G, int L,
                   int nsplit, int split, const Strides& st, float scale,
                   cudaStream_t stream) {
  // bf16 up to D = 64: 4 warps (the tile's 16 score and 8 output column
  // blocks make 4 and 2 independent mma chains a warp); else 8
  constexpr int kThreads = sizeof(T) == 2 && D <= 64 ? 128 : 256;
  constexpr auto kernel = split_decode_kernel<T, D, kThreads>;
  static unsigned long long done = 0;
  constexpr int smem = Smem<T, D>::bytes;
  cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, B * Hk, (G + kGroup - 1) / kGroup);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q),
                            static_cast<const T*>(k), static_cast<const T*>(v), vlen,
                            vlen_stride, static_cast<T*>(out), Hk, G, L, split, st,
                            scale);
}

template <typename T>
cudaError_t launch_t(int D, const void* q, const void* k, const void* v,
                     const int* vlen, int vlen_stride, void* out, int B, int Hk,
                     int G, int L, int nsplit, int split, const Strides& st,
                     float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, vlen, vlen_stride, out, B, Hk, G, L, nsplit, split, st, scale, stream);
    case 64: return launch<T, 64>(q, k, v, vlen, vlen_stride, out, B, Hk, G, L, nsplit, split, st, scale, stream);
    case 128: return launch<T, 128>(q, k, v, vlen, vlen_stride, out, B, Hk, G, L, nsplit, split, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hk, G, D), k/v (B, Hk, L, D), the last dim contiguous; vlen: B
// int32 values `vlen_stride` apart (0 for one shared value); out
// (B, Hk, G, D) contiguous. `params` holds 18 int64: B, Hk, G, L, D, nsplit
// (1 .. 8), split (nsplit * split >= L), vlen_stride, dtype (0 f32, 1 bf16)
// and the element strides q_b, q_h, q_g, k_b, k_h, k_l, v_b, v_h, v_l (one
// buffer: a decode step makes this call once a layer, and each argument
// ctypes converts costs host time).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* vlen, void* out, const long long* params,
                                   float scale, void* stream) {
  const int B = static_cast<int>(params[0]), Hk = static_cast<int>(params[1]);
  const int G = static_cast<int>(params[2]), L = static_cast<int>(params[3]);
  const int D = static_cast<int>(params[4]), nsplit = static_cast<int>(params[5]);
  const int split = static_cast<int>(params[6]);
  const int vlen_stride = static_cast<int>(params[7]), dtype = static_cast<int>(params[8]);
  if (nsplit < 1 || nsplit > kMaxSplits || split < 1 ||
      static_cast<long long>(nsplit) * split < L)
    return cudaErrorInvalidValue;
  const Strides st{params[9],  params[10], params[11], params[12], params[13],
                   params[14], params[15], params[16], params[17]};
  const int* vl = static_cast<const int*>(vlen);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(D, q, k, v, vl, vlen_stride, out, B, Hk, G, L, nsplit, split, st, scale, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(D, q, k, v, vl, vlen_stride, out, B, Hk, G, L, nsplit, split, st, scale, s);
  return cudaErrorInvalidValue;
}
