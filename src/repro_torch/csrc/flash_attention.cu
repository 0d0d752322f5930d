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
// Design (simple and right first; wgmma/TMA and pipelined loads are later
// work):
//  - one CTA per (b, kv head, tile of 64 rows). The rows pack every query
//    head of the kv head: row r is query position r / G of head r % G, so
//    a tile covers 64 / G consecutive positions of all G heads, and each
//    K/V tile is read once for all G heads (the GQA saving the Pallas
//    kernel is built around). Any G works.
//  - the CTA walks 64-key tiles in order, K and V staged in shared memory;
//    tiles wholly above the diagonal, or wholly before the sliding window
//    or the chunk of every row in the tile, are skipped: they would add
//    exp(-1e30 - m) = 0, or be wiped by alpha = exp(-1e30 - m) once a
//    valid key arrives, exactly as in the reference.
//  - bf16: mma.sync m16n8k16 tensor-core tiles (f32 accumulate), four
//    warps of 16 rows each; S = Q K^T stays in registers, and its
//    accumulator fragments become P's A fragments for O += P V.
//  - f32: plain FMA, 256 threads, each thread a 4 x 4 block of scores and
//    a 4 x D/16 block of the output (the f32 tolerance of 2e-5 rules out
//    TF32 tensor-core tiles).
// Bound on the H100: 4 * B * Hk * G * D * (causal key-query pairs) flops
// against reading q, k, v and writing o once; at the serving prefill
// shape it is bound by operations.
//
// Plain C interface for ctypes: flash_attention_launch returns the CUDA
// error of the launch (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBM = 64;  // rows (query position x head) per CTA
constexpr int kBN = 64;  // keys per tile

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
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ float round_to(float p, const float*) { return p; }
__device__ __forceinline__ float round_to(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

// ---------------------------------------------------------------------------
// FMA kernel: 16 x 16 threads; thread (ty, tx) owns rows 4ty..4ty+3, keys
// tx + 16j (j < 4) of a tile and output dims tx + 16j (j < D / 16).
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(256)
fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, Geom gm) {
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
  }
}

// ---------------------------------------------------------------------------
// mma.sync kernel (bf16): four warps, warp w owns rows 16w..16w+15 of the
// tile. Fragment layouts of mma.m16n8k16 (PTX ISA), lane = 4 * gid + tid:
//   A (16 x 16): a0 (gid, 2tid..+1) a1 (gid+8, 2tid..) a2 (gid, 8+2tid..)
//                a3 (gid+8, 8+2tid..)
//   B (16 x 8):  b0 (k 2tid..+1, n gid) b1 (k 8+2tid..+1, n gid)
//   C (16 x 8):  c0,c1 (gid, 2tid..+1) c2,c3 (gid+8, 2tid..+1)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(128)
mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
           Geom gm) {
  constexpr int P = D + 8;   // padded row in bf16 (16 bytes): conflict-free fragments
  constexpr int KS = D / 16;  // k-steps of Q K^T
  constexpr int NT = kBN / 8;  // n-tiles of S
  constexpr int DT = D / 8;    // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBM][P]
  __nv_bfloat16* Ks = Qs + kBM * P;                                // [kBN][P]
  __nv_bfloat16* Vs = Ks + kBN * P;                                // [kBN][P]

  const int G = gm.G, S = gm.S;
  const int bh = blockIdx.y, b = bh / gm.Hk, h = bh % gm.Hk;
  const int r0 = blockIdx.x * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tid = lane % 4;
  const __nv_bfloat16* qb = q + b * gm.q_b + h * gm.q_h;
  const __nv_bfloat16* kb = k + b * gm.k_b + h * gm.k_h;
  const __nv_bfloat16* vb = v + b * gm.v_b + h * gm.v_h;

  // stage Q (8 bf16 = 16 bytes a thread a step)
  for (int i = threadIdx.x; i < kBM * D / 8; i += 128) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8, row = r0 + r, qp = row / G;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (qp < S) val = *reinterpret_cast<const uint4*>(qb + (row % G) * gm.q_g + qp * gm.q_s + c);
    *reinterpret_cast<uint4*>(Qs + r * P + c) = val;
  }
  __syncthreads();
  const int wr = warp * 16;  // this warp's first row in the tile
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const __nv_bfloat16* base = Qs + ks * 16 + 2 * tid;
    qa[ks][0] = *reinterpret_cast<const uint32_t*>(base + (wr + gid) * P);
    qa[ks][1] = *reinterpret_cast<const uint32_t*>(base + (wr + gid + 8) * P);
    qa[ks][2] = *reinterpret_cast<const uint32_t*>(base + (wr + gid) * P + 8);
    qa[ks][3] = *reinterpret_cast<const uint32_t*>(base + (wr + gid + 8) * P + 8);
  }
  const int qp_lo = (r0 + wr + gid) / G, qp_hi = (r0 + wr + gid + 8) / G;

  const int qmin = r0 / G;
  const int qmax = min((r0 + kBM - 1) / G, S - 1);
  const int kt0 = first_key(qmin, gm.kind, gm.window) / kBN * kBN;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float oc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) oc[n][0] = oc[n][1] = oc[n][2] = oc[n][3] = 0.f;

  for (int kt = kt0; kt <= qmax; kt += kBN) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBN * D / 8; i += 128) {
      const int kk = i / (D / 8), c = (i % (D / 8)) * 8, kp = kt + kk;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (kp < S) {
        kv = *reinterpret_cast<const uint4*>(kb + kp * gm.k_s + c);
        vv = *reinterpret_cast<const uint4*>(vb + kp * gm.v_s + c);
      }
      *reinterpret_cast<uint4*>(Ks + kk * P + c) = kv;
      *reinterpret_cast<uint4*>(Vs + kk * P + c) = vv;
    }
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys
    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* kr = Ks + (n * 8 + gid) * P + ks * 16 + 2 * tid;
        mma16816(sc[n], qa[ks], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    // mask, scale, online softmax (row gid: c0, c1; row gid + 8: c2, c3)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kt + n * 8 + 2 * tid + (e & 1);
        const int qp = e < 2 ? qp_lo : qp_hi;
        const bool ok = kp < S && allowed(qp, kp, gm.kind, gm.window);
        sc[n][e] = ok ? sc[n][e] * gm.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      alpha[r] = __expf(m[r] - mn);
      m[r] = mn;
    }
    float sum[2] = {0.f, 0.f};
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float p0 = __expf(sc[n][0] - m[0]), p1 = __expf(sc[n][1] - m[0]);
      const float p2 = __expf(sc[n][2] - m[1]), p3 = __expf(sc[n][3] - m[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      // A fragments of P for k-step n / 2: n even -> a0, a1; n odd -> a2, a3
      pa[n / 2][(n & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      oc[n][0] *= alpha[0];
      oc[n][1] *= alpha[0];
      oc[n][2] *= alpha[1];
      oc[n][3] *= alpha[1];
    }
    // O += P V: B fragment b0 = V[keys 16ks + 2tid, +1][dim 8n + gid]
#pragma unroll
    for (int ks = 0; ks < kBN / 16; ++ks) {
      const __nv_bfloat16* vr = Vs + (ks * 16 + 2 * tid) * P + gid;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const __nv_bfloat16* vc = vr + n * 8;
        const uint32_t b0 = pack_raw(vc[0], vc[P]);
        const uint32_t b1 = pack_raw(vc[8 * P], vc[9 * P]);
        mma16816(oc[n], pa[ks], b0, b1);
      }
    }
  }
  __nv_bfloat16* ob = o + b * gm.o_b + h * gm.o_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + wr + gid + 8 * r, qp = row / G;
    if (qp >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = ob + (row % G) * gm.o_g + qp * gm.o_s;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const uint32_t packed = pack_bf16(oc[n][2 * r] * inv, oc[n][2 * r + 1] * inv);
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * tid) = packed;
    }
  }
}

template <typename T, int D>
cudaError_t launch_fma(dim3 grid, cudaStream_t stream, const void* q, const void* k,
                       const void* v, void* o, const Geom& gm) {
  const size_t smem = (size_t)(3 * 64 * (D + 1) + 64 * (kBN + 1)) * sizeof(float);
  auto kern = fma_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, 256, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                    static_cast<const T*>(v), static_cast<T*>(o), gm);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(dim3 grid, cudaStream_t stream, const void* q, const void* k,
                       const void* v, void* o, const Geom& gm) {
  const size_t smem = (size_t)3 * 64 * (D + 8) * sizeof(__nv_bfloat16);
  auto kern = mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, 128, smem, stream>>>(static_cast<const __nv_bfloat16*>(q),
                                    static_cast<const __nv_bfloat16*>(k),
                                    static_cast<const __nv_bfloat16*>(v),
                                    static_cast<__nv_bfloat16*>(o), gm);
  return cudaGetLastError();
}

}  // namespace

// q (B, Hk, G, S, D), k/v (B, Hk, S, D), o (B, Hk, G, S, D), all through
// strides in elements (the last dim contiguous): st = {q_b, q_h, q_g, q_s,
// k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_g, o_s}. kind: 0 full,
// 1 sliding, 2 chunked. dtype: 0 f32 (FMA kernel), 1 bf16 (mma.sync kernel).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int Hk, int G, int S, int D,
                                      const long long* st, float scale, int kind,
                                      int window, int dtype, void* stream) {
  Geom gm;
  gm.Hk = Hk; gm.G = G; gm.S = S; gm.kind = kind; gm.window = window;
  gm.q_b = st[0]; gm.q_h = st[1]; gm.q_g = st[2]; gm.q_s = st[3];
  gm.k_b = st[4]; gm.k_h = st[5]; gm.k_s = st[6];
  gm.v_b = st[7]; gm.v_h = st[8]; gm.v_s = st[9];
  gm.o_b = st[10]; gm.o_h = st[11]; gm.o_g = st[12]; gm.o_s = st[13];
  gm.scale = scale;
  const long long rows = (long long)G * S;
  dim3 grid((unsigned)((rows + kBM - 1) / kBM), (unsigned)(B * Hk));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (D) {
      case 32: return launch_mma<32>(grid, s, q, k, v, o, gm);
      case 64: return launch_mma<64>(grid, s, q, k, v, o, gm);
      case 128: return launch_mma<128>(grid, s, q, k, v, o, gm);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 0) {
    switch (D) {
      case 32: return launch_fma<float, 32>(grid, s, q, k, v, o, gm);
      case 64: return launch_fma<float, 64>(grid, s, q, k, v, o, gm);
      case 128: return launch_fma<float, 128>(grid, s, q, k, v, o, gm);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}
