// K5 on Hopper: one query token per (batch, kv head), with its G grouped
// query heads, against a KV cache; slots at or past valid_len are masked.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::flash_decode
// (_decode_kernel). What it computes is the reference's: f32 scores times
// `scale`, an online softmax with the finite -1e30 sentinel, p rounded to
// the value dtype before the P.V product, l floored at 1e-30, the output in
// q's dtype. valid_len is a 0-d or (B,) int32 tensor read on the device.
//
// Design (simple and right first; a split over L is later work):
//  - one CTA of 8 warps per (b, kv head, group of up to 8 query heads);
//  - the cache is read in the caller's layout through strides, so the
//    model's (B, L, Hk, D) ring cache needs no transpose; a lane loads 16
//    bytes of a slot's K or V row, D / (16 / sizeof(T)) lanes cover a row,
//    so a warp takes 32 * 16 / (D * sizeof(T)) slots a step;
//  - only the valid slots are walked (the ragged tail is never read, no
//    padding copy); each slot group keeps its own online-softmax state in
//    registers, merged across the warp by shuffles and across warps
//    through shared memory at the end;
//  - no atomics: launches repeat bitwise.
// Bound on the H100: it must read the valid part of K and V once, so it is
// memory-bound (and, at decode sizes, launch-bound).
//
// Plain C interface for ctypes: flash_decode_launch returns the CUDA error
// of the launch (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;

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

// p rounded to the value dtype, as the reference's p.astype(v.dtype)
__device__ __forceinline__ float round_to(float p, const float*) { return p; }
__device__ __forceinline__ float round_to(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D, int GC>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ vlen,
              int vlen_stride, T* __restrict__ out, int Hk, int G, int L,
              long long qs_b, long long qs_h, long long qs_g,
              long long ks_b, long long ks_h, long long ks_l,
              long long vs_b, long long vs_h, long long vs_l,
              float scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPS = D / VEC;   // lanes per slot
  constexpr int SPW = 32 / LPS;  // slots per warp step
  static_assert(LPS >= 1 && LPS <= 32 && 32 % LPS == 0, "unsupported D");
  __shared__ float sm_acc[kWarps][GC][D];
  __shared__ float sm_m[kWarps][GC];
  __shared__ float sm_l[kWarps][GC];

  const int b = blockIdx.x / Hk, h = blockIdx.x % Hk;
  const int g0 = blockIdx.y * GC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sg = lane / LPS, li = lane % LPS;
  const int d0 = li * VEC;

  int n = vlen[(long long)b * vlen_stride];
  // no valid slot: every score is the sentinel, and the plain softmax is
  // uniform over all L slots; walk them all with equal scores
  const bool none_valid = n <= 0;
  n = none_valid ? L : min(n, L);

  float qr[GC][VEC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g0 + g < G) {
      load16(q + b * qs_b + h * qs_h + (g0 + g) * qs_g + d0, qr[g]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) qr[g][j] = 0.f;
    }
  }
  float m[GC], l[GC], acc[GC][VEC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[g][j] = 0.f;
  }

  const T* kb = k + b * ks_b + h * ks_h + d0;
  const T* vb = v + b * vs_b + h * vs_h + d0;
  for (int base = warp * SPW; base < n; base += kWarps * SPW) {
    const int slot = base + sg;
    const bool ok = slot < n;
    float kr[VEC], vr[VEC];
    if (ok) {
      load16(kb + slot * ks_l, kr);
      load16(vb + slot * vs_l, vr);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) kr[j] = vr[j] = 0.f;
    }
    float s[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) dot = fmaf(qr[g][j], kr[j], dot);
      s[g] = dot;
    }
#pragma unroll
    for (int off = LPS / 2; off > 0; off /= 2) {
#pragma unroll
      for (int g = 0; g < GC; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
    }
    if (ok) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float sc = none_valid ? 0.f : s[g] * scale;
        const float mn = fmaxf(m[g], sc);
        const float alpha = expf(m[g] - mn);
        const float p = expf(sc - mn);
        l[g] = l[g] * alpha + p;
        const float pr = round_to(p, k);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[g][j] = fmaf(pr, vr[j], acc[g][j] * alpha);
        m[g] = mn;
      }
    }
  }

  // merge the warp's slot groups (lanes li of every group hold the same dims)
#pragma unroll
  for (int off = LPS; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn), c = expf(mo - mn);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][j], off);
        acc[g][j] = acc[g][j] * a + ao * c;
      }
      m[g] = mn;
    }
  }
  if (sg == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) sm_acc[warp][g][d0 + j] = acc[g][j];
      if (li == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  // merge the warps in a fixed order and write the output
  for (int t = threadIdx.x; t < GC * D; t += blockDim.x) {
    const int g = t / D, d = t % D;
    if (g0 + g >= G) continue;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * c;
      a += sm_acc[w][g][d] * c;
    }
    const long long row = ((long long)b * Hk + h) * G + g0 + g;
    store(out + row * D + d, a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const int* vlen,
                     int vlen_stride, void* out, int B, int Hk, int G, int L,
                     const long long* st, float scale, cudaStream_t stream) {
  const int gc = G >= 8 ? 8 : G >= 4 ? 4 : G >= 2 ? 2 : 1;
  dim3 grid(B * Hk, (G + gc - 1) / gc);
#define K5_ARGS                                                                \
  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), \
      vlen, vlen_stride, static_cast<T*>(out), Hk, G, L, st[0], st[1], st[2],   \
      st[3], st[4], st[5], st[6], st[7], st[8], scale
  switch (gc) {
    case 8: decode_kernel<T, D, 8><<<grid, kWarps * 32, 0, stream>>>(K5_ARGS); break;
    case 4: decode_kernel<T, D, 4><<<grid, kWarps * 32, 0, stream>>>(K5_ARGS); break;
    case 2: decode_kernel<T, D, 2><<<grid, kWarps * 32, 0, stream>>>(K5_ARGS); break;
    default: decode_kernel<T, D, 1><<<grid, kWarps * 32, 0, stream>>>(K5_ARGS); break;
  }
#undef K5_ARGS
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int D, const void* q, const void* k, const void* v,
                     const int* vlen, int vlen_stride, void* out, int B, int Hk,
                     int G, int L, const long long* st, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 32: return launch_d<T, 32>(q, k, v, vlen, vlen_stride, out, B, Hk, G, L, st, scale, stream);
    case 64: return launch_d<T, 64>(q, k, v, vlen, vlen_stride, out, B, Hk, G, L, st, scale, stream);
    case 128: return launch_d<T, 128>(q, k, v, vlen, vlen_stride, out, B, Hk, G, L, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hk, G, D), k/v (B, Hk, L, D) through the strides
// st = {q_b, q_h, q_g, k_b, k_h, k_l, v_b, v_h, v_l} (elements; the last
// dim is contiguous); vlen: B int32 values `vlen_stride` apart (0 for one
// shared value); out (B, Hk, G, D) contiguous. dtype: 0 f32, 1 bf16.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* vlen, int vlen_stride, void* out,
                                   int B, int Hk, int G, int L, int D,
                                   const long long* strides, float scale,
                                   int dtype, void* stream) {
  const int* vl = static_cast<const int*>(vlen);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(D, q, k, v, vl, vlen_stride, out, B, Hk, G, L, strides, scale, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(D, q, k, v, vl, vlen_stride, out, B, Hk, G, L, strides, scale, s);
  return cudaErrorInvalidValue;
}
