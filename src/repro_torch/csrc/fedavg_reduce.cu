// fedavg_reduce: the weighted cohort sum out[n] = sum_c w[c] * P[c, n]
// (Hopper, sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fedavg_reduce.py::fedavg_reduce
// (_fedavg_kernel). Same function: a (C, N) f32 stack of flattened cohort
// params contracted against (C,) f32 weights, accumulated in f32. Every
// slot counts, weight 0 included, as in the Pallas dot: a padded slot adds
// exactly 0 and a NaN in any slot propagates.
//
// Design. The TPU kernel streams (C, 16384) tiles through VMEM and contracts
// each on the MXU. Here each thread owns consecutive columns: four of them
// with 16-byte loads when N is a multiple of 4 and both pointers are 16-byte
// aligned, else one with scalar loads. It walks c = 0..C-1 in order with an
// f32 FMA, so every output is a fixed-order sum: launches are bitwise
// repeatable (no split over C, no atomics). The weights are staged in shared
// memory, CHUNK at a time, so any C works.
//
// Bound. The function reads C*N*4 + C*4 bytes and writes N*4, and does 2*C*N
// flops: at 0.5 flop per byte it is bound by memory, (C*N + C + N)*4 bytes
// over 3.35 TB/s. At the sync main path's largest leaf (C = 30, N = 1 605 632)
// that is 199 MB, about 59 us. Consecutive threads read consecutive 16-byte
// words of a row, so each row read is coalesced; there is no reuse to keep
// on chip beyond the weights.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 1024;  // weights staged per pass over c: 4 KiB

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
fedavg_reduce_kernel(const float* __restrict__ P, const float* __restrict__ w,
                     int C, int64_t N, float* __restrict__ out) {
  __shared__ float sw[CHUNK];
  constexpr int COLS = VEC ? 4 : 1;
  const int64_t col = (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) * COLS;
  const bool live = col < N;
  float acc[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) acc[j] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += CHUNK) {
    const int cn = min(CHUNK, C - c0);
    __syncthreads();  // the previous chunk's weights are no longer read
    for (int j = threadIdx.x; j < cn; j += THREADS) sw[j] = w[c0 + j];
    __syncthreads();
    if (live) {
      const float* row = P + static_cast<int64_t>(c0) * N + col;
#pragma unroll 4
      for (int c = 0; c < cn; ++c, row += N) {
        const float wc = sw[c];
        if constexpr (VEC) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(row));
          acc[0] = fmaf(wc, v.x, acc[0]);
          acc[1] = fmaf(wc, v.y, acc[1]);
          acc[2] = fmaf(wc, v.z, acc[2]);
          acc[3] = fmaf(wc, v.w, acc[3]);
        } else {
          acc[0] = fmaf(wc, __ldg(row), acc[0]);
        }
      }
    }
  }
  if (!live) return;
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(out + col) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    out[col] = acc[0];
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success). The caller
// allocates `out` (N floats) and keeps P (C*N floats, row-major) and w alive
// until the stream reaches the kernel. N = 0 launches nothing.
int fedavg_reduce_launch(const float* P, const float* w, int C, long long N,
                         float* out, cudaStream_t stream) {
  if (N <= 0) return 0;
  const bool vec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(P) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int64_t cols = static_cast<int64_t>(THREADS) * (vec ? 4 : 1);
  const unsigned blocks = static_cast<unsigned>((N + cols - 1) / cols);
  if (vec) {
    fedavg_reduce_kernel<true><<<blocks, THREADS, 0, stream>>>(P, w, C, N, out);
  } else {
    fedavg_reduce_kernel<false><<<blocks, THREADS, 0, stream>>>(P, w, C, N, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
