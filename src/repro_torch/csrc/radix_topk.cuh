// radix_topk: the k smallest (or, DESC, largest) of n f32 values with their
// indices, ties to the lower index, for any 1 <= k <= n < 2^31 in one launch
// (Hopper, sm_90a). Shared by event_topk.cu (K2, ascending, sorted) and
// aoi_topk.cu (K3, descending, sorted or in index order).
//
// The design is a radix select, as in the AIR Top-K paper (SC'23) and the
// radix select of PyTorch's own topk:
//  1. Key. Each value becomes its 32-bit order-preserving image, complemented
//     for DESC; -0.0 is made +0.0 and every NaN one quiet NaN first, so the
//     order is that of a stable sort. The index is the element's position
//     and is not stored beside it.
//  2. Select. Four most-significant-digit passes of 8 bits find the image T
//     of the k-th key: each pass histograms the digit among the elements
//     whose higher digits equal the prefix found so far (shared-memory
//     integer atomics: exact and order-free), and a scan picks the bucket
//     that holds the k-th. After them, kr elements equal to T are still to
//     take. Once a CTA's elements still in the running fit CAND, the pass
//     that counts them also lists their images, and the later passes read
//     only that list.
//  3. Gather. Every element with image < T, then the first kr equal to T, in
//     index order: each thread walks a contiguous run of its window, and its
//     place comes from a block scan of the runs' counts and a CTA-order
//     prefix over the CTAs. That is the unsorted result, in index order.
//  4. Order. For a sorted result, four stable least-significant-digit passes
//     sort the k selected by image, so equal values keep index order. A tile
//     of 1024 elements is ranked by eight ballots a warp (warp_peers) and a
//     scan of the (digit, warp) counts. k <= 1024 is instead one bitonic sort
//     of (image, index) keys in registers, shuffles and shared memory (the
//     keys are distinct, so its order is the stable sort's); a larger k goes
//     through the scratch, on one CTA up to
//     SORT_ONE_CTA_K (kernels/radix_topk.py) and on every CTA above it, with
//     the per-CTA digit rows merged in CTA order.
//  5. Launch. n <= WINDOW: one CTA of 1024 threads holds all n values in
//     shared memory, one launch, no grid barrier. Larger n: a persistent grid
//     of at most one CTA per SM (cooperative launch, so every CTA is
//     resident); each CTA holds its chunk in shared memory (in windows of
//     WINDOW values, reloaded each pass, where the chunk is larger) and the
//     passes are separated by grid barriers. At a barrier the last CTA to
//     arrive merges the per-CTA rows before it releases the others, so a
//     pass costs one barrier. The barrier's count returns to 0 and its
//     generation word only grows, so no call needs a memset. The grid, the
//     shared memory and the scratch follow from (n, k, sorted) and the SM
//     count alone (kernels/radix_topk.py::plan); nothing syncs with the host.
//
// out_v[j] is the input value at out_i[j], bit for bit (-0.0 stays -0.0).
// Bound: a call reads n*4 bytes and writes k*12; at n = 16384 that is
// 64 KiB, about 20 ns of HBM time, so a call is bound by its launch and the
// latency of its passes, not by bytes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace radix_topk {
namespace {  // internal linkage: each library keeps its own kernel and state

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int RADIX = 256;              // 8-bit digits
constexpr int DIGITS = 4;               // of a 32-bit image
constexpr int WINDOW = 32768;           // values a CTA holds in shared memory
constexpr int CNT_STRIDE = WARPS + 1;   // per-digit row of warp counts, padded
constexpr int STATE_WORDS = 4;          // a pass's prefix, kr and bucket count
constexpr int LOAD_BATCH = 16;          // global loads in flight per thread
constexpr int CAND = 2048;              // candidate images a CTA lists

// Shared-memory slot of window position i: one spare word every 32, so the
// contiguous runs of a warp's lanes fall in different banks.
__device__ __forceinline__ int slot(int i) { return i + (i >> 5); }

// Shared-memory words of a window's slots, rounded up to 16 bytes.
__host__ __device__ constexpr int window_slots(int window) {
  return (window + window / 32 + 4) & ~3;
}

// Dynamic shared memory: the window and the candidate list; sorted, two
// (digit, warp) count tables and THREADS (image, index) pairs.
__host__ __device__ constexpr size_t smem_bytes(int window, bool sorted) {
  return 4 * (static_cast<size_t>(window_slots(window)) + CAND +
              (sorted ? 2 * RADIX * CNT_STRIDE + 2 * THREADS : 0));
}

// The order-preserving image of an f32's bits (ascending; complemented for DESC).
template <bool DESC>
__device__ __forceinline__ uint32_t image(uint32_t bits) {
  const uint32_t mag = bits & 0x7fffffffu;
  if (mag == 0u) bits = 0u;                        // -0.0 ties with +0.0
  else if (mag > 0x7f800000u) bits = 0x7fc00000u;  // every NaN is one NaN
  const uint32_t b = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return DESC ? ~b : b;
}

struct Params {
  const float* values;
  int n, k, sorted;
  int chunk;      // values per CTA
  int window;     // values held in shared memory at once, <= WINDOW
  int windows;    // windows per chunk
  int sort_ctas;  // CTAs that run the sort passes: 1 or all
  int seg;        // selected elements per sorting CTA
  uint32_t* rows;   // grid: RADIX words per CTA
  uint32_t* state;  // grid: STATE_WORDS
  uint32_t* bar;    // grid: {arrived, generation}, persistent, arrived 0 at rest
  uint32_t* keys[2];  // sorted: images of the selected, ping-pong
  uint32_t* idx[2];   // sorted: their indices
  float* out_v;
  int64_t* out_i;
};

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Exclusive scan of one word per thread over the CTA; *total gets the sum.
// Every thread of the CTA calls it.
__device__ uint32_t block_scan(uint32_t v, uint32_t* total) {
  __shared__ uint32_t s_warp[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(~0u, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(~0u, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  const uint32_t before = warp ? s_warp[warp - 1] : 0u;
  *total = s_warp[WARPS - 1];
  __syncthreads();  // s_warp is free for the next call
  return before + x - v;
}

// The lanes of a warp whose 8-bit digit equals this lane's, among `live`
// (eight ballots; every lane of the warp calls it).
__device__ __forceinline__ uint32_t warp_peers(uint32_t live, uint32_t digit) {
  uint32_t peers = live;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const uint32_t bit = (digit >> b) & 1u;
    const uint32_t m = __ballot_sync(~0u, bit);
    peers &= bit ? m : ~m;
  }
  return peers;
}

// The images of window [0, m) of src into s_win, LOAD_BATCH loads in flight
// per thread; with HIST, the top digit of each counted into hist on the way.
template <bool DESC, bool HIST>
__device__ __forceinline__ void load_window(uint32_t* s_win, const float* src, int m,
                                            uint32_t* hist) {
  for (int i0 = 0; i0 < m; i0 += THREADS * LOAD_BATCH) {
    uint32_t r[LOAD_BATCH];
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      const int i = i0 + u * THREADS + threadIdx.x;
      r[u] = i < m ? __float_as_uint(__ldg(src + i)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      const int i = i0 + u * THREADS + threadIdx.x;
      if (i < m) {
        const uint32_t img = image<DESC>(r[u]);
        s_win[slot(i)] = img;
        if (HIST) atomicAdd(&hist[img >> 24], 1u);
      }
    }
  }
  __syncthreads();
}

// This thread's run of window [0, m): at most 32 positions (m <= WINDOW),
// their images below T in *less and equal to T in *equal, bit j for r0 + j.
__device__ __forceinline__ int run_masks(const uint32_t* s_win, int m, uint32_t T,
                                         uint32_t* less, uint32_t* equal) {
  const int e = (m + THREADS - 1) / THREADS;
  const int r0 = min(m, static_cast<int>(threadIdx.x) * e), r1 = min(m, r0 + e);
  uint32_t l = 0u, q = 0u;
#pragma unroll 8
  for (int j = 0; j < r1 - r0; ++j) {
    const uint32_t img = s_win[slot(r0 + j)];
    l |= static_cast<uint32_t>(img < T) << j;
    q |= static_cast<uint32_t>(img == T) << j;
  }
  *less = l;
  *equal = q;
  return r0;
}

// Barrier of the first `ctas` CTAs at which the last to arrive runs merge()
// (all its threads) before it releases the others. Global writes made before
// it by any of them are visible after it to all of them through __ldcg.
template <class Merge>
__device__ void exchange(uint32_t* bar, int ctas, Merge merge) {
  __shared__ uint32_t s_last;
  uint32_t gen = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    gen = ld_acquire(bar + 1);
    __threadfence();
    const uint32_t arrived = atomicAdd(bar, 1u);
    __threadfence();
    s_last = arrived == static_cast<uint32_t>(ctas - 1);
  }
  __syncthreads();
  if (s_last) {
    merge();
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicExch(bar, 0u);
      __threadfence();
      st_release(bar + 1, gen + 1);
    }
  } else if (threadIdx.x == 0) {
    while (ld_acquire(bar + 1) == gen) {
    }
  }
  __syncthreads();
}

// From a complete histogram of the digit at `shift`: the bucket that holds
// the kr-th key (one warp scans the 256 counts). Writes {prefix | bucket <<
// shift, kr - keys below it, keys in it} to s_state.
__device__ void pick_bucket(const uint32_t* hist, uint32_t prefix, uint32_t kr, int shift,
                            uint32_t* s_state) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    uint32_t c[RADIX / 32], sum = 0;
#pragma unroll
    for (int u = 0; u < RADIX / 32; ++u) {
      c[u] = hist[lane * (RADIX / 32) + u];
      sum += c[u];
    }
    uint32_t incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += y;
    }
    uint32_t before = incl - sum;
#pragma unroll
    for (int u = 0; u < RADIX / 32; ++u) {
      if (c[u] != 0u && before < kr && kr <= before + c[u]) {
        s_state[0] = prefix | (static_cast<uint32_t>(lane * (RADIX / 32) + u) << shift);
        s_state[1] = kr - before;
        s_state[2] = c[u];
      }
      before += c[u];
    }
  }
  __syncthreads();
}

// The last CTA of a grid sort pass: rows[c][d] becomes where CTA c puts its
// first element of digit d: the count of all digits below d plus that of d
// in the CTAs before c. Thread (d, part) walks a quarter of the CTAs in
// order; integer sums, so the result is exact.
__device__ void merge_sort_rows(uint32_t* rows, int ctas) {
  const int lane = threadIdx.x & 31;
  const int d = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int per = (ctas + 3) / 4;
  const int c0 = min(ctas, part * per), c1 = min(ctas, c0 + per);
  uint32_t s = 0;
#pragma unroll 8
  for (int c = c0; c < c1; ++c) s += __ldcg(rows + c * RADIX + d);
  uint32_t incl = s;
  uint32_t y = __shfl_up_sync(~0u, incl, 1, 4);
  if (part >= 1) incl += y;
  y = __shfl_up_sync(~0u, incl, 2, 4);
  if (part >= 2) incl += y;
  const uint32_t digit_total = __shfl_sync(~0u, incl, lane | 3);
  uint32_t all;
  uint32_t base = block_scan(part == 0 ? digit_total : 0u, &all);
  base = __shfl_sync(~0u, base, lane & ~3);
  uint32_t run = base + incl - s;
#pragma unroll 8
  for (int c = c0; c < c1; ++c) {
    const uint32_t v = __ldcg(rows + c * RADIX + d);
    rows[c * RADIX + d] = run;
    run += v;
  }
}

// Thread (d, part) of a ranking step: the counts of warps part*8 .. part*8+7
// for digit d in table cnt (RADIX rows of CNT_STRIDE), and their sum.
__device__ __forceinline__ uint32_t warp_counts(const uint32_t* cnt, uint32_t* c8) {
  const int d = threadIdx.x >> 2, part = threadIdx.x & 3;
  uint32_t sum = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    c8[u] = cnt[d * CNT_STRIDE + part * 8 + u];
    sum += c8[u];
  }
  return sum;
}

// ... then replaces them by their exclusive offsets from `run` on, and zeroes
// the same entries of `other`, the table of the next ranking step.
__device__ __forceinline__ void write_offsets(uint32_t* cnt, uint32_t* other, const uint32_t* c8,
                                              uint32_t run) {
  const int d = threadIdx.x >> 2, part = threadIdx.x & 3;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    cnt[d * CNT_STRIDE + part * 8 + u] = run;
    other[d * CNT_STRIDE + part * 8 + u] = 0u;
    run += c8[u];
  }
}

template <bool DESC>
__global__ void __launch_bounds__(THREADS, 1) radix_topk_kernel(const Params P) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_win = smem;                                  // slot(i): images
  uint32_t* s_cand = smem + window_slots(P.window);        // CAND images
  uint32_t* s_cnt = s_cand + CAND;                         // sorted: 2 x RADIX x CNT_STRIDE
  uint32_t* s_sk = s_cnt + 2 * RADIX * CNT_STRIDE;         // sorted: THREADS images
  uint32_t* s_si = s_sk + THREADS;                         // sorted: THREADS indices
  __shared__ uint32_t s_hist[RADIX];
  __shared__ uint32_t s_state[STATE_WORDS];
  __shared__ uint32_t s_ncand;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cta = blockIdx.x, ctas = gridDim.x;
  const bool grid = ctas > 1;
  const int64_t base = static_cast<int64_t>(cta) * P.chunk;
  const int len = static_cast<int>(
      max(static_cast<int64_t>(0), min(static_cast<int64_t>(P.chunk), P.n - base)));
  const bool reload = P.windows > 1;
  const bool small_sort = P.sorted && P.k <= THREADS;  // one element a thread
  // where the gather puts a sorted call's selection: one CTA with a small k
  // keeps it in shared memory
  uint32_t* gk = small_sort && !grid ? s_sk : P.keys[0];
  uint32_t* gi = small_sort && !grid ? s_si : P.idx[0];

  // 2. select: four MSD passes find T, the k-th image, and kr to take at T.
  // Once this CTA's elements still in the running fit CAND, the pass that
  // counts them also lists their images, and the later passes read the list.
  uint32_t prefix = 0u, kr = static_cast<uint32_t>(P.k);
  int ncand = -1;  // images in s_cand, or -1: scan the chunk
  uint32_t own = 0u;  // this CTA's elements live in the coming pass
  for (int p = 0; p < DIGITS; ++p) {
    const int shift = 24 - 8 * p;
    const uint32_t hi = p == 0 ? 0u : (~0u << (shift + 8));
    if (tid < RADIX) s_hist[tid] = 0u;
    if (ncand >= 0) {
      __syncthreads();
      for (int i = tid; i < ncand; i += THREADS) {
        const uint32_t img = s_cand[i];
        if ((img & hi) == prefix) atomicAdd(&s_hist[(img >> shift) & (RADIX - 1)], 1u);
      }
    } else {
      const bool build = p > 0 && own <= CAND;
      if (tid == 0) s_ncand = 0u;
      for (int w = 0; w < P.windows; ++w) {
        const int m = max(0, min(P.window, len - w * P.window));
        const float* src = P.values + base + static_cast<int64_t>(w) * P.window;
        __syncthreads();  // s_hist zeroed, the last window read
        if (p == 0) {
          load_window<DESC, true>(s_win, src, m, s_hist);
          continue;
        }
        if (reload) load_window<DESC, false>(s_win, src, m, nullptr);
#pragma unroll 4
        for (int i0 = 0; i0 < m; i0 += THREADS) {
          const int i = i0 + tid;
          const uint32_t img = i < m ? s_win[slot(i)] : 0u;
          const bool live = i < m && (img & hi) == prefix;
          if (live) atomicAdd(&s_hist[(img >> shift) & (RADIX - 1)], 1u);
          if (build) {  // append, one shared atomic a warp
            const uint32_t ballot = __ballot_sync(~0u, live);
            const int first = ballot != 0u ? __ffs(ballot) - 1 : 0;
            uint32_t at = 0u;
            if (ballot != 0u && lane == first) at = atomicAdd(&s_ncand, __popc(ballot));
            at = __shfl_sync(~0u, at, first);
            if (live) s_cand[at + __popc(ballot & ((1u << lane) - 1u))] = img;
          }
        }
      }
      __syncthreads();
      if (build) ncand = static_cast<int>(s_ncand);
    }
    __syncthreads();
    if (grid) {
      if (tid < RADIX) P.rows[cta * RADIX + tid] = s_hist[tid];
      exchange(P.bar, ctas, [&] {  // the digit totals over all CTAs' rows
        if (tid < RADIX) s_hist[tid] = 0u;
        __syncthreads();
        const int words = ctas * RADIX;
        for (int w0 = 0; w0 < words; w0 += THREADS * 8) {
          uint32_t r[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int w = w0 + u * THREADS + tid;
            r[u] = w < words ? __ldcg(P.rows + w) : 0u;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (r[u] != 0u) atomicAdd(&s_hist[(w0 + u * THREADS + tid) & (RADIX - 1)], r[u]);
          }
        }
        __syncthreads();
        pick_bucket(s_hist, prefix, kr, shift, s_state);
        if (tid < 2) P.state[tid] = s_state[tid];
      });
      prefix = __ldcg(P.state);
      kr = __ldcg(P.state + 1);
      own = __ldcg(P.rows + cta * RADIX + ((prefix >> shift) & (RADIX - 1)));
    } else {
      pick_bucket(s_hist, prefix, kr, shift, s_state);
      prefix = s_state[0];
      kr = s_state[1];
      own = s_state[2];
    }
  }

  // 3. gather, in index order: each thread's run of a window as two masks,
  // its (less, equal) counts packed 16:16 (a window holds <= 32768 values)
  const uint32_t T = prefix;
  uint32_t less = 0u, equal = 0u, run_l = 0u, run_e = 0u;
  int r0 = 0;
  if (grid) {  // this CTA's counts, then their CTA-order prefix
    uint32_t cl = 0u, ce = 0u;
    for (int w = 0; w < P.windows; ++w) {
      const int m = max(0, min(P.window, len - w * P.window));
      if (reload) {
      load_window<DESC, false>(s_win, P.values + base + static_cast<int64_t>(w) * P.window, m,
                               nullptr);
    }
      r0 = run_masks(s_win, m, T, &less, &equal);
      uint32_t tot;
      block_scan((static_cast<uint32_t>(__popc(less)) << 16) | __popc(equal), &tot);
      cl += tot >> 16;
      ce += tot & 0xffffu;
    }
    if (tid == 0) {
      P.rows[cta * RADIX] = cl;
      P.rows[cta * RADIX + 1] = ce;
    }
    exchange(P.bar, ctas, [&] {
      const uint32_t l = tid < ctas ? __ldcg(P.rows + tid * RADIX) : 0u;
      const uint32_t e = tid < ctas ? __ldcg(P.rows + tid * RADIX + 1) : 0u;
      uint32_t tl, te;
      const uint32_t bl = block_scan(l, &tl);
      const uint32_t be = block_scan(e, &te);
      if (tid < ctas) {
        P.rows[tid * RADIX + 2] = bl;
        P.rows[tid * RADIX + 3] = be;
      }
    });
    run_l = __ldcg(P.rows + cta * RADIX + 2);
    run_e = __ldcg(P.rows + cta * RADIX + 3);
  }
  for (int w = 0; w < P.windows; ++w) {
    const int m = max(0, min(P.window, len - w * P.window));
    if (reload) {
      load_window<DESC, false>(s_win, P.values + base + static_cast<int64_t>(w) * P.window, m,
                               nullptr);
    }
    if (reload || !grid) r0 = run_masks(s_win, m, T, &less, &equal);
    uint32_t tot;
    const uint32_t before =
        block_scan((static_cast<uint32_t>(__popc(less)) << 16) | __popc(equal), &tot);
    uint32_t ml = run_l + (before >> 16), me = run_e + (before & 0xffffu);
    const int64_t g0 = base + static_cast<int64_t>(w) * P.window + r0;
    for (uint32_t sel = less | equal; sel != 0u;) {
      const int j = __ffs(sel) - 1;
      sel &= sel - 1u;
      uint32_t pos;
      bool take = true;
      if ((less >> j) & 1u) {
        pos = ml + min(me, kr);
        ++ml;
      } else {
        take = me < kr;
        pos = ml + me;
        if (++me >= kr) sel &= less;  // the rest of the ties are not taken
      }
      if (take) {
        const uint32_t id = static_cast<uint32_t>(g0 + j);
        if (P.sorted) {
          gk[pos] = s_win[slot(r0 + j)];
          gi[pos] = id;
        } else {
          P.out_v[pos] = __ldg(P.values + id);
          P.out_i[pos] = id;
        }
      }
    }
    run_l += tot >> 16;
    run_e += tot & 0xffffu;
    __syncthreads();
  }
  if (!P.sorted) return;

  // 4. order: four stable LSD passes over the k selected images. Each
  // ranking step counts a warp's lanes per digit (warp_peers), scans the
  // (digit, warp) table and places each lane after the lanes before it.
  const int S = P.sort_ctas;
  if (grid) exchange(P.bar, ctas, [] {});  // every CTA's gather is visible
  if (cta >= S) return;
  if (small_sort) {  // one CTA, one (image, index) key a thread: bitonic
    // sort of the next power of two >= k keys, padded with the largest key;
    // keys are distinct, so the order is the stable sort's. Only the warps
    // that hold keys stay; they meet at named barrier 1.
    int width = 32;
    while (width < P.k) width <<= 1;
    if (tid >= width) return;
    uint64_t key = ~0ull;
    if (tid < P.k && grid) {
      key = (static_cast<uint64_t>(__ldcg(P.keys[0] + tid)) << 32) | __ldcg(P.idx[0] + tid);
    } else if (tid < P.k) {
      key = (static_cast<uint64_t>(s_sk[tid]) << 32) | s_si[tid];
    }
    uint64_t* buf = reinterpret_cast<uint64_t*>(s_cnt);  // 2 x THREADS keys
    int flip = 0;
    for (int size = 2; size <= width; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        uint64_t other;
        if (stride >= 32) {  // across warps, through shared memory
          buf[flip * THREADS + tid] = key;
          asm volatile("bar.sync 1, %0;" ::"r"(width) : "memory");
          other = buf[flip * THREADS + (tid ^ stride)];
          flip ^= 1;
        } else {
          other = __shfl_xor_sync(~0u, key, stride);
        }
        const bool low = ((tid & size) == 0) == ((tid & stride) == 0);
        key = low ? min(key, other) : max(key, other);
      }
    }
    if (tid < P.k) {
      const uint32_t id = static_cast<uint32_t>(key);
      P.out_v[tid] = __ldg(P.values + id);
      P.out_i[tid] = id;
    }
    return;
  }
  // k > THREADS: S CTAs, each a segment of seg elements in tiles of THREADS,
  // ping-pong through the scratch
  for (int z = tid; z < 2 * RADIX * CNT_STRIDE; z += THREADS) s_cnt[z] = 0u;
  const int64_t s0 = static_cast<int64_t>(cta) * P.seg;
  const int slen = static_cast<int>(
      max(static_cast<int64_t>(0), min(static_cast<int64_t>(P.seg), P.k - s0)));
  int tile = 0;
  for (int q = 0; q < DIGITS; ++q) {
    const int shift = 8 * q;
    const uint32_t* sk = (q & 1 ? P.keys[1] : P.keys[0]) + s0;
    const uint32_t* si = (q & 1 ? P.idx[1] : P.idx[0]) + s0;
    uint32_t* dk = q & 1 ? P.keys[0] : P.keys[1];
    uint32_t* di = q & 1 ? P.idx[0] : P.idx[1];
    if (q > 0 && S > 1) exchange(P.bar, S, [] {});  // the last scatter is visible
    if (tid < RADIX) s_hist[tid] = 0u;
    __syncthreads();
#pragma unroll 4
    for (int i = tid; i < slen; i += THREADS) {
      atomicAdd(&s_hist[(__ldcg(sk + i) >> shift) & (RADIX - 1)], 1u);
    }
    __syncthreads();
    if (S > 1) {
      if (tid < RADIX) P.rows[cta * RADIX + tid] = s_hist[tid];
      exchange(P.bar, S, [&] { merge_sort_rows(P.rows, S); });
      if (tid < RADIX) s_hist[tid] = __ldcg(P.rows + cta * RADIX + tid);
    } else {
      uint32_t tot;
      const uint32_t b = block_scan(tid < RADIX ? s_hist[tid] : 0u, &tot);
      if (tid < RADIX) s_hist[tid] = b;
    }
    __syncthreads();  // s_hist: where this CTA's next element of each digit goes
    for (int i0 = 0; i0 < slen; i0 += THREADS, ++tile) {
      uint32_t* cnt = s_cnt + (tile & 1) * RADIX * CNT_STRIDE;
      const int i = i0 + tid;
      const bool in = i < slen;
      const uint32_t key = in ? __ldcg(sk + i) : 0u;
      const uint32_t id = in ? __ldcg(si + i) : 0u;
      const uint32_t d = (key >> shift) & (RADIX - 1);
      const uint32_t peers = warp_peers(__ballot_sync(~0u, in), d);
      if (in && lane == __ffs(peers) - 1) cnt[d * CNT_STRIDE + warp] = __popc(peers);
      __syncthreads();
      {  // thread (dd, part): offsets of its eight warps for digit dd, from s_hist[dd]
        const int dd = tid >> 2, part = tid & 3;
        uint32_t c8[8];
        const uint32_t sum = warp_counts(cnt, c8);
        uint32_t incl = sum;
        uint32_t y = __shfl_up_sync(~0u, incl, 1, 4);
        if (part >= 1) incl += y;
        y = __shfl_up_sync(~0u, incl, 2, 4);
        if (part >= 2) incl += y;
        const uint32_t digit_total = __shfl_sync(~0u, incl, lane | 3);
        const uint32_t off = s_hist[dd];
        __syncwarp();
        write_offsets(cnt, s_cnt + ((tile + 1) & 1) * RADIX * CNT_STRIDE, c8, off + incl - sum);
        if (part == 3) s_hist[dd] = off + digit_total;
      }
      __syncthreads();
      if (in) {
        const uint32_t pos = cnt[d * CNT_STRIDE + warp] + __popc(peers & ((1u << lane) - 1u));
        if (q == DIGITS - 1) {
          P.out_v[pos] = __ldg(P.values + id);
          P.out_i[pos] = id;
        } else {
          dk[pos] = key;
          di[pos] = id;
        }
      }
    }
    __syncthreads();
  }
}

// values: (n,) f32 on the device. ctas and sort_ctas come from the plan
// (kernels/radix_topk.py::plan). scratch: the plan's scratch words
// (ctas > 1: RADIX per CTA + STATE_WORDS; sorted: 4 * k more). bar: two
// words, zeroed once, used by one stream at a time. out_v (k,) f32, out_i (k,)
// i64. Launches on `stream`, does not synchronise; returns the launch error.
template <bool DESC>
int radix_topk_launch(const float* values, int n, int k, int sorted, int ctas, int sort_ctas,
                      uint32_t* scratch, uint32_t* bar, float* out_v, int64_t* out_i,
                      cudaStream_t stream) {
  Params P{};
  P.values = values;
  P.n = n;
  P.k = k;
  P.sorted = sorted;
  P.chunk = static_cast<int>((static_cast<int64_t>(n) + ctas - 1) / ctas);
  P.window = P.chunk < WINDOW ? P.chunk : WINDOW;
  P.windows = (P.chunk + WINDOW - 1) / WINDOW;
  P.sort_ctas = sort_ctas;
  P.seg = static_cast<int>((static_cast<int64_t>(k) + sort_ctas - 1) / sort_ctas);
  uint32_t* w = scratch;
  if (ctas > 1) {
    P.rows = w;
    w += static_cast<size_t>(ctas) * RADIX;
    P.state = w;
    w += STATE_WORDS;
  }
  if (sorted) {
    for (int b = 0; b < 2; ++b) {
      P.keys[b] = w;
      w += k;
      P.idx[b] = w;
      w += k;
    }
  }
  P.bar = bar;
  P.out_v = out_v;
  P.out_i = out_i;
  static uint64_t attr_set = 0;  // devices whose shared-memory limit is raised
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64 || !((attr_set >> device) & 1u)) {
    err = cudaFuncSetAttribute(radix_topk_kernel<DESC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(WINDOW, true)));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 64) attr_set |= uint64_t{1} << device;
  }
  const size_t smem = smem_bytes(P.window, sorted != 0);
  if (ctas == 1) {
    radix_topk_kernel<DESC><<<1, THREADS, smem, stream>>>(P);
  } else {
    void* args[] = {&P};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(radix_topk_kernel<DESC>), dim3(ctas), dim3(THREADS), args,
        smem, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace radix_topk
