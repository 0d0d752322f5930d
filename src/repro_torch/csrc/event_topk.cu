// event_topk: the k earliest pending completion times among n (Hopper, sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/event_topk.py::tile_next_k
// (_next_k_kernel) together with its phase 2 in src/repro/kernels/ops.py::
// event_next_k. Same function: (times (k,), idx (k,)) of the k smallest
// times, ties to the lower index, idle clients carrying +inf.
//
// Design and bound: tile_topk.cuh in ascending order. Each time and its
// index pack into one 64-bit key, one CTA bitonic-sorts a 2048-key tile in
// shared memory and keeps its first k, and the same kernel reruns over the
// candidates until one tile is left (k <= 1024). At the main path's
// n = 16384 the call moves 64 KiB, so it is bound by launch latency (two
// launches); a later single-pass radix select in one CTA would remove the
// second launch. This version is the simple one that is right.
#include "tile_topk.cuh"

extern "C" {

int event_topk_tile() { return TILE; }

// times: (n,) f32 on the device; see tile_topk_launch for the rest.
int event_topk_launch(const float* times, int n, int k, uint64_t* scratch_a,
                      uint64_t* scratch_b, float* out_t, int64_t* out_i,
                      cudaStream_t stream) {
  return tile_topk_launch<false>(times, n, k, scratch_a, scratch_b, out_t, out_i,
                                 stream);
}

}  // extern "C"
