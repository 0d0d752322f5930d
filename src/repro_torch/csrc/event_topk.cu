// event_topk: the k earliest pending completion times among n (Hopper, sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/event_topk.py::tile_next_k
// (_next_k_kernel) together with its phase 2 in src/repro/kernels/ops.py::
// event_next_k. Same function: (times (k,), idx (k,)) of the k smallest
// times in ascending order, ties to the lower index, idle clients carrying
// +inf.
//
// Design and bound: radix_topk.cuh in ascending order, always sorted. Any
// 1 <= k <= n in one launch; at the main path's (16384, 256) one CTA holds
// the 64 KiB of times in shared memory, so the call is bound by its launch
// and the latency of its passes.
#include "radix_topk.cuh"

extern "C" {

int event_topk_window() { return radix_topk::WINDOW; }

// times: (n,) f32 on the device; see radix_topk_launch for the rest.
int event_topk_launch(const float* times, int n, int k, int sorted, int ctas, int sort_ctas,
                      uint32_t* scratch, uint32_t* bar, float* out_t, int64_t* out_i,
                      cudaStream_t stream) {
  return radix_topk::radix_topk_launch<false>(times, n, k, sorted, ctas, sort_ctas, scratch,
                                              bar, out_t, out_i, stream);
}

}  // extern "C"
