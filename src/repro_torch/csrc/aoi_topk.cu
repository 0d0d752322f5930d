// aoi_topk: the k largest values among n, ties to the lower index (Hopper, sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/aoi_topk.py::tile_topk
// (_topk_kernel) together with its phase 2 in src/repro/kernels/ops.py::
// oldest_age_topk. Same function as jax.lax.top_k on f32 values: (vals (k,),
// idx (k,)) in descending order of value, equal values in ascending order of
// index; or, unsorted, the same k in ascending order of index.
//
// Design and bound: radix_topk.cuh in descending order (an image is the
// complement of the value's order-preserving bits). Any 1 <= k <= n in one
// launch; nothing depends on where a tile ends, so unlike the Pallas tiles'
// -1 padding no value is ever outranked by padding. At the policy's
// (16384, k) one CTA holds the scores in shared memory, so the call is
// bound by its launch and the latency of its passes.
#include "radix_topk.cuh"

extern "C" {

int aoi_topk_window() { return radix_topk::WINDOW; }

// values: (n,) f32 on the device; see radix_topk_launch for the rest.
int aoi_topk_launch(const float* values, int n, int k, int sorted, int ctas, int sort_ctas,
                    uint32_t* scratch, uint32_t* bar, float* out_v, int64_t* out_i,
                    cudaStream_t stream) {
  return radix_topk::radix_topk_launch<true>(values, n, k, sorted, ctas, sort_ctas, scratch,
                                             bar, out_v, out_i, stream);
}

}  // extern "C"
