// aoi_topk: the k largest values among n, ties to the lower index (Hopper, sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/aoi_topk.py::tile_topk
// (_topk_kernel) together with its phase 2 in src/repro/kernels/ops.py::
// oldest_age_topk. Same function as jax.lax.top_k on f32 values: (vals (k,),
// idx (k,)) in descending order of value, equal values in ascending order
// of index.
//
// Design: the K2 kernel (event_topk.cu) in descending order, from
// tile_topk.cuh. Each value packs with its index into one 64-bit key whose
// high word is the complement of the value's order-preserving bits, so an
// ascending bitonic sort of 2048-key tiles puts the largest values first,
// equal values by ascending index; the kernel reruns over the candidates
// until one tile is left (k <= 1024). Padding is the all-ones key, larger
// than any real key, so it never wins: unlike the Pallas tile's -1 padding,
// nothing depends on where the tiles end.
//
// Bound: the call reads n*4 bytes and writes k*12; at the policy's
// n = 16384 that is 64 KiB, about 20 ns of HBM time, so it is bound by
// launch latency (two launches at n = 16384).
#include "tile_topk.cuh"

extern "C" {

int aoi_topk_tile() { return TILE; }

// values: (n,) f32 on the device; see tile_topk_launch for the rest.
int aoi_topk_launch(const float* values, int n, int k, uint64_t* scratch_a,
                    uint64_t* scratch_b, float* out_v, int64_t* out_i,
                    cudaStream_t stream) {
  return tile_topk_launch<true>(values, n, k, scratch_a, scratch_b, out_v, out_i,
                                stream);
}

}  // extern "C"
