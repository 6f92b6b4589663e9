// K12 on its own: the modes-6/7 hard-row column program
// (gap67_hardrow.cuh) over staged inputs, one block per read.
//
// Replaces the TPU kernel recgraph_tpu/ops/pallas_gap67_hardrow.py:175
// hard_cols_lc.  The fill (gap67_fill.cu, K11) runs the same __device__
// program for each hard row; this entry exists so that the program can
// be held against its plain version (pathwise_gap_engine.hard_cols_plain)
// on the same inputs.  Per read b: V, W [B, P, Lp] (chain_inputs, column
// j at j, column 0 unused), slots [B, 4, P] and hub [B, 3] (hubs, alpha
// slot, isa slot; chain_coefs), x0 [B, P]; the outputs X, D [B, P, Lp]
// hold x0 in column 0 and the program's columns after it.  A block has
// one warp, and one more for each lane past 32 (at most 32 warps).
//
// The kernel allocates nothing, does not synchronise with the host and
// runs on the stream it is given; Lp must be a multiple of 4.

#include <algorithm>

#include "gap67_hardrow.cuh"

namespace rgt {

__global__ void __launch_bounds__(MAX_THREADS, 1)
gap67_hardrow_kernel(const int* __restrict__ V, const int* __restrict__ W,
                     const int* __restrict__ slots, const int* __restrict__ hub,
                     const int* __restrict__ x0, int P, int Lp, int o, int e, int* X, int* D) {
  extern __shared__ int sm[];
  int* s_x0 = sm;          // P
  int* s_st = s_x0 + P;    // 4 P: the state past 32 hubs
  const int b = blockIdx.x;
  for (int q = threadIdx.x; q < P; q += blockDim.x) s_x0[q] = x0[(size_t)b * P + q];
  __syncthreads();
  const size_t pb = (size_t)b * P * Lp;
  const int* h = hub + 3 * b;
  const HardRow r{V + pb, W + pb, Lp, slots + (size_t)b * 4 * P, s_x0, P, h[0], h[1], h[2],
                  o, e, X + pb, D + pb, Lp};
  gap67_hard_row(r, s_st, [] {});
}

}  // namespace rgt

extern "C" int rgt_gap67_hardrow(const int* V, const int* W, const int* slots, const int* hub,
                                 const int* x0, int B, int P, int Lp, int o, int e, int* X,
                                 int* D, void* stream) {
  if (B < 1 || P < 1 || Lp < 4 || Lp % 4) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)5 * P * sizeof(int);
  if (smem > 40 * 1024) return (int)cudaErrorInvalidValue;
  const int T = 32 * std::min(32, 1 + std::max(0, P - rgt::CHAIN_WARP));
  rgt::gap67_hardrow_kernel<<<B, T, smem, (cudaStream_t)stream>>>(V, W, slots, hub, x0, P, Lp,
                                                                    o, e, X, D);
  return (int)cudaGetLastError();
}
