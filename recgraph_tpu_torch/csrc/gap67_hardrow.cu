// K12 on its own: the modes-6/7 hard-row column program
// (gap67_hardrow.cuh) over staged inputs, one warp per read.
//
// Replaces the TPU kernel recgraph_tpu/ops/pallas_gap67_hardrow.py:175
// hard_cols_lc.  The fill (gap67_fill.cu, K11) calls the same __device__
// function for each hard row; this entry exists so that the program can
// be held against its plain version (pathwise_gap_engine.hard_cols_plain)
// on the same inputs.  Per read b the inputs are U, Dc [B, MB, C],
// Dfd, Ypre [B, P, C], lanes [B, 4, P], x0 [B, P], and the per-block
// scalars blk [5, MB] (tb, nd, fire, isa, after) shared by the reads;
// the outputs xs, ds are [B, P, C].
//
// The kernel allocates nothing, does not synchronise with the host and
// runs on the stream it is given.

#include "gap67_hardrow.cuh"

namespace rgt {

__global__ void __launch_bounds__(32)
gap67_hardrow_kernel(const int* __restrict__ U, const int* __restrict__ Dc,
                     const int* __restrict__ Dfd, const int* __restrict__ Ypre,
                     const int* __restrict__ lanes, const int* __restrict__ x0,
                     const int* __restrict__ blk, int MB, int P, int C, int ai, int o, int e,
                     int* xs, int* ds) {
  extern __shared__ int sm[];
  int* s_blk = sm;                 // 5 * MB
  int* s_lanes = s_blk + 5 * MB;   // 4 * P
  int* s_x0 = s_lanes + 4 * P;     // P
  int* s_st = s_x0 + P;            // 4 * P
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int t = tid; t < 5 * MB; t += 32) s_blk[t] = blk[t];
  for (int t = tid; t < 4 * P; t += 32) s_lanes[t] = lanes[(size_t)b * 4 * P + t];
  for (int t = tid; t < P; t += 32) s_x0[t] = x0[(size_t)b * P + t];
  __syncwarp();
  const HardBlocks hb{s_blk, s_blk + MB, s_blk + 2 * MB, s_blk + 3 * MB, s_blk + 4 * MB, MB};
  const HardLanes hl{s_lanes, s_lanes + P, s_lanes + 2 * P, s_lanes + 3 * P};
  const size_t sb = (size_t)b * MB * C, qb = (size_t)b * P * C;
  gap67_hard_cols(U + sb, Dc + sb, C, Dfd + qb, Ypre + qb, C, C, hb, hl, s_x0, P, ai, o, e,
                  xs + qb, ds + qb, C, s_st);
}

}  // namespace rgt

extern "C" int rgt_gap67_hardrow(const int* U, const int* Dc, const int* Dfd, const int* Ypre,
                                 const int* lanes, const int* x0, const int* blk, int B, int MB,
                                 int P, int C, int ai, int o, int e, int* xs, int* ds,
                                 void* stream) {
  if (B < 1 || MB < 1 || P < 1 || C < 0 || ai < 0 || ai >= P) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(5 * MB + 9 * P) * sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  rgt::gap67_hardrow_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(
      U, Dc, Dfd, Ypre, lanes, x0, blk, MB, P, C, ai, o, e, xs, ds);
  return (int)cudaGetLastError();
}
