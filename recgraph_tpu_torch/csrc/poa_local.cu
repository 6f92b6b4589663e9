// Mode-1 local POA fill (K2), the main path's layout.
//
// Replaces the TPU kernel recgraph_tpu/ops/pallas_poa_v5.py:251
// fill_local_v5.  The kernel body, its design and what bounds it are in
// poa_local.cuh; here the score scratch m and the packed plane are both
// [B, n, Lp] int32 and row n-1 of packed is zeroed.

#include "poa_local.cuh"

extern "C" int rgt_poa_local_fill(
    const int* seq, const int* L, const int* table, const int* codes,
    const int* node_start, const int* pred_idx, int B, int n, int Pm, int Lp,
    int* m, int* best_val, int* best_i, int* best_j, int* packed,
    void* stream) {
  if (B < 1 || n < 3 || Pm < 1 || Lp < 1) return (int)cudaErrorInvalidValue;
  rgt::poa_local_kernel<int, false, false>
      <<<B, rgt::block_threads(Lp), 0, (cudaStream_t)stream>>>(
          seq, L, table, codes, node_start, pred_idx, n, Pm, Lp, m, packed, n,
          best_val, best_i, best_j);
  return (int)cudaGetLastError();
}
