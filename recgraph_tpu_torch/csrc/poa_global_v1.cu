// The v1 TPU layout of the mode-0 banded global fill (K14), through the
// tiled mode-0 kernel body (poa_global.cuh, kV1 = true) that K3 also runs.
//
// Replaces the TPU kernel recgraph_tpu/ops/pallas_poa.py:537 fill_global
// (v1), which computes K1's function and returns packed int32
// [n, B, Lp + 8]: lanes [0, Lp) the pred * 16 + dir cells, lane Lp each
// row's band start, lane Lp + 1 its band end, lanes Lp + 2 .. Lp + 7
// zero, row n - 1 zero.  The kernel writes that layout itself and keeps
// its band history in those lanes.  What bounds it: one block per read,
// latency-bound on its per-row barriers (poa_global.cuh).

#include "poa_global.cuh"

extern "C" int rgt_poa_global_v1_fill(
    const int* seq, const int* L, const int* bta, const int* table,
    const int* codes, const int* pred_idx, const int* min_pred,
    const int* r_values, const int* cand, int n_cand, int B, int n, int Pm,
    int Lp, int* m, int* bsp, int* score, int* last_row, int* last_col,
    int* packed, int* wss, void* stream) {
  if (B < 1 || n < 3 || Pm < 1 || Lp < 1 || n_cand < 1)
    return (int)cudaErrorInvalidValue;
  rgt::poa_global_kernel<false, true>
      <<<B, rgt::block_threads(Lp), 0, (cudaStream_t)stream>>>(
          seq, L, bta, table, codes, pred_idx, min_pred, r_values, cand, n_cand,
          n, Pm, Lp, Lp, m, bsp, score, last_row, last_col, packed, nullptr,
          nullptr, wss, nullptr);
  return (int)cudaGetLastError();
}
