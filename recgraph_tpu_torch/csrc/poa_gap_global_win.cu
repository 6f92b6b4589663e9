// Mode-2 affine-gap banded global POA fill with windowed rows, for long
// reads (K6).
//
// Replaces the TPU kernel recgraph_tpu/ops/pallas_gap_global_win.py:413
// fill_gap_global_win, with the per-read window starts of the XLA engine
// (poa_gap_engine._fill_gap_global_windowed), as K3 does for mode 0.
// The kernel body, its design and what bounds it are in
// poa_gap_global.cuh.

#include "poa_gap_global.cuh"

extern "C" int rgt_poa_gap_global_win_fill(
    const int* seq, const int* L, const int* bta, const int* table,
    const int* codes, const int* pred_idx, const int* min_pred,
    const int* r_values, const int* cand, int n_cand, int B, int n, int Pm,
    int Lp, int W, int o, int e, int* m, int* y, int* bsp, int* score,
    int* last_row, int* last_col, int* packed, int* packed_x, int* packed_y,
    int* lefts, int* rights, int* wss, bool* over, void* stream) {
  if (B < 1 || n < 3 || Pm < 1 || Lp < 1 || W < 8 || n_cand < 1)
    return (int)cudaErrorInvalidValue;
  rgt::poa_gap_global_win_kernel
      <<<B, rgt::block_threads(W), 0, (cudaStream_t)stream>>>(
          seq, L, bta, table, codes, pred_idx, min_pred, r_values, cand, n_cand,
          n, Pm, Lp, W, o, e, m, y, bsp, score, last_row, last_col, packed,
          packed_x, packed_y, lefts, rights, wss, over);
  return (int)cudaGetLastError();
}
