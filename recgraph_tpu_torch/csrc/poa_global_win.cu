// Mode-0 banded global POA fill with windowed rows, for long reads (K3).
//
// Replaces the TPU kernel recgraph_tpu/ops/pallas_poa_global_win.py:417
// fill_global_win, with the per-read window starts of the XLA engine
// (poa_engine._fill_global_windowed) rather than the Pallas kernel's
// tile-uniform start: one block per read needs no shared window, and
// every output is then comparable with the XLA fill cell for cell.  The
// kernel body, its design and what bounds it are in poa_global.cuh.

#include "poa_global.cuh"

extern "C" int rgt_poa_global_win_fill(
    const int* seq, const int* L, const int* bta, const int* table,
    const int* codes, const int* pred_idx, const int* min_pred,
    const int* r_values, const int* cand, int n_cand, int B, int n, int Pm,
    int Lp, int W, int* m, int* bsp, int* score, int* last_row, int* last_col,
    int* packed, int* lefts, int* rights, int* wss, bool* over, void* stream) {
  if (B < 1 || n < 3 || Pm < 1 || Lp < 1 || W < 8 || n_cand < 1)
    return (int)cudaErrorInvalidValue;
  rgt::poa_global_kernel<true>
      <<<B, rgt::block_threads(W), 0, (cudaStream_t)stream>>>(
          seq, L, bta, table, codes, pred_idx, min_pred, r_values, cand, n_cand,
          n, Pm, Lp, W, m, bsp, score, last_row, last_col, packed, lefts, rights,
          wss, over);
  return (int)cudaGetLastError();
}
