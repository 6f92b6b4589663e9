// Two superseded TPU generations of the mode-1 fill, each in its own
// output layout, through one kernel body (poa_local.cuh, K2's before
// K2 was redesigned).  K13 and K15, two more, are forms of K2's Hopper
// kernel (poa_local.cu).
//
// They compute K2's function; only what they store differs, and the
// kernel writes each layout itself (no transposing copy afterwards):
//
//   K16 rgt_poa_local_scores_fill the score plane m int32[n_store, B, Lp]
//       as the output, no packed plane
//       replaces tools/pallas_poa_v3.py:137 fill_local_scores
//   K17 rgt_poa_local_v4_fill     packed int32[n_store, B, Lp]
//       replaces tools/pallas_poa_v4.py:218 fill_local_v4
//
// Rows [n-1, n_store) of the output plane are zeroed; the wrappers
// (ops/cuda_poa_variants.py) choose n_store as the TPU kernels pad their
// rows.  K17's m is an int32[B, n, Lp] scratch the wrapper allocates.
// What bounds them: one block per read, latency-bound on its per-row
// barriers.

#include "poa_local.cuh"

namespace {

template <typename PT, bool kScoresOnly>
int launch(const int* seq, const int* L, const int* table, const int* codes,
           const int* node_start, const int* pred_idx, int B, int n, int Pm,
           int Lp, int n_store, int* m, PT* packed, int* best_val, int* best_i,
           int* best_j, void* stream) {
  if (B < 1 || n < 3 || Pm < 1 || Lp < 1 || n_store < n - 1)
    return (int)cudaErrorInvalidValue;
  rgt::poa_local_kernel<PT, kScoresOnly>
      <<<B, rgt::block_threads(Lp), 0, (cudaStream_t)stream>>>(
          seq, L, table, codes, node_start, pred_idx, n, Pm, Lp, m, packed,
          n_store, best_val, best_i, best_j);
  return (int)cudaGetLastError();
}

}  // namespace

// K17: packed [n_store, B, Lp] int32; m scratch [B, n, Lp]
extern "C" int rgt_poa_local_v4_fill(
    const int* seq, const int* L, const int* table, const int* codes,
    const int* node_start, const int* pred_idx, int B, int n, int Pm, int Lp,
    int n_store, int* m, int* best_val, int* best_i, int* best_j, int* packed,
    void* stream) {
  return launch<int, false>(seq, L, table, codes, node_start, pred_idx, B, n,
                            Pm, Lp, n_store, m, packed, best_val, best_i,
                            best_j, stream);
}

// K16: the score plane m [n_store, B, Lp] int32 is the output (and the
// row history); no packed plane
extern "C" int rgt_poa_local_scores_fill(
    const int* seq, const int* L, const int* table, const int* codes,
    const int* node_start, const int* pred_idx, int B, int n, int Pm, int Lp,
    int n_store, int* m, int* best_val, int* best_i, int* best_j,
    void* stream) {
  return launch<int, true>(seq, L, table, codes, node_start, pred_idx, B, n,
                           Pm, Lp, n_store, m, (int*)nullptr, best_val, best_i,
                           best_j, stream);
}
