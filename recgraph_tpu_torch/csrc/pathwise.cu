// Modes 4/5 dense pathwise fill (pathwise_alignment.rs:16-304) for Hopper.
//
// Replaces the TPU kernels recgraph_tpu/ops/pallas_pathwise.py:462
// fill_pathwise_v1 and, at every path count, its path-tiled variant
// recgraph_tpu/ops/pallas_pathwise_bigp.py:409 fill_pathwise_bigp (which
// exists only because of the TPU's VMEM limit).  It computes what
// pathwise_engine._fill_pathwise (recgraph_tpu/ops/pathwise_engine.py:
// 43-140) computes, bit for bit: A int32[B, P, n, Lp] of per-path
// absolute scores, row 0 = G - G[0] on every path, row n-1 and
// off-path lanes 0, the rep's tie order mx == d, mx == u, else L, column
// 0 restarting at 0 (mode 5) or at the pred's column 0 plus the node's
// gap (mode 4), and the node-code-major substitution table[code_i][seq_j].
//
// Design: pathwise_common.cuh (pathwise_fill_kernel<false, ...>): rows
// in order, each group's chain on one or more warps from the left, the
// row's cells replayed by all threads of the read's block or cluster
// from source rows staged beside the chains.
//
// What bounds it on this card: the bytes of A it writes (4 per cell).
// A read's rows are sequential (a row reads its predecessor rows), so a
// row's latency (the chain's loads and two warp scans with their
// cross-warp carries, two barriers, the replay) bounds a read; the
// wrapper spreads a read over a cluster of blocks when the reads are
// fewer than the SMs.
//
// The kernel allocates nothing, does not synchronise with the host and
// runs on the stream it is given.

#include "pathwise_common.cuh"

extern "C" int rgt_pathwise_fill(
    const int* seq, const int* table, const int* codes, const int* grep, const int* gpred,
    const int* pslot, const int* gcount, int B, int n, int P, int Lp, int Gd, int semiglobal,
    int cluster,
    int threads, int smem, int smem_form, int cw, unsigned char* scratch, long long stride,
    int* A, void* stream) {
  const rgt::PwArgs a{seq, nullptr, table, codes, grep, gpred, pslot, nullptr, gcount, n, P, Lp, Gd,
                      !semiglobal, cluster, smem_form, scratch, stride, A};
  return rgt::pathwise_launch<false>(a, B, threads, smem, cw, (cudaStream_t)stream);
}

extern "C" int rgt_pathwise_per_sm(int threads, int smem, int smem_form, int cw) {
  return rgt::pathwise_per_sm<false>(threads, smem, smem_form, cw);
}
