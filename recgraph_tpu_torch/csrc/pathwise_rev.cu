// Modes 8/9 reverse pathwise fill (pathwise_alignment_recombination.rs:
// 129-435) for Hopper.
//
// Replaces the TPU kernels recgraph_tpu/ops/pallas_pathwise.py:622
// fill_pathwise_rev_v1 and, at every path count, its path-tiled variant
// recgraph_tpu/ops/pallas_pathwise_bigp.py:512 fill_pathwise_rev_bigp
// (which exists only because of the TPU's VMEM limit).  It computes what
// recombination_engine._fill_pathwise_rev (recgraph_tpu/ops/
// recombination_engine.py:87-188) computes with its exact replay, bit
// for bit: W int32[B, P, n, Lp] over the reverse graph, whose "pred"
// rows are successor rows.  The reverse read is rev[j] = seq[j + 1]
// with the sentinel at j = L - 1; Gs is the suffix sum of its gaps.
// Rows run n-2 -> 1 and columns right to left: at j = L - 1 mode 8
// restarts from the successor's column L - 1 plus the node's gap and
// mode 9 at 0; lanes j >= L and column 0 are 0.  Row n-1 holds the
// suffix gap chain on every plane while the rows above read it, and in
// the result only path 0's plane keeps it (the reference's row-(n-1)
// delta quirk).  Unlike the TPU kernel, it also takes the delta-leak
// graphs: a lane reads its own values from plane qsrc[i][q] (its
// representative's on a clone row), and the constant-0 lanes of a
// ghost-alpha row have no group (encode.group_table) and are written 0.
//
// Design: K7's (pathwise_common.cuh, pathwise_fill_kernel<true, ...>)
// mirrored: each group's chain runs from the right, so the rep's (max,+)
// suffix chain and its nearest non-L column to the right are prefix
// scans in that order; every cell then replays
//
//     row_q[j] = V_q[k] + Gs[j] - Gs[k],  k = the first non-L column >= j.
//
// What bounds it on this card: the bytes of W it writes (4 per cell);
// as for K7, a read's row latency bounds a read.
//
// The kernel allocates nothing, does not synchronise with the host and
// runs on the stream it is given.

#include "pathwise_common.cuh"

extern "C" int rgt_pathwise_rev_fill(
    const int* seq, const int* L, const int* table, const int* codes, const int* grep,
    const int* gpred, const int* pslot, const int* qsrc, const int* gcount, int B, int n, int P,
    int Lp, int Gd,
    int mode8, int cluster, int threads, int smem, int smem_form, int cw,
    unsigned char* scratch, long long stride, int* A, void* stream) {
  const rgt::PwArgs a{seq, L, table, codes, grep, gpred, pslot, qsrc, gcount, n, P, Lp, Gd,
                      mode8, cluster, smem_form, scratch, stride, A};
  return rgt::pathwise_launch<true>(a, B, threads, smem, cw, (cudaStream_t)stream);
}

extern "C" int rgt_pathwise_rev_per_sm(int threads, int smem, int smem_form, int cw) {
  return rgt::pathwise_per_sm<true>(threads, smem, smem_form, cw);
}
