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
// Design (pathwise_common.cuh): one thread block per read; a row's
// columns are tiles of blockDim.x.  Per row, each group's rep chain is
// two block scans (the (max,+) prefix of A - G, then the last non-L
// column), written with the D flags to a per-read device scratch; after
// one barrier every (path, column) cell of the row is independent and
// reads its own plane at its predecessor row and the scratch.
//
// What bounds it on this card: the bytes of A it writes (4 per cell),
// plus the two predecessor cells each cell reads; one block is
// latency-bound on its per-row barriers, so throughput comes from many
// reads (blocks) per SM.
//
// The kernel allocates nothing, does not synchronise with the host and
// runs on the stream it is given.

#include "pathwise_common.cuh"

namespace rgt {

__global__ void __launch_bounds__(MAX_THREADS, 1)
pathwise_kernel(const int* __restrict__ seq, const int* __restrict__ table,
                const int* __restrict__ codes, const int* __restrict__ grep,
                const int* __restrict__ gpred, const int* __restrict__ pslot,
                int n, int P, int Lp, int Gd, int semiglobal, int* Gs, int* kidx_s,
                int* flag_s, int* A) {
  __shared__ int s_table[NCODE * NCODE];
  __shared__ int s_warp[32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int ntiles = (Lp + T - 1) / T;
  for (int t = tid; t < NCODE * NCODE; t += T) s_table[t] = table[t];
  __syncthreads();

  const int* sb = seq + (size_t)b * Lp;
  int* G = Gs + (size_t)b * Lp;
  int* kidx = kidx_s + (size_t)b * Gd * Lp;
  int* flag = flag_s + (size_t)b * Gd * Lp;
  const size_t plane = (size_t)n * Lp;   // one path's [n, Lp] plane
  int* Ab = A + (size_t)b * P * plane;

  // G = cumsum(sm(seq[j], '-'))
  int carry = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int j = t * T + tid;
    const int g = j < Lp ? s_table[sb[j] * NCODE + GAP] : 0;
    const int v = tile_prefix_sum(g, s_warp, carry);
    if (j < Lp) G[j] = v;
  }
  __syncthreads();

  // row 0: every path advances with the read's gaps; row n-1 stays 0
  const int g0 = G[0];
  for (int q = 0; q < P; ++q) {
    int* r0 = Ab + (size_t)q * plane;
    int* rl = r0 + (size_t)(n - 1) * Lp;
    for (int j = tid; j < Lp; j += T) {
      r0[j] = G[j] - g0;
      rl[j] = 0;
    }
  }
  __syncthreads();

  for (int i = 1; i < n - 1; ++i) {
    const int code = codes[i];
    const int gap_i = s_table[code * NCODE + GAP];
    const int* sub_row = s_table + code * NCODE;
    const int* gr = grep + (size_t)i * Gd;
    const int* gp = gpred + (size_t)i * Gd;

    // 1. each group's rep chain: its D flags and last non-L columns
    for (int g = 0; g < Gd; ++g) {
      const int r = gr[g];
      if (r < 0) break;                      // the same for every thread
      const int* Ar = Ab + (size_t)r * plane + (size_t)gp[g] * Lp;
      int* kg = kidx + (size_t)g * Lp;
      int* fg = flag + (size_t)g * Lp;
      int ccarry = INT_MIN, kcarry = -1;
      for (int t = 0; t < ntiles; ++t) {
        const int j = t * T + tid;
        const bool live = j < Lp;
        int d_r = 0, u_r = 0, Gj = 0, x = INT_MIN;
        if (live) {
          const int arj = Ar[j];
          d_r = (j > 0 ? Ar[j - 1] : NEG) + sub_row[sb[j]];
          u_r = arj + gap_i;
          const int ach = j == 0 ? (semiglobal ? 0 : arj + gap_i) : max(d_r, u_r);
          Gj = G[j];
          x = ach - Gj;
        }
        const int rep_row = Gj + tile_prefix_max(x, s_warp, ccarry);
        const bool dD = live && rep_row == d_r;
        const bool dU = live && !dD && rep_row == u_r;
        const int k = tile_prefix_max(live && (dD || dU || j == 0) ? j : -1, s_warp, kcarry);
        if (live) {
          kg[j] = k;
          fg[j] = dD;
        }
      }
    }
    __syncthreads();

    // 2. every lane of the row: replay its group's moves, 0 off-path
    const int* ps = pslot + (size_t)i * P;
    for (int q = 0; q < P; ++q) {
      const int g = ps[q];
      int* out = Ab + (size_t)q * plane + (size_t)i * Lp;
      if (g < 0) {
        for (int j = tid; j < Lp; j += T) out[j] = 0;
        continue;
      }
      const int* Aq = Ab + (size_t)q * plane + (size_t)gp[g] * Lp;
      const int* kg = kidx + (size_t)g * Lp;
      const int* fg = flag + (size_t)g * Lp;
      for (int j = tid; j < Lp; j += T) {
        const int k = kg[j];
        int v;
        if (k == 0) {
          v = semiglobal ? 0 : Aq[0] + gap_i;
        } else if (fg[k]) {
          v = Aq[k - 1] + sub_row[sb[k]];
        } else {
          v = Aq[k] + gap_i;
        }
        out[j] = v + G[j] - G[k];
      }
    }
    // publishes row i before row i + 1 and frees the group scratch
    __syncthreads();
  }
}

}  // namespace rgt

extern "C" int rgt_pathwise_fill(
    const int* seq, const int* table, const int* codes, const int* grep,
    const int* gpred, const int* pslot, int B, int n, int P, int Lp, int Gd,
    int semiglobal, int* G, int* kidx, int* flag, int* A, void* stream) {
  if (B < 1 || n < 3 || P < 1 || Lp < 1 || Gd < 1) return (int)cudaErrorInvalidValue;
  rgt::pathwise_kernel<<<B, rgt::block_threads(Lp), 0, (cudaStream_t)stream>>>(
      seq, table, codes, grep, gpred, pslot, n, P, Lp, Gd, semiglobal, G, kidx, flag, A);
  return (int)cudaGetLastError();
}
