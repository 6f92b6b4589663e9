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
// Design: K7's (pathwise.cu) mirrored.  One thread block per read; a
// row's columns are tiles of blockDim.x, taken from the right, so the
// rep's (max,+) suffix chain and its nearest non-L column to the right
// are prefix scans in that order.  Per row, each group's chain is two
// block scans, written with the D flags to a per-read device scratch;
// after one barrier every (path, column) cell replays on its own,
//
//     row_q[j] = V_q[k] + Gs[j] - Gs[k],  k = the first non-L column >= j.
//
// What bounds it on this card: the bytes of W it writes (4 per cell);
// one block is latency-bound on its per-row barriers, so throughput
// comes from many reads (blocks) per SM.
//
// The kernel allocates nothing, does not synchronise with the host and
// runs on the stream it is given.

#include "pathwise_common.cuh"

namespace rgt {

constexpr int SENTINEL = 6;  // scoring.SENTINEL ('$' and 'F')

__global__ void __launch_bounds__(MAX_THREADS, 1)
pathwise_rev_kernel(const int* __restrict__ seq, const int* __restrict__ Ls,
                    const int* __restrict__ table, const int* __restrict__ codes,
                    const int* __restrict__ grep, const int* __restrict__ gpred,
                    const int* __restrict__ pslot, const int* __restrict__ qsrc, int n,
                    int P, int Lp, int Gd, int mode8, int* Gss, int* kidx_s, int* flag_s,
                    int* A) {
  __shared__ int s_table[NCODE * NCODE];
  __shared__ int s_warp[32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int ntiles = (Lp + T - 1) / T;
  for (int t = tid; t < NCODE * NCODE; t += T) s_table[t] = table[t];
  __syncthreads();

  const int* sb = seq + (size_t)b * Lp;
  const int L = Ls[b];
  int* Gs = Gss + (size_t)b * Lp;
  int* kidx = kidx_s + (size_t)b * Gd * Lp;
  int* flag = flag_s + (size_t)b * Gd * Lp;
  const size_t plane = (size_t)n * Lp;   // one path's [n, Lp] plane
  int* Ab = A + (size_t)b * P * plane;
  // the reverse read: seq shifted left by one (wrapping), the sentinel at L - 1
  auto rev_at = [&](int j) { return j == L - 1 ? SENTINEL : sb[j + 1 < Lp ? j + 1 : 0]; };

  // Gs = suffix sums of sm(rev[j], '-'), 0 past the read; thread tid of
  // tile t owns column Lp - 1 - (t * T + tid)
  int carry = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int r = t * T + tid;
    const int j = Lp - 1 - r;
    const int g = (r < Lp && j < L) ? s_table[rev_at(j) * NCODE + GAP] : 0;
    const int v = tile_prefix_sum(g, s_warp, carry);
    if (r < Lp) Gs[j] = v;
  }
  __syncthreads();

  // row 0 stays 0; row n-1 carries the suffix gap chain on every plane
  for (int q = 0; q < P; ++q) {
    int* r0 = Ab + (size_t)q * plane;
    int* rl = r0 + (size_t)(n - 1) * Lp;
    for (int j = tid; j < Lp; j += T) {
      r0[j] = 0;
      rl[j] = (j > 0 && j < L) ? Gs[j] : 0;
    }
  }
  __syncthreads();

  for (int i = n - 2; i >= 1; --i) {
    const int code = codes[i];
    const int gap_i = s_table[code * NCODE + GAP];
    const int* sub_row = s_table + code * NCODE;
    const int* gr = grep + (size_t)i * Gd;
    const int* gp = gpred + (size_t)i * Gd;

    // 1. each group's rep chain, right to left: D flags and the first
    //    non-L column at or after each column
    for (int g = 0; g < Gd; ++g) {
      const int rep = gr[g];
      if (rep < 0) break;                    // the same for every thread
      const int* Ar = Ab + (size_t)rep * plane + (size_t)gp[g] * Lp;
      int* kg = kidx + (size_t)g * Lp;
      int* fg = flag + (size_t)g * Lp;
      int ccarry = INT_MIN, kcarry = -1;
      for (int t = 0; t < ntiles; ++t) {
        const int r = t * T + tid;
        const int j = Lp - 1 - r;
        const bool live = r < Lp;
        int d_r = 0, u_r = 0, Gj = 0, x = INT_MIN;
        if (live) {
          d_r = (j + 1 < Lp ? Ar[j + 1] : NEG) + sub_row[rev_at(j)];
          u_r = Ar[j] + gap_i;
          const int ach = j == L - 1 ? (mode8 ? u_r : 0) : (j < L ? max(d_r, u_r) : NEG);
          Gj = Gs[j];
          x = ach - Gj;
        }
        const int rep_row = Gj + tile_prefix_max(x, s_warp, ccarry);
        const bool dD = live && rep_row == d_r;
        const bool dU = live && !dD && rep_row == u_r;
        const int kr = tile_prefix_max(live && (dD || dU || j == L - 1) ? r : -1, s_warp, kcarry);
        if (live) {
          kg[j] = kr < 0 ? -1 : Lp - 1 - kr;
          fg[j] = dD;
        }
      }
    }
    __syncthreads();

    // 2. every lane of the row: replay its group's moves from its own
    //    source plane; 0 off-path, for constant-0 lanes, at column 0 and
    //    past the read
    const int* ps = pslot + (size_t)i * P;
    const int* qs = qsrc + (size_t)i * P;
    for (int q = 0; q < P; ++q) {
      const int g = ps[q];
      int* out = Ab + (size_t)q * plane + (size_t)i * Lp;
      if (g < 0) {
        for (int j = tid; j < Lp; j += T) out[j] = 0;
        continue;
      }
      const int* Aq = Ab + (size_t)qs[q] * plane + (size_t)gp[g] * Lp;
      const int* kg = kidx + (size_t)g * Lp;
      const int* fg = flag + (size_t)g * Lp;
      for (int j = tid; j < Lp; j += T) {
        if (j == 0 || j >= L) {
          out[j] = 0;
          continue;
        }
        const int k = kg[j];
        int v;
        if (k == L - 1) {
          v = mode8 ? Aq[L - 1] + gap_i : 0;
        } else if (fg[k]) {
          v = Aq[k + 1] + sub_row[rev_at(k)];
        } else {
          v = Aq[k] + gap_i;
        }
        out[j] = v + Gs[j] - Gs[k];
      }
    }
    // publishes row i before row i - 1 and frees the group scratch
    __syncthreads();
  }

  // row n-1: only the alpha (path 0) plane keeps the chain
  for (int q = 1; q < P; ++q) {
    int* rl = Ab + (size_t)q * plane + (size_t)(n - 1) * Lp;
    for (int j = tid; j < Lp; j += T) rl[j] = 0;
  }
}

}  // namespace rgt

extern "C" int rgt_pathwise_rev_fill(
    const int* seq, const int* L, const int* table, const int* codes, const int* grep,
    const int* gpred, const int* pslot, const int* qsrc, int B, int n, int P, int Lp,
    int Gd, int mode8, int* Gs, int* kidx, int* flag, int* A, void* stream) {
  if (B < 1 || n < 3 || P < 1 || Lp < 1 || Gd < 1) return (int)cudaErrorInvalidValue;
  rgt::pathwise_rev_kernel<<<B, rgt::block_threads(Lp), 0, (cudaStream_t)stream>>>(
      seq, L, table, codes, grep, gpred, pslot, qsrc, n, P, Lp, Gd, mode8, Gs, kidx, flag, A);
  return (int)cudaGetLastError();
}
