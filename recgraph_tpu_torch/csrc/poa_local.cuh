// Mode-1 local POA fill (local_poa.rs:181-255) for Hopper: the kernel
// body of two superseded TPU layouts of the function
// (poa_local_variants.cu: K16, K17).  K2, the main path's mode-1 fill,
// has its own kernel since it was redesigned (poa_local.cu), and K13 and
// K15 are forms of it; this body was K2's before that.
//
// Computes what poa_engine._fill_local
// (recgraph_tpu/ops/poa_engine.py:553-643) computes, bit for bit: the
// transposed scoring table (sm(seq[j], lnz[i])), the zero floor, the
// start-row first-best sweep that begins at 0 / index 0, tie order
// D >= U >= L with all-negative cells as O, and the row-major running
// best that moves on a strictly greater row maximum (first column).
//
// Each TPU kernel's layout is written by the kernel itself: the TPU
// layouts are [n_store, B, Lp], of element type PT, and rows [n-1,
// n_store) of the output plane are zeroed.  The score plane m (int32,
// the row history) is a [B, n, Lp] scratch, except with kScoresOnly
// (K16), where m in the rows-first layout is the output and no packed
// plane is written.

// Design: one thread block per read; the row's columns are tiles of
// blockDim.x (poa_common.cuh), so a read of any length fits.  The in-row
// chain m[j] = max(A[j], m[j-1] + g[j]) is a block scan over (g, A)
// pairs carried across tiles, and each row's best is a block max over
// (value, first column) keys.  Predecessor rows are read back from m in
// device memory, so any predecessor span works without a gate.
//
// What bounds it on this card: one block is latency-bound on its
// per-row __syncthreads (scan, neighbour exchange, row best);
// throughput comes from many reads (blocks) per SM.  It writes
// sizeof(PT) bytes per cell of packed output and 4 bytes per cell of m.
// Later levers: a shared-memory ring of predecessor rows indexed by end
// rank, fewer barriers per row.
//
// The kernel allocates nothing, does not synchronise with the host and
// runs on the stream it is given.
#pragma once

#include "poa_common.cuh"

namespace rgt {
namespace {  // internal linkage: each .cu that launches it has its own copy

template <typename PT, bool kScoresOnly>
__global__ void __launch_bounds__(MAX_THREADS, 1)
poa_local_kernel(const int* __restrict__ seq, const int* __restrict__ L_,
                 const int* __restrict__ table, const int* __restrict__ codes,
                 const int* __restrict__ node_start, const int* __restrict__ pred_idx,
                 int n, int Pm, int Lp, int* __restrict__ m, PT* __restrict__ packed,
                 int n_store, int* __restrict__ best_val, int* __restrict__ best_i,
                 int* __restrict__ best_j) {
  __shared__ int s_table[NCODE * NCODE];
  __shared__ int s_row[MAX_THREADS];
  __shared__ Chain s_chain[32];
  __shared__ long long s_key[32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int ntiles = (Lp + blockDim.x - 1) / blockDim.x;
  for (int t = tid; t < NCODE * NCODE; t += blockDim.x) s_table[t] = table[t];
  __syncthreads();

  const int L = L_[b];
  const int* sb = seq + (size_t)b * Lp;
  // rows-first planes: rows of B * Lp, read b at lane offset b * Lp
  const size_t rows_first = (size_t)gridDim.x * Lp;
  const size_t m_row = kScoresOnly ? rows_first : (size_t)Lp;
  const size_t pk_row = rows_first;
  int* mb = m + (kScoresOnly ? (size_t)b * Lp : (size_t)b * n * Lp);
  PT* pb = kScoresOnly ? nullptr : packed + (size_t)b * Lp;
  int bv = 0, bi = 0, bjj = 0;  // running best (thread 0)

  for (int i = 0; i < n - 1; ++i) {
    const int code = codes[i];
    const bool is_start = node_start[i] != 0;
    const int* pi = pred_idx + (size_t)i * Pm;
    const int gnode = s_table[GAP * NCODE + code];  // transposed: sm('-', lnz[i])

    int scan_carry = NEG, nb_carry = NEG;
    long long best = LLONG_MIN;
    for (int t = 0; t < ntiles; ++t) {
      const int j = tid + t * blockDim.x;
      const bool live = j < Lp;
      const bool valid = live && j < L;
      const int sj = live ? sb[j] : GAP;
      const int gseq = s_table[sj * NCODE + GAP];     // sm(seq[j], '-')
      const int sub = s_table[sj * NCODE + code];     // transposed: sm(seq[j], lnz[i])

      // first best over the predecessor slots in order; padding slots
      // count as NEG at index 0, as the reference engine's argmax sees them
      int u_pre = NEG, u_arg = 0, d_pre = NEG, d_arg = 0;
      if (live) {
        for (int k = 0; k < Pm; ++k) {
          const int p = pi[k];
          const int ps = p < 0 ? 0 : p;
          const int u = p >= 0 ? mb[p * m_row + j] : NEG;
          const int d = (p >= 0 && j > 0) ? mb[p * m_row + j - 1] : NEG;
          if (k == 0 || u > u_pre) { u_pre = u; u_arg = ps; }
          if (k == 0 || d > d_pre) { d_pre = d; d_arg = ps; }
        }
      }
      const int d_val = (is_start ? max(d_pre, 0) : d_pre) + sub;
      const int d_idx = is_start ? (d_pre > 0 ? d_arg : 0) : i - 1;
      const int u_val = (is_start ? max(u_pre, 0) : u_pre) + gnode;
      const int u_idx = is_start ? (u_pre > 0 ? u_arg : 0) : i - 1;

      int A = max(max(d_val, u_val), 0);
      if (j == 0 || i == 0) A = 0;
      Chain tot;
      const Chain c = block_scan(Chain{live ? gseq : 0, A}, s_chain, tot, chain_op);
      const int mscan = t == 0 ? c.v : max(scan_carry + c.s, c.v);
      scan_carry = t == 0 ? tot.v : max(scan_carry + tot.s, tot.v);
      int mrow = valid ? mscan : NEG;
      if (i == 0 || j == 0) mrow = 0;

      const int m_left = left_neighbour(mrow, nb_carry, s_row);
      if (live) {
        const int l_val = m_left + gseq;
        int cell = 0;  // O
        const bool border = i == 0 || j == 0 || !valid;
        const bool all_neg = d_val < 0 && u_val < 0 && l_val < 0;
        if (!border && !all_neg) {
          const bool d_ge_u = d_val >= u_val;
          if (d_ge_u && d_val >= l_val) {
            cell = d_idx * 16 + (sj == code ? DIR_D : DIR_LOW_D);
          } else if (!d_ge_u && u_val >= l_val) {
            cell = u_idx * 16 + DIR_U;
          } else {
            cell = i * 16 + DIR_L;
          }
        }
        if (!kScoresOnly) pb[i * pk_row + j] = (PT)cell;
        mb[i * m_row + j] = mrow;
        const long long key = make_key(valid ? mrow : NEG, 0x7fffffffu - (unsigned)j);
        best = key > best ? key : best;
      }
    }

    // row maximum, first column; the barriers inside also publish this
    // row's scratch before the next row
    best = block_max_key(best, s_key);
    if (tid == 0) {
      const int rmax = key_value(best);
      if (rmax > bv) {
        bv = rmax;
        bi = i;
        bjj = (int)(0x7fffffffu - key_tie(best));
      }
    }
  }

  // rows past n-2 of the output plane are never filled
  for (int i = n - 1; i < n_store; ++i) {
    for (int j = tid; j < Lp; j += blockDim.x) {
      if (kScoresOnly) {
        mb[i * m_row + j] = 0;
      } else {
        pb[i * pk_row + j] = 0;
      }
    }
  }
  if (tid == 0) {
    best_val[b] = bv;
    best_i[b] = bi;
    best_j[b] = bjj;
  }
}

}  // namespace
}  // namespace rgt
