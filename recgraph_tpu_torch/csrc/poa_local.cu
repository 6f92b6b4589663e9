// Mode-1 local POA fill (local_poa.rs:181-255) for Hopper.
//
// Replaces the TPU kernel recgraph_tpu/ops/pallas_poa_v5.py:251
// fill_local_v5 and computes what poa_engine._fill_local
// (recgraph_tpu/ops/poa_engine.py:553-643) computes, bit for bit: the
// transposed scoring table (sm(seq[j], lnz[i])), the zero floor, the
// start-row first-best sweep that begins at 0 / index 0, tie order
// D >= U >= L with all-negative cells as O, and the row-major running
// best that moves on a strictly greater row maximum (first column).
//
// Design: one thread block per read; the row's columns are tiles of
// blockDim.x (poa_common.cuh), so a read of any length fits.  The in-row
// chain m[j] = max(A[j], m[j-1] + g[j]) is a block scan over (g, A)
// pairs carried across tiles, and each row's best is a block max over
// (value, first column) keys.  Predecessor rows are read back from a
// device-memory score scratch the wrapper allocates, so any predecessor
// span works without a gate.
//
// What bounds it on this card: one block is latency-bound on its
// per-row __syncthreads (scan, neighbour exchange, row best);
// throughput comes from many reads (blocks) per SM.  It writes 4 bytes
// per cell of packed output and 4 bytes per cell of score scratch.
// Later levers: a shared-memory ring of predecessor rows indexed by end
// rank, fewer barriers per row.
//
// The kernel allocates nothing, does not synchronise with the host and
// runs on the stream it is given.

#include "poa_common.cuh"

namespace rgt {

__global__ void __launch_bounds__(MAX_THREADS, 1)
poa_local_kernel(const int* __restrict__ seq, const int* __restrict__ L_,
                 const int* __restrict__ table, const int* __restrict__ codes,
                 const int* __restrict__ node_start, const int* __restrict__ pred_idx,
                 int n, int Pm, int Lp, int* __restrict__ m,
                 int* __restrict__ best_val, int* __restrict__ best_i,
                 int* __restrict__ best_j, int* __restrict__ packed) {
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
  int* mb = m + (size_t)b * n * Lp;
  int* pb = packed + (size_t)b * n * Lp;
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
          const int u = p >= 0 ? mb[(size_t)p * Lp + j] : NEG;
          const int d = (p >= 0 && j > 0) ? mb[(size_t)p * Lp + j - 1] : NEG;
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
        pb[(size_t)i * Lp + j] = cell;
        mb[(size_t)i * Lp + j] = mrow;
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

  for (int j = tid; j < Lp; j += blockDim.x) pb[(size_t)(n - 1) * Lp + j] = 0;
  if (tid == 0) {
    best_val[b] = bv;
    best_i[b] = bi;
    best_j[b] = bjj;
  }
}

}  // namespace rgt

extern "C" int rgt_poa_local_fill(
    const int* seq, const int* L, const int* table, const int* codes,
    const int* node_start, const int* pred_idx, int B, int n, int Pm, int Lp,
    int* m, int* best_val, int* best_i, int* best_j, int* packed,
    void* stream) {
  if (B < 1 || n < 3 || Pm < 1 || Lp < 1) return (int)cudaErrorInvalidValue;
  rgt::poa_local_kernel<<<B, rgt::block_threads(Lp), 0, (cudaStream_t)stream>>>(
      seq, L, table, codes, node_start, pred_idx, n, Pm, Lp, m, best_val,
      best_i, best_j, packed);
  return (int)cudaGetLastError();
}
