// Mode-0 banded global POA fill (global_abpoa.rs:260-427) in a tiled
// design: the body of K3, windowed (poa_global_win.cu, kWin = true), and
// of K14, the v1 TPU layout at full width (poa_global_v1.cu, kV1 = true).
// K1 is poa_global.cu.
//
// Computes what poa_engine._fill_global (recgraph_tpu/ops/poa_engine.py:
// 149-297) and _fill_global_windowed (:300-480) compute, bit for bit:
// adaptive band from the predecessors' best columns (utils.rs:17-72),
// first-best U/D over predecessors in ascending order, the in-row
// (max,+) chain, packed pred*16+dir cells with tie order D >= U >= L,
// and the first-strict-max sink pick.  Row i stores W columns starting
// at ws_i: ws_i = 0 and W = Lp at full width; ws_i = (left // 8) * 8
// per read when windowed, with predecessor windows realigned by
// ws_i - ws_p and cells outside a window read as NEG.  A windowed read
// whose band outgrows its window sets over[b].
//
// Design: one thread block per read; the columns of a row are tiles of
// blockDim.x (poa_common.cuh), so any W fits.  The in-row dependency
// m[j] = max(A[j], m[j-1] + g[j]) is a block scan over (g, A) pairs,
// the left neighbour m[j-1] for the directions comes through shared
// memory, and the rightmost in-band argmax is a block max over
// (value, column) keys.  Predecessor rows, band bounds, window starts
// and best columns live in device-memory scratch the wrapper allocates,
// so any predecessor span works without a gate.
//
// Layouts: K3 stores packed [B, n, W] and lefts / rights [B, n].
// With kV1 (K14, W = Lp) the kernel writes the v1 TPU layout itself:
// packed [n, B, W + 8], with each row's band bounds in lanes W and
// W + 1 (which the kernel also reads back as its band history), lanes
// W + 2 .. W + 7 zero; lefts and rights are unused.  The layout is a
// template flag, so K3's address arithmetic is what it was.
//
// What bounds it on this card: each row is a chain of dependent steps
// separated by block barriers (scan, neighbour exchange, argmax, the
// row's visibility to the next row), so one block is latency-bound on
// its per-row __syncthreads; throughput comes from many reads (blocks)
// per SM.  Memory traffic is 4 bytes per stored cell of packed output
// plus 4 of score scratch, and the predecessors' cells read back (mostly
// from L2).  Later levers: a shared-memory ring of predecessor rows
// indexed by end rank, fewer barriers per row, a per-row window width.
//
// The kernel allocates nothing, does not synchronise with the host and
// runs on the stream it is given.
#pragma once

#include "poa_common.cuh"

namespace rgt {
namespace {  // internal linkage: each .cu that launches it has its own copy

template <bool kWin, bool kV1 = false>
__global__ void __launch_bounds__(MAX_THREADS, 1)
poa_global_kernel(const int* __restrict__ seq, const int* __restrict__ L_,
                  const int* __restrict__ bta_, const int* __restrict__ table,
                  const int* __restrict__ codes, const int* __restrict__ pred_idx,
                  const int* __restrict__ min_pred, const int* __restrict__ r_values,
                  const int* __restrict__ cand, int n_cand, int n, int Pm, int Lp,
                  int W, int* __restrict__ m, int* __restrict__ bsp,
                  int* __restrict__ score, int* __restrict__ last_row,
                  int* __restrict__ last_col, int* __restrict__ packed,
                  int* __restrict__ lefts, int* __restrict__ rights,
                  int* __restrict__ wss, bool* __restrict__ over) {
  __shared__ int s_table[NCODE * NCODE];
  __shared__ int s_row[MAX_THREADS];
  __shared__ Chain s_chain[32];
  __shared__ long long s_key[32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int ntiles = (W + blockDim.x - 1) / blockDim.x;
  for (int t = tid; t < NCODE * NCODE; t += blockDim.x) s_table[t] = table[t];
  __syncthreads();

  const int L = L_[b];
  const int bta = bta_[b];
  const int* sb = seq + (size_t)b * Lp;
  int* mb = m + (size_t)b * n * W;
  // kV1: rows of B * (W + 8) ints, read b at lane offset b * (W + 8)
  const size_t row = kV1 ? (size_t)gridDim.x * (W + 8) : (size_t)W;
  int* pb = packed + (kV1 ? (size_t)b * (W + 8) : (size_t)b * n * W);
  int* lb_ = kV1 ? pb + W : lefts + (size_t)b * n;
  int* rb_ = kV1 ? pb + W + 1 : rights + (size_t)b * n;
  const size_t band_row = kV1 ? row : 1;
  auto lb = [&](int r) -> int& { return kV1 ? lb_[r * band_row] : lb_[r]; };
  auto rb = [&](int r) -> int& { return kV1 ? rb_[r * band_row] : rb_[r]; };
  int* bb = bsp + (size_t)b * n;
  int* wb = wss + (size_t)b * n;
  bool ovf = false;

  for (int i = 0; i < n - 1; ++i) {
    const int code = codes[i];
    const int minp = min_pred[i];
    const int r = r_values[i];
    const int* pi = pred_idx + (size_t)i * Pm;
    const int gnode = s_table[code * NCODE + GAP];

    // adaptive band from the predecessors' best columns
    int ms = 0, me = 0;
    if (i > 0) {
      int lo = 1 << 28, hi = NEG;
      for (int k = 0; k < Pm; ++k) {
        const int p = pi[k];
        if (p < 0) continue;
        lo = min(lo, bb[p]);
        hi = max(hi, bb[p]);
      }
      ms = lo + 1;
      me = hi + 1;
    }
    const int left = max(0, min(ms, L - r - bta));
    const int right = L > r ? min(L, max(me, L - r) + bta) : min(L, me + bta);
    const int ws = kWin ? left / 8 * 8 : 0;
    if (kWin && right - ws > W) ovf = true;
    // j == 0 / left > 0 fallback (":85") and the left == 0 base case
    // (":74-77"), used at column `left` only
    const int l_fb = s_table[sb[min(left, Lp - 1)] * NCODE + GAP] * (i + left);
    int base0 = 0;
    if (i > 0 && left == 0) {
      const int lm = min(max(lb(minp) - wb[minp], 0), W - 1);
      base0 = mb[(size_t)minp * W + lm] + gnode;
    }

    int scan_carry = NEG, nb_carry = NEG;
    long long best = LLONG_MIN;
    for (int t = 0; t < ntiles; ++t) {
      const int k = tid + t * blockDim.x;
      const bool live = k < W;
      const int j = ws + k;  // absolute column
      const bool in_band = live && left <= j && j < right;
      const bool is_left = j == left;
      const int sj = live ? sb[min(j, Lp - 1)] : GAP;
      const int gseq = s_table[sj * NCODE + GAP];  // sm(seq[j], '-')

      // U / D candidates: first best over predecessors in ascending order
      int u_best = NEG, u_pred = 0, d_best = NEG, d_pred = 0;
      if (live && i > 0) {
        for (int q = 0; q < Pm; ++q) {
          const int p = pi[q];
          if (p < 0) continue;
          const int lp = lb(p), rp = rb(p);
          const int idx = j - wb[p];  // lane of column j in p's window
          const int* mp = mb + (size_t)p * W;
          if (lp <= j && j < rp && idx >= 0 && idx < W) {
            const int v = mp[idx];
            if (v > u_best) { u_best = v; u_pred = p; }
          }
          if (lp < j && j <= rp && idx >= 1 && idx <= W) {
            const int v = mp[idx - 1];
            if (v > d_best) { d_best = v; d_pred = p; }
          }
        }
      }
      const bool has_u = u_best > NEG / 2;
      const int u_val = has_u ? u_best + gnode : gnode * (i + j);
      if (!has_u) u_pred = minp;
      const bool has_d = d_best > NEG / 2;
      const int d_val = has_d ? d_best + s_table[code * NCODE + sj] : gnode * (i + left);
      if (!has_d) d_pred = minp;

      // chain restart values and the (max,+) scan
      int A = max(d_val, u_val);
      if (i == 0) {
        A = j == 0 ? 0 : NEG;
      } else if (is_left) {
        A = left == 0 ? base0 : max(A, l_fb);
      }
      if (!in_band) A = NEG;
      const int g = i == 0 ? s_table[GAP * NCODE + sj] : gseq;
      Chain tot;
      const Chain c = block_scan(Chain{live ? g : 0, A}, s_chain, tot, chain_op);
      const int mscan = t == 0 ? c.v : max(scan_carry + c.s, c.v);
      scan_carry = t == 0 ? tot.v : max(scan_carry + tot.s, tot.v);
      const int mrow = in_band ? mscan : NEG;

      // rightmost in-band argmax -> best scoring column of this row
      if (live) {
        const long long key = make_key(mrow, (unsigned)k);
        best = key > best ? key : best;
      }

      const int m_left = left_neighbour(mrow, nb_carry, s_row);
      if (live) {
        int l_val = m_left + gseq;  // NEG left of the first stored column
        if (is_left) l_val = left == 0 ? NEG : l_fb;
        int dcode, psel;
        if (i == 0) {
          dcode = j == 0 ? DIR_O : DIR_L;
          psel = 0;
        } else if (is_left && left == 0) {
          dcode = DIR_U;  // base case (global_abpoa.rs:74-77)
          psel = minp;
        } else {
          const bool d_ge_u = d_val >= u_val;
          if (d_ge_u && d_val >= l_val) {
            dcode = sj == code ? DIR_D : DIR_LOW_D;
            psel = d_pred;
          } else if (!d_ge_u && u_val >= l_val) {
            dcode = DIR_U;
            psel = u_pred;
          } else {
            dcode = DIR_L;
            psel = j > left ? i : minp;
          }
        }
        pb[i * row + k] = in_band ? psel * 16 + dcode : 0;
        mb[(size_t)i * W + k] = mrow;
      }
    }
    best = block_max_key(best, s_key);
    if (tid == 0) {
      lb(i) = left;
      rb(i) = right;
      wb[i] = ws;
      bb[i] = ws + (int)key_tie(best);
    }
    __syncthreads();
  }

  // row n-1 (the sink F) is never filled
  for (int k = tid; k < W; k += blockDim.x) pb[(n - 1) * row + k] = 0;
  if (kV1)  // lanes W + 2 .. W + 7 of every row
    for (int i = 0; i < n; ++i)
      for (int k = W + 2 + tid; k < W + 8; k += blockDim.x) pb[i * row + k] = 0;
  if (tid == 0) {
    lb(n - 1) = 0;
    rb(n - 1) = 0;
    wb[n - 1] = 0;
    // best over F's predecessors, first strict max, row n-2 seeded;
    // rights >= 1, so right - 1 lies in the row
    int bv = 0, br = 0, bc = 0;
    for (int q = 0; q < n_cand; ++q) {
      const int c = cand[q];
      const int col = rb(c) - 1;
      const int v = mb[(size_t)c * W + min(max(col - wb[c], 0), W - 1)];
      if (q == 0 || v > bv) { bv = v; br = c; bc = col; }
    }
    score[b] = bv;
    last_row[b] = br;
    last_col[b] = bc;
    if (kWin) over[b] = ovf;
  }
}

}  // namespace
}  // namespace rgt
