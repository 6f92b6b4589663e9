// Mode-2 affine-gap banded global POA fill with windowed rows
// (gap_global_abpoa.rs:11-250) for Hopper: the body of K6
// (poa_gap_global_win.cu).  K4, the full-width fill, had this body until
// it was redesigned (poa_gap_global.cu).
//
// Computes what poa_gap_engine._fill_gap_global_windowed
// (recgraph_tpu/ops/poa_gap_engine.py:269-475) computes, bit for bit, for
// every sign of the penalties o, e: the adaptive band of mode 0; Y
// candidates as the first best over covering predecessors of m[p][j] + o
// and of y[p][j], Y taken only when strictly better; D candidates as in
// mode 0; the in-row (M, X) recurrence as a 2-state (max,+) affine scan
// clamped to NEG (_affine_row_scan, :53-81); the D/L/U cascade with its
// out-of-range 'u' code when u_pred == 0 (:143-195); and three packed
// planes (M directions, X chain, Y chain).  Row i stores W columns from
// ws_i, as in poa_global.cuh.
//
// Design: one thread block per read, columns in tiles of blockDim.x;
// the affine scan is a block scan over 2x2 (max,+) maps whose state at
// a tile's last column is carried into the next tile.  The m and y rows
// of the predecessors live in device-memory scratch (no span gate).
//
// What bounds it on this card: as K1, the per-row chain of block
// barriers; the 2x2 map scan moves six words per shuffle step.  It
// writes 12 bytes per stored cell of planes plus 8 of m/y scratch.
//
// The kernel allocates nothing, does not synchronise with the host and
// runs on the stream it is given.
#pragma once

#include "poa_common.cuh"

namespace rgt {

__global__ void __launch_bounds__(MAX_THREADS, 1)
poa_gap_global_win_kernel(const int* __restrict__ seq, const int* __restrict__ L_,
                      const int* __restrict__ bta_, const int* __restrict__ table,
                      const int* __restrict__ codes, const int* __restrict__ pred_idx,
                      const int* __restrict__ min_pred, const int* __restrict__ r_values,
                      const int* __restrict__ cand, int n_cand, int n, int Pm, int Lp,
                      int W, int o, int e, int* __restrict__ m, int* __restrict__ y,
                      int* __restrict__ bsp, int* __restrict__ score,
                      int* __restrict__ last_row, int* __restrict__ last_col,
                      int* __restrict__ packed, int* __restrict__ packed_x,
                      int* __restrict__ packed_y, int* __restrict__ lefts,
                      int* __restrict__ rights, int* __restrict__ wss,
                      bool* __restrict__ over) {
  __shared__ int s_table[NCODE * NCODE];
  __shared__ int s_m[MAX_THREADS];
  __shared__ int s_x[MAX_THREADS];
  __shared__ Affine s_aff[32];
  __shared__ long long s_key[32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int ntiles = (W + blockDim.x - 1) / blockDim.x;
  const int oe = o + e;
  for (int t = tid; t < NCODE * NCODE; t += blockDim.x) s_table[t] = table[t];
  __syncthreads();

  const int L = L_[b];
  const int bta = bta_[b];
  const int* sb = seq + (size_t)b * Lp;
  const size_t plane = (size_t)b * n * W;
  int* mb = m + plane;
  int* yb = y + plane;
  int* pb = packed + plane;
  int* pxb = packed_x + plane;
  int* pyb = packed_y + plane;
  int* lb = lefts + (size_t)b * n;
  int* rb = rights + (size_t)b * n;
  int* bb = bsp + (size_t)b * n;
  int* wb = wss + (size_t)b * n;
  bool ovf = false;

  for (int i = 0; i < n - 1; ++i) {
    const int code = codes[i];
    const int minp = min_pred[i];
    const int r = r_values[i];
    const int* pi = pred_idx + (size_t)i * Pm;

    // adaptive band (same as mode 0)
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
    const int ws = left / 8 * 8;
    if (right - ws > W) ovf = true;
    // band-start state (":55-58" j==0 && left==0; ":104-107" fallback)
    const int x_left = left == 0 ? o + e * (minp + 1) : 2 * o + e * (minp + 1) + e * left;

    int c_m = NEG, c_x = NEG;      // scan state carried across tiles
    int nb_m = NEG, nb_x = NEG;    // left neighbours carried across tiles
    long long best = LLONG_MIN;
    for (int t = 0; t < ntiles; ++t) {
      const int k = tid + t * blockDim.x;
      const bool live = k < W;
      const int j = ws + k;  // absolute column
      const bool in_band = live && left <= j && j < right;
      const bool is_left = j == left;
      const int sj = live ? sb[min(j, Lp - 1)] : GAP;
      int mrow, cell = 0, cell_x = 0, cell_y = 0;

      if (i == 0) {
        // row 0 (":60-66"): y[j] = m[j] = o + e*j, x untouched
        mrow = in_band ? (j == 0 ? 0 : o + e * j) : NEG;
        if (in_band) cell = j == 0 ? DIR_O : DIR_L;
        if (live) yb[(size_t)i * W + k] = mrow;
      } else {
        // Y and D candidates: first best over the predecessors in order
        int um_best = NEG, um_idx = 0, uy_best = NEG, uy_idx = 0;
        int d_best = NEG, d_idx = 0;
        if (live) {
          for (int q = 0; q < Pm; ++q) {
            const int p = pi[q];
            if (p < 0) continue;
            const int lp = lb[p], rp = rb[p];
            const int idx = j - wb[p];  // lane of column j in p's window
            const size_t row_p = (size_t)p * W;
            if (lp <= j && j < rp && idx >= 0 && idx < W) {
              const int vm = mb[row_p + idx], vy = yb[row_p + idx];
              if (vm > um_best) { um_best = vm; um_idx = p; }
              if (vy > uy_best) { uy_best = vy; uy_idx = p; }
            }
            if (lp < j && j <= rp && idx >= 1 && idx <= W) {
              const int v = mb[row_p + idx - 1];
              if (v > d_best) { d_best = v; d_idx = p; }
            }
          }
        }
        const bool covered = um_best > NEG / 2;
        const int umo = um_best + o;
        const bool from_y = uy_best > umo;  // strict (":328")
        int yrow = covered ? max(umo, uy_best) + e : 2 * o + e * (minp + 1) + e * j;
        const int u_pred = covered ? (from_y ? uy_idx : um_idx) : minp;
        const bool has_d = d_best > NEG / 2;
        const int d_val = d_best + s_table[code * NCODE + sj];
        const int c = has_d ? max(d_val, yrow) : yrow;

        // the in-row (M, X) affine scan
        Affine el;
        if (!in_band) {
          el = Affine{0, NEG, NEG, 0, NEG, NEG};
        } else if (is_left) {
          el = Affine{NEG, NEG, NEG, NEG, left == 0 ? x_left : max(c, x_left), x_left};
        } else {
          el = Affine{oe, e, oe, e, c, NEG};
        }
        Affine tot;
        const Affine pre = block_scan(el, s_aff, tot, affine_op);
        int vm = pre.b0, vx = pre.b1;
        if (t > 0) {
          vm = c_m;
          vx = c_x;
          affine_apply(pre, vm, vx);
          affine_apply(tot, c_m, c_x);
        } else {
          c_m = tot.b0;
          c_x = tot.b1;
        }
        mrow = in_band ? vm : NEG;
        yrow = in_band ? yrow : NEG;

        // path_x plane (":99-120": 'X' iff x[j-1] > m[j-1] + o, j_rel > 0)
        const int m_prev = left_neighbour(mrow, nb_m, s_m);
        const int x_prev = left_neighbour(vx, nb_x, s_x);
        const bool stay_x = x_prev > m_prev + o && !is_left;

        // M directions: the mode-2 cascade (":143-195")
        const int l_pred = is_left ? minp : i;
        const bool l_lt_u = vx < yrow;
        int dcode, psel;
        if (is_left && left == 0) {
          dcode = DIR_U;  // base case
          psel = minp;
        } else if (!has_d) {  // (":372-378"): l < u => U else L
          dcode = l_lt_u ? DIR_U : DIR_L;
          psel = l_lt_u ? u_pred : l_pred;
        } else if (d_val < vx) {
          dcode = l_lt_u ? (u_pred == 0 ? DIR_LOW_U : DIR_U) : DIR_L;
          psel = l_lt_u ? u_pred : l_pred;
        } else if (d_val < yrow) {
          dcode = DIR_U;
          psel = u_pred;
        } else {
          dcode = sj == code ? DIR_D : DIR_LOW_D;
          psel = d_idx;
        }
        if (in_band) {
          cell = psel * 16 + dcode;
          if (stay_x) cell_x = i * 16 + DIR_X;
          if (covered && from_y) cell_y = uy_idx * 16 + DIR_Y;
        }
        if (live) yb[(size_t)i * W + k] = yrow;
      }

      if (live) {
        const long long key = make_key(mrow, (unsigned)k);
        best = key > best ? key : best;
        mb[(size_t)i * W + k] = mrow;
        pb[(size_t)i * W + k] = cell;
        pxb[(size_t)i * W + k] = cell_x;
        pyb[(size_t)i * W + k] = cell_y;
      }
    }
    best = block_max_key(best, s_key);
    if (tid == 0) {
      lb[i] = left;
      rb[i] = right;
      wb[i] = ws;
      bb[i] = ws + (int)key_tie(best);
    }
    __syncthreads();
  }

  for (int k = tid; k < W; k += blockDim.x) {
    const size_t at = (size_t)(n - 1) * W + k;
    pb[at] = 0;
    pxb[at] = 0;
    pyb[at] = 0;
  }
  if (tid == 0) {
    lb[n - 1] = 0;
    rb[n - 1] = 0;
    wb[n - 1] = 0;
    int bv = 0, br = 0, bc = 0;
    for (int q = 0; q < n_cand; ++q) {
      const int c = cand[q];
      const int col = rb[c] - 1;
      const int v = mb[(size_t)c * W + min(max(col - wb[c], 0), W - 1)];
      if (q == 0 || v > bv) { bv = v; br = c; bc = col; }
    }
    score[b] = bv;
    last_row[b] = br;
    last_col[b] = bc;
    over[b] = ovf;
  }
}

}  // namespace rgt
