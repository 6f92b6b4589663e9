// Mode-2 affine-gap banded global POA fill (gap_global_abpoa.rs:11-250)
// for Hopper: at full width (K4) and with windowed rows for long reads
// (K6), one kernel body, WIN a compile-time form.
//
// K4 replaces the TPU kernel recgraph_tpu/ops/pallas_gap_global.py:415
// fill_gap_global_v2 and computes what poa_gap_engine._fill_gap_global
// (recgraph_tpu/ops/poa_gap_engine.py:89-268) computes; K6 replaces
// recgraph_tpu/ops/pallas_gap_global_win.py:413 fill_gap_global_win with
// the per-read window starts of poa_gap_engine._fill_gap_global_windowed
// (:269-475).  Bit for bit, for every sign of the penalties o, e: the
// adaptive band of mode 0 (from the predecessors' best columns, the last
// column at a row's maximum); Y candidates as the first best over covering
// predecessors (slot order) of m[p][j] + o and of y[p][j], Y taken only
// when strictly better, the uncovered Y 2o + e(minp + 1) + ej; D
// candidates as in mode 0; the in-row (M, X) recurrence from the band's
// left state x_left; the D/L/U cascade with its out-of-range 'u' code when
// u_pred == 0 (:143-195); three packed planes (M directions, X chain, Y
// chain), zero outside the band and on row n-1; and the sink candidates'
// sweep.
//
// The window (WIN).  Row i stores W columns from ws_i = (left_i / 8) * 8;
// at full width ws_i = 0 and W = Lp.  A predecessor p is read at column
// j - ws_p, NEG outside its window; a read whose band passes ws_i + W sets
// over[b] and the row keeps what fits.  Every column below is absolute
// (j = ws_i + k for the row's k-th stored column), so the chain, the band
// and the cascade are K4's.
//
// The in-row recurrence.  In the band [left, right), with
// g = max(o + e, e), x[left] = x_left and x[j+1] = max(x[j] + g,
// c~[j] + o + e) (c~[left] = -inf where left = 0, else c~ = c), so
//
//     x[j] = j g + max(x_left - left g, max_{left <= k < j} w[k]),
//     w[k] = c~[k] + o + e - (k + 1) g,
//
// a prefix maximum (poa_gap_engine.x_chain_band_plain).  The reference's
// 2x2 map scan clamps to NEG; every value of the row and every term of
// the chain stays within (|o| + |e|) (2n + 2Lp + 2) of 0 (m >= y, and y
// is at least the uncovered Y or a predecessor's m + o + e), so below
// 2^26 the clamp never acts and the prefix maximum stays in int32
// (cuda_poa_gap_global.check_chain_range).  Past that the clamped form
// (CLAMP) composes the maps x -> max(x + g, b) with the reference's clamp,
// as K5's does (poa_gap_local.cu); a run's A is the steps of its columns
// from `left` on.  The band's start lies in its row's window, so both
// forms run from `left` in either layout.
//
// Design (K5's, poa_gap_local.cu; one form a launch, plan() in
// cuda_poa_gap_local.py, over W columns for K6):
// - A read runs on one block of w warps (w = 1 for rows up to 224
//   columns), each lane holding CW = 1, 3, 5 or 7 contiguous columns in
//   registers.  A row is a pass that computes each column's D and Y
//   candidates and its chain input c, a warp scan (plus, for w > 1, the
//   warp totals through shared memory and a block barrier), and a pass
//   that applies the carry to the lane's columns and runs the cascade.
//   The row's best column is two warp reductions (value, last column);
//   for w > 1 each warp's best goes through shared memory and a second
//   barrier, since the next row's band needs it.  No block barrier with
//   w = 1.
// - The band state stays on chip: row i-1's band and best column in
//   registers, the next row's tables (code, min_pred, r, the first two
//   slots' predecessors and scratch rows) loaded a row ahead, and the band
//   and best column of its far predecessors (slots 0 and 1) loaded during
//   this row, after its scan.  lefts, rights and the best columns are
//   written to device memory for the far predecessors and the sink sweep.
// - Row i-1's m and y stay in registers.  Only rows that some row lists
//   as a predecessor other than its row i-1 go to a device scratch
//   (store_at[row] >= 0, cuda_poa_gap_global.stored_rows); with one warp a
//   read and up to 5 columns a lane (not WIN: the next row's window is not
//   known yet) the next row's far rows (slots 0, 1) are loaded during this
//   row's second pass.
// - WIN: a row whose window moved against row i-1's (ws_i - ws_{i-1}, a
//   multiple of 8: +8 on about one row in eight of a diagonal alignment,
//   negative where a far predecessor pulls the band back, W or more after
//   a jump) first realigns row i-1's m and y from the staged copy of row
//   i-1 in shared memory (every row is staged, two buffers by row
//   parity), NEG outside row i-1's window; a row whose window did not move
//   takes the registers as they are.
// - Rows past 16 warps x 224 columns take the full form: every row's m
//   and y in the scratch, the row in windows of 16 warps x 9 columns a lane.
// - A warp stages its segment of the three planes (and m, y) in shared
//   memory, two buffers by row parity, and writes it with coalesced
//   16-byte stores (4-byte ones where the row width is not a multiple of
//   4).
//
// What bounds it on this card: the bytes of the three planes (12 a cell)
// plus 8 a cell of the stored rows; a row's latency rules as in K5 (the
// rows of a read are sequential, a row a serial chain of one warp).
//
// The kernel allocates nothing, does not synchronise with the host and
// runs on the stream it is given.

#include "poa_common.cuh"

namespace rgt {

constexpr int GG_THREADS = 512;   // threads a block at most
constexpr int GG_PLANES = 5;      // staged: packed, packed_x, packed_y, m, y
constexpr int GG_MAX_WARPS = 16;  // warps a read
// blocks an SM holds of the one-warp form: a stretch chunk of 1,241 reads
// resident on 132 SMs (204 registers a thread)
constexpr int GG_ONE_BLOCKS = 10;

struct GgArgs {
  const int* seq;        // [B, Lp]
  const int* L;          // [B]
  const int* bta;        // [B]
  const int* table;      // [7, 7]
  const int* codes;      // [n]
  const int* min_pred;   // [n]
  const int* r_values;   // [n]
  const int* pred_idx;   // [n, Pm] -1 padded
  const int* srow;       // [n, Pm] scratch row of each slot's predecessor, -1 for none
  const int* store_at;   // [n] scratch row a row is written to, -1 for none
  const int* cand;       // [n_cand] the sink candidates
  int n_cand, B, n, Pm, Lp, o, e;
  int warps;             // warps a read (a block)
  int S;                 // scratch rows a read
  int* ms;               // [B, S, W]
  int* ys;
  int* bsp;              // [B, n] each row's best column
  int* mlast;            // [B, n] each row's m at column right - 1 (clamped into the row)
  int* score;
  int* last_row;
  int* last_col;
  int* packed;           // [B, n, W]
  int* packed_x;
  int* packed_y;
  int* lefts;
  int* rights;
  int W;                 // columns a row stores (WIN; Lp at full width)
  int* wss;              // [B, n] each row's window start (WIN)
  bool* over;            // [B] a band passed its window (WIN)
};

// A column's slots and flags: the slot of the D argument, the slot of the
// U argument (Y's where Y is taken), has_d, covered, from_y.
__device__ __forceinline__ int gg_pack(int dq, int uq, bool has_d, bool covered, bool from_y) {
  return dq | uq << 12 | (int)has_d << 24 | (int)covered << 25 | (int)from_y << 26;
}

// One slot q of the first-best sweeps over the predecessors (slot order,
// strict >, from NEG): p's band [lp, rp) covers column j for the Y
// candidates, (lp, rp] for D.  vm[c + 1]: m[p][j0 + c]; vm[0]: m[p][j0 - 1].
template <int CW>
__device__ __forceinline__ void gg_slot(int q, int j0, int lp, int rp, const int (&vm)[CW + 1],
                                        const int (&vy)[CW], int (&umb)[CW], int (&uyb)[CW],
                                        int (&db)[CW], int (&uq)[CW], int (&yq)[CW],
                                        int (&dq)[CW]) {
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    const int j = j0 + c;
    if (lp <= j && j < rp) {
      if (vm[c + 1] > umb[c]) { umb[c] = vm[c + 1]; uq[c] = q; }
      if (vy[c] > uyb[c]) { uyb[c] = vy[c]; yq[c] = q; }
    }
    if (lp < j && j <= rp && vm[c] > db[c]) { db[c] = vm[c]; dq[c] = q; }
  }
}

// A stored row of the window form at its columns k0 - 1 .. k0 + CW - 1 (m)
// and k0 .. k0 + CW - 1 (y), k0 = j0 - ws_p; NEG outside its W columns.
template <int CW>
__device__ __forceinline__ void load_row_win(const int* mp, const int* yp, int k0, int W,
                                             int (&vm)[CW + 1], int (&vy)[CW]) {
  vm[0] = k0 > 0 && k0 <= W ? mp[k0 - 1] : NEG;
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    const bool live = k0 + c >= 0 && k0 + c < W;
    vm[c + 1] = live ? mp[k0 + c] : NEG;
    vy[c] = live ? yp[k0 + c] : NEG;
  }
}

// The steps of the in-band maps of columns [s0, e0): A of the run.
__device__ __forceinline__ int gg_steps(int s0, int e0, int left, int g) {
  return chain_steps(max(0, e0 - max(s0, left)), g);
}

// ONE: one warp a read, known when compiling; ALL: the full form;
// CLAMP: the clamped chain; WIN: windowed rows (K6).
template <int CW, bool ALL, bool ONE, bool CLAMP, bool WIN>
__global__ void __launch_bounds__(ONE ? 32 : GG_THREADS, ONE ? GG_ONE_BLOCKS : 1)
    poa_gap_global_kernel(const GgArgs a) {
  __shared__ int s_table[NCODE * NCODE];
  __shared__ int s_tot[2][32], s_part[2][32], s_clast[2][32];
  __shared__ long long s_best[32];
  extern __shared__ int4 s_dyn[];

  constexpr int SEG = 32 * CW;
  constexpr bool PF = ONE && CW <= 5 && !WIN;   // the next row's far rows prefetched
  const int w = ONE ? 1 : a.warps, wi = ONE ? 0 : threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  for (int t = threadIdx.x; t < NCODE * NCODE; t += blockDim.x) s_table[t] = a.table[t];
  __syncthreads();

  const int n = a.n, Lp = a.Lp, Pm = a.Pm, o = a.o, e = a.e, oe = o + e;
  const int Wd = WIN ? a.W : Lp;                    // columns a row stores
  const int g = max(oe, e);
  const int L = a.L[b], bta = a.bta[b];
  const int* sb = a.seq + (size_t)b * Lp;
  const size_t plane = (size_t)b * n * Wd;
  const size_t brow = (size_t)b * n;
  int* st2 = reinterpret_cast<int*>(s_dyn) + (size_t)wi * 2 * GG_PLANES * SEG;
  const int win = w * SEG;                          // columns a window
  const int nwin = ALL ? (Wd + win - 1) / win : 1;
  const bool vec = (Wd & 3) == 0;
  int* msb = a.ms + (size_t)b * a.S * Wd;
  int* ysb = a.ys + (size_t)b * a.S * Wd;
  // the read's codes at the lane's columns from absolute column j0 (GAP past the row)
  auto lane_codes = [&](int j0, int k0) {
    unsigned cr = 0;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      if (WIN)
        cr |= (unsigned)(k0 + c < Wd ? sb[min(j0 + c, Lp - 1)] : GAP) << (3 * c);
      else
        cr |= (unsigned)(j0 + c < Lp ? sb[j0 + c] : GAP) << (3 * c);
    }
    return cr;
  };

  // row n-1: all 0
  for (int t = 0; t < nwin; ++t) {
    const int c0 = t * win + wi * SEG;
    for (int k = lane; k < SEG && c0 + k < Wd; k += 32) {
      const size_t jl = plane + (size_t)(n - 1) * Wd + c0 + k;
      a.packed[jl] = a.packed_x[jl] = a.packed_y[jl] = 0;
    }
  }

  // row i-1 in registers: m and y at the lane's columns, m left of the
  // warp's segment (lane 0 of warps past the first), band, best column
  // and window start
  int mu[CW], yu[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) mu[c] = yu[c] = NEG;
  int m_left = NEG, left_u = 0, right_u = 0, bsp_u = 0, ws_u = 0;
  bool ovf = false;
  unsigned codes_reg = 0;   // the register form's read codes, 3 bits a column
  if (!ALL) codes_reg = lane_codes(wi * SEG + lane * CW, wi * SEG + lane * CW);

  // the row's tables, loaded a row ahead, and the band, best column and
  // (PF) m and y of slots 0 and 1 where they are far rows
  int code_n = a.codes[0], minp_n = a.min_pred[0], r_n = a.r_values[0];
  int store_n = a.store_at[0];
  int pq0_n = -1, pq1_n = -1, sq0_n = -1, sq1_n = -1;
  int fl[2] = {0, 0}, fr[2] = {0, 0}, fb[2] = {0, 0};
  int fm[2][CW + 1], fy[2][CW];
  for (int i = 0; i < n - 1; ++i) {
    const int code = code_n, minp = minp_n, r = r_n, store = store_n;
    const int pq0 = pq0_n, pq1 = pq1_n, sq0 = sq0_n, sq1 = sq1_n;
    const int fl0 = fl[0], fl1 = fl[1], fr0 = fr[0], fr1 = fr[1];
    if (i + 1 < n - 1) {
      const size_t q0 = (size_t)(i + 1) * Pm;
      code_n = a.codes[i + 1];
      minp_n = a.min_pred[i + 1];
      r_n = a.r_values[i + 1];
      store_n = a.store_at[i + 1];
      pq0_n = a.pred_idx[q0];
      sq0_n = a.srow[q0];
      if (Pm > 1) {
        pq1_n = a.pred_idx[q0 + 1];
        sq1_n = a.srow[q0 + 1];
      }
    }
    const int* pi = a.pred_idx + (size_t)i * Pm;
    const int* si = a.srow + (size_t)i * Pm;
    const int rpar = i & 1;
    int* st = st2 + rpar * GG_PLANES * SEG;   // staging, by row parity

    // the band (":82-100", as mode 0) from the predecessors' best columns
    int left, right;
    {
      int ms_ = 0, me_ = 0;
      if (i > 0) {
        int lo = 1 << 28, hi = NEG;
        for (int q = 0; q < Pm; ++q) {
          const int p = q == 0 ? pq0 : q == 1 ? pq1 : pi[q];
          if (p < 0) continue;
          const int bs = p == i - 1 ? bsp_u : q == 0 ? fb[0] : q == 1 ? fb[1] : a.bsp[brow + p];
          lo = min(lo, bs);
          hi = max(hi, bs);
        }
        ms_ = lo + 1;
        me_ = hi + 1;
      }
      left = max(0, min(ms_, L - r - bta));
      right = L > r ? min(L, max(me_, L - r) + bta) : min(L, me_ + bta);
    }
    // the row's window (WIN; ws = 0 and jend = Lp at full width)
    const int ws = WIN ? left / 8 * 8 : 0;
    const int jend = ws + Wd;                 // the row's stored columns end here
    if (WIN && right > jend) ovf = true;
    if (WIN && !ALL && ws != ws_u) {
      // row i-1's m and y realigned to this row's columns from its staged
      // copy (NEG outside its window), and its m left of the lane
      const int k0 = wi * SEG + lane * CW + ws - ws_u;   // row i-1's column at the lane's first
      const int* s1 = reinterpret_cast<const int*>(s_dyn) + (rpar ^ 1) * GG_PLANES * SEG;
      auto staged = [&](int pl, int k) {
        return k < 0 || k >= Wd ? NEG
                                : s1[(k / SEG) * 2 * GG_PLANES * SEG + pl * SEG + k % SEG];
      };
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        mu[c] = staged(3, k0 + c);
        yu[c] = staged(4, k0 + c);
      }
      m_left = staged(3, k0 - 1);
      codes_reg = lane_codes(ws + wi * SEG + lane * CW, wi * SEG + lane * CW);
    }
    // band-start state (":55-58" j==0 && left==0; ":104-107" fallback)
    const int x_left = left == 0 ? o + e * (minp + 1) : 2 * o + e * (minp + 1) + e * left;
    const int p0 = x_left - left * g;   // the fast chain's term before the band

    // fast: the max of w over the windows before (p0 folded in); clamped:
    // the state x entering the window (x_left: the maps left of the band
    // are the identity)
    int wcarry = CLAMP ? x_left : p0;
    int left_p = 0, left_c = 0;   // the previous window's last column (ALL)
    long long wbest = LLONG_MIN;  // the warp's best (value, last column) of the row
    for (int t = 0; t < nwin; ++t) {
      const int c0 = t * win + wi * SEG;   // the warp's first stored column
      const int k0 = c0 + lane * CW;       // the lane's first stored column
      const int j0 = ws + k0;              // ... and its absolute column
      const int kpar = ALL ? ((i * nwin + t) & 1) : rpar;
      if (ALL) st = st2 + kpar * GG_PLANES * SEG;
      unsigned cr = codes_reg;
      int ml = 0;   // row i-1's m at j0 - 1
      if (ALL) {
        cr = lane_codes(j0, k0);
      } else {
        ml = __shfl_up_sync(FULL, mu[CW - 1], 1);
        if (lane == 0) ml = m_left;
      }
      int lbv = INT_MIN, lbj = 0;   // the lane's best (value, last column)
      int mlast_v = 0;              // m at the row's column right - 1, where the lane holds it
      const int jr = ws + min(max(right - 1 - ws, 0), Wd - 1);

      if (i == 0) {
        // row 0 (":60-66"): y[j] = m[j] = o + e*j in the band, x untouched
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int j = j0 + c;
          const bool in_band = left <= j && j < right && (!WIN || j < jend);
          const int m0 = in_band ? (j == 0 ? 0 : o + e * j) : NEG;
          const int k = lane * CW + c;
          st[k] = in_band ? (j == 0 ? DIR_O : DIR_L) : 0;
          st[SEG + k] = 0;
          st[2 * SEG + k] = 0;
          st[3 * SEG + k] = m0;
          st[4 * SEG + k] = m0;
          if (!ALL) mu[c] = yu[c] = m0;
          if (j < jend && m0 >= lbv) { lbv = m0; lbj = j; }
          if (j == jr) mlast_v = m0;
        }
        if (!ALL && w > 1 && lane == 0) {   // row 0's m at j0 - 1
          const int jl = j0 - 1;
          m_left = left <= jl && jl < right && (!WIN || jl < jend)
                       ? (jl == 0 ? 0 : o + e * jl) : NEG;
        }
      } else {
        // pass 1: each column's D and Y candidates over the slots, in order
        int umb[CW], uyb[CW], db[CW], uq[CW], yq[CW], dq[CW];
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          umb[c] = uyb[c] = db[c] = NEG;
          uq[c] = yq[c] = dq[c] = 0;
        }
        // a stored predecessor row at the lane's columns (WIN: from its window)
        auto load = [&](int srow_, int lp_, int (&vm)[CW + 1], int (&vy)[CW]) {
          if (WIN)
            load_row_win<CW>(msb + (size_t)srow_ * Wd, ysb + (size_t)srow_ * Wd,
                             j0 - lp_ / 8 * 8, Wd, vm, vy);
          else
            load_row<CW>(msb + (size_t)srow_ * Lp, ysb + (size_t)srow_ * Lp, j0, Lp, vm, vy);
        };
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q >= Pm) break;
          const int p = q == 0 ? pq0 : pq1;
          if (p < 0) continue;
          int vm[CW + 1], vy[CW];
          int lp, rp;
          if (p == i - 1) {
            lp = left_u;
            rp = right_u;
            if (ALL) {
              load(i - 1, lp, vm, vy);
            } else {
              vm[0] = ml;
#pragma unroll
              for (int c = 0; c < CW; ++c) {
                vm[c + 1] = mu[c];
                vy[c] = yu[c];
              }
            }
          } else {
            lp = q == 0 ? fl0 : fl1;
            rp = q == 0 ? fr0 : fr1;
            if (PF) {
#pragma unroll
              for (int c = 0; c <= CW; ++c) vm[c] = fm[q][c];
#pragma unroll
              for (int c = 0; c < CW; ++c) vy[c] = fy[q][c];
            } else {
              load(q == 0 ? sq0 : sq1, lp, vm, vy);
            }
          }
          gg_slot<CW>(q, j0, lp, rp, vm, vy, umb, uyb, db, uq, yq, dq);
        }
        for (int q = 2; q < Pm; ++q) {
          const int p = pi[q];
          if (p < 0) continue;
          int vm[CW + 1], vy[CW];
          int lp, rp;
          if (p == i - 1) {
            lp = left_u;
            rp = right_u;
          } else {
            lp = a.lefts[brow + p];
            rp = a.rights[brow + p];
          }
          if (!ALL && p == i - 1) {
            vm[0] = ml;
#pragma unroll
            for (int c = 0; c < CW; ++c) {
              vm[c + 1] = mu[c];
              vy[c] = yu[c];
            }
          } else {
            load(si[q], lp, vm, vy);
          }
          gg_slot<CW>(q, j0, lp, rp, vm, vy, umb, uyb, db, uq, yq, dq);
        }
        int dv[CW], yv[CW], pk[CW], cv[CW];
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int j = j0 + c;
          const int sj = (cr >> (3 * c)) & 7;
          const bool covered = umb[c] > NEG / 2;
          const int umo = umb[c] + o;
          const bool from_y = uyb[c] > umo;   // strict (":328")
          yv[c] = covered ? max(umo, uyb[c]) + e : 2 * o + e * (minp + 1) + e * j;
          const bool has_d = db[c] > NEG / 2;
          dv[c] = db[c] + s_table[code * NCODE + sj];
          cv[c] = has_d ? max(dv[c], yv[c]) : yv[c];
          pk[c] = gg_pack(dq[c], from_y ? yq[c] : uq[c], has_d, covered, from_y);
        }

        // the in-row chain: the lane's summary over all its columns and
        // over all but the last (fast: the max of w, -inf outside the
        // band; clamped: B of the composite map of its columns from left on)
        int lsum = CLAMP ? NEG : INT_MIN, lpart = lsum;
        bool any = false;
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int j = j0 + c;
          if (c == CW - 1) lpart = lsum;
          const bool lz = j == left && left == 0;   // c~[left] = -inf
          if (CLAMP) {
            if (j >= left) {
              const int bj = lz ? NEG : cv[c] + oe;
              lsum = any ? chain_apply(lsum, g, bj) : max(bj, NEG);
              any = true;
            }
          } else if (j >= left && j < right && !lz) {
            lsum = max(lsum, cv[c] + oe - (j + 1) * g);
          }
        }
        int incl = lsum;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(FULL, incl, d);
          if (lane >= d)
            incl = CLAMP ? chain_apply(y, gg_steps(j0 - (d - 1) * CW, j0 + CW, left, g), incl)
                         : max(incl, y);
        }
        int excl = __shfl_up_sync(FULL, incl, 1);
        if (lane == 0) excl = CLAMP ? NEG : INT_MIN;
        // the chain up to (not including) the lane's last column
        const int part = CLAMP ? chain_apply(excl, gg_steps(j0, j0 + CW - 1, left, g), lpart)
                               : max(excl, lpart);
        int lp = __shfl_up_sync(FULL, part, 1);
        int lc = __shfl_up_sync(FULL, cv[CW - 1], 1);

        int carry = wcarry;
        if (w > 1) {
          if (lane == 31) {
            s_tot[kpar][wi] = incl;
            s_part[kpar][wi] = part;
            s_clast[kpar][wi] = cv[CW - 1];
          }
          __syncthreads();
          if (CLAMP) {
            // the states in warp order: entering warp v, and x at the
            // column before it (the previous window's last for v = 0)
            int xin = wcarry, xlast = left_p;
            for (int v = 0; v < w; ++v) {
              const int cv0 = ws + t * win + v * SEG;
              if (v == wi) {
                carry = xin;
                if (lane == 0) lp = xlast;
              }
              xlast = chain_apply(xin, gg_steps(cv0, cv0 + SEG - 1, left, g), s_part[kpar][v]);
              xin = chain_apply(xin, gg_steps(cv0, cv0 + SEG, left, g), s_tot[kpar][v]);
            }
            if (lane == 0) lc = wi > 0 ? s_clast[kpar][wi - 1] : left_c;
            left_p = xlast;
            left_c = s_clast[kpar][w - 1];
            wcarry = xin;
          } else {
            const int tv = lane < w ? s_tot[kpar][lane] : INT_MIN;
            const int before = __reduce_max_sync(FULL, lane < wi ? tv : INT_MIN);
            const int upto = __reduce_max_sync(
                FULL, lane < wi - 1 ? tv : lane == wi - 1 ? s_part[kpar][lane] : INT_MIN);
            const int total = __reduce_max_sync(FULL, tv);
            const int lastp = __reduce_max_sync(
                FULL, lane < w - 1 ? tv : lane == w - 1 ? s_part[kpar][lane] : INT_MIN);
            carry = max(wcarry, before);
            if (lane == 0) {
              if (wi > 0) {
                lp = max(wcarry, upto);
                lc = s_clast[kpar][wi - 1];
              } else {
                lp = left_p;
                lc = left_c;
              }
            }
            left_p = max(wcarry, lastp);   // for the next window's first column
            left_c = s_clast[kpar][w - 1];
            wcarry = max(wcarry, total);
          }
        }
        // the next row's far predecessors (rows i-1 and before): their band
        // and best column, and (PF) their m and y, while this row finishes
        if (i + 1 < n - 1) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int p = q == 0 ? pq0_n : pq1_n;
            if (q < Pm && p >= 0 && p != i) {
              fl[q] = a.lefts[brow + p];
              fr[q] = a.rights[brow + p];
              fb[q] = a.bsp[brow + p];
              if (PF) {
                const int sr = q == 0 ? sq0_n : sq1_n;
                load_row<CW>(msb + (size_t)sr * Lp, ysb + (size_t)sr * Lp, j0, Lp, fm[q], fy[q]);
              }
            }
          }
        }

        // pass 2: x at each column (fast: the running prefix; clamped: the
        // state entering the lane, then its maps), and x at j0 - 1
        int xs[CW];
        int xl;
        if (CLAMP) {
          xs[0] = chain_apply(carry, gg_steps(ws + c0, j0, left, g), excl);
#pragma unroll
          for (int c = 0; c + 1 < CW; ++c) {
            const int j = j0 + c;
            xs[c + 1] = j >= left
                            ? chain_apply(xs[c], g, j == left && left == 0 ? NEG : cv[c] + oe)
                            : xs[c];
          }
          xl = __shfl_up_sync(FULL, xs[CW - 1], 1);
          if (lane == 0) xl = lp;
        } else {
          int P = max(max(carry, excl), p0);
#pragma unroll
          for (int c = 0; c < CW; ++c) {
            const int j = j0 + c;
            xs[c] = j * g + P;
            if (j >= left && j < right && !(j == left && left == 0))
              P = max(P, cv[c] + oe - (j + 1) * g);
          }
          xl = (j0 - 1) * g + max(lane == 0 ? lp : max(lp, carry), p0);
        }
        // m at j0 - 1 (NEG outside the band)
        int mprev;
        {
          const int jl = j0 - 1;
          mprev = jl < left || jl >= right || (WIN && jl >= jend) ? NEG
                  : jl == left && left == 0                       ? xl
                                                                  : max(lc, xl);
        }
        // row i's m at j0 - 1 (WIN, one warp: NEG, column ws - 1 lies left of
        // the band; a realigned row may have set it)
        if (!ALL && (w > 1 || WIN) && lane == 0) m_left = mprev;
        int xprev = xl;
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int j = j0 + c;
          const bool in_band = left <= j && j < right && (!WIN || j < jend);
          const bool is_left = j == left;
          const int sj = (cr >> (3 * c)) & 7;
          const int x = xs[c];
          const int mrow = !in_band ? NEG : is_left && left == 0 ? x : max(cv[c], x);
          const int yrow = in_band ? yv[c] : NEG;
          // path_x plane (":99-120": 'X' iff x[j-1] > m[j-1] + o, j_rel > 0)
          const bool stay_x = xprev > mprev + o && !is_left;
          // M directions: the mode-2 cascade (":143-195")
          const int pkc = pk[c];
          const bool has_d = (pkc >> 24) & 1, covered = (pkc >> 25) & 1, from_y = (pkc >> 26) & 1;
          const int dqc = pkc & 0xfff, uqc = (pkc >> 12) & 0xfff;
          const int u_pred =
              covered ? (uqc == 0 ? pq0 : uqc == 1 ? pq1 : pi[uqc]) : minp;
          const int l_pred = is_left ? minp : i;
          const bool l_lt_u = x < yv[c];
          int dcode, psel;
          if (is_left && left == 0) {
            dcode = DIR_U;  // base case
            psel = minp;
          } else if (!has_d) {  // (":372-378"): l < u => U else L
            dcode = l_lt_u ? DIR_U : DIR_L;
            psel = l_lt_u ? u_pred : l_pred;
          } else if (dv[c] < x) {
            dcode = l_lt_u ? (u_pred == 0 ? DIR_LOW_U : DIR_U) : DIR_L;
            psel = l_lt_u ? u_pred : l_pred;
          } else if (dv[c] < yv[c]) {
            dcode = DIR_U;
            psel = u_pred;
          } else {
            dcode = sj == code ? DIR_D : DIR_LOW_D;
            psel = dqc == 0 ? pq0 : dqc == 1 ? pq1 : pi[dqc];
          }
          const int k = lane * CW + c;
          st[k] = in_band ? psel * 16 + dcode : 0;
          st[SEG + k] = in_band && stay_x ? i * 16 + DIR_X : 0;
          st[2 * SEG + k] = in_band && covered && from_y ? u_pred * 16 + DIR_Y : 0;
          st[3 * SEG + k] = mrow;
          st[4 * SEG + k] = yrow;
          if (!ALL) {
            mu[c] = mrow;
            yu[c] = yrow;
          }
          if (j < jend && mrow >= lbv) { lbv = mrow; lbj = j; }
          if (j == jr) mlast_v = mrow;
          xprev = x;
          mprev = mrow;
        }
      }
      if (j0 <= jr && jr < j0 + CW) a.mlast[brow + i] = mlast_v;

      // the warp's best (value, last column) of the window
      const int vmax = __reduce_max_sync(FULL, lbv);
      const int jmax = __reduce_max_sync(FULL, lbv == vmax ? lbj : -1);
      if (vmax != INT_MIN) {
        const long long key = make_key(vmax, (unsigned)jmax);
        wbest = key > wbest ? key : wbest;
      }

      // the staged segment to the planes (and the scratch), coalesced
      __syncwarp();
      const int len = min(SEG, Wd - c0);
      if (len > 0) {
        const size_t at = plane + (size_t)i * Wd + c0;
        const int sr = ALL ? i : store;
        int* const dst[GG_PLANES] = {a.packed + at, a.packed_x + at, a.packed_y + at,
                                     msb + (size_t)max(sr, 0) * Wd + c0,
                                     ysb + (size_t)max(sr, 0) * Wd + c0};
        if (vec) {
          warp_flush<SEG, true>(st, len, sr >= 0 ? 5 : 3, dst, lane);
        } else {
          warp_flush<SEG, false>(st, len, sr >= 0 ? 5 : 3, dst, lane);
        }
      }
    }

    // the row's best column (the next rows' bands), and its band
    long long key = wbest;
    if (w > 1) {
      if (lane == 0) s_best[wi] = wbest;
      __syncthreads();   // also publishes the row's scratch, planes and staging
      key = s_best[0];
      for (int v = 1; v < w; ++v) key = max(key, s_best[v]);
      __syncthreads();   // s_best is read
    }
    left_u = left;
    right_u = right;
    ws_u = ws;
    bsp_u = (int)key_tie(key);
    if (threadIdx.x == 0) {
      a.lefts[brow + i] = left;
      a.rights[brow + i] = right;
      a.bsp[brow + i] = bsp_u;
      if (WIN) a.wss[brow + i] = ws;
    }
    if (w == 1) __syncwarp();   // publishes the row's scratch, staging, band and best column
  }

  if (w > 1) __syncthreads(); else __syncwarp();
  if (threadIdx.x == 0) {
    a.lefts[brow + n - 1] = 0;
    a.rights[brow + n - 1] = 0;
    if (WIN) {
      a.wss[brow + n - 1] = 0;
      a.over[b] = ovf;
    }
    // the sink candidates (":234-245"): the first best m at right - 1
    int bv = 0, br = 0, bc = 0;
    for (int q = 0; q < a.n_cand; ++q) {
      const int c = a.cand[q];
      const int col = a.rights[brow + c] - 1;
      const int v = a.mlast[brow + c];
      if (q == 0 || v > bv) { bv = v; br = c; bc = col; }
    }
    a.score[b] = bv;
    a.last_row[b] = br;
    a.last_col[b] = bc;
  }
}

template <int CW, bool ALL, bool ONE, bool CLAMP, bool WIN>
int gap_global_launch(const GgArgs& a, cudaStream_t stream) {
  const int threads = 32 * a.warps;
  const int smem = threads / 32 * 2 * GG_PLANES * 32 * CW * (int)sizeof(int);
  auto kern = poa_gap_global_kernel<CW, ALL, ONE, CLAMP, WIN>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<a.B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int CW, bool CLAMP, bool WIN>
int gap_global_chain(const GgArgs& a, cudaStream_t stream) {
  return a.warps == 1 ? gap_global_launch<CW, false, true, CLAMP, WIN>(a, stream)
                      : gap_global_launch<CW, false, false, CLAMP, WIN>(a, stream);
}

template <bool CLAMP, bool WIN>
int gap_global_form(const GgArgs& a, int cw, bool full, cudaStream_t stream) {
  if (full) return gap_global_launch<9, true, false, CLAMP, WIN>(a, stream);
  switch (cw) {
    case 1: return gap_global_chain<1, CLAMP, WIN>(a, stream);
    case 3: return gap_global_chain<3, CLAMP, WIN>(a, stream);
    case 5: return gap_global_chain<5, CLAMP, WIN>(a, stream);
    case 7: return gap_global_chain<7, CLAMP, WIN>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The checks and the launch of both entries: W = Lp, wss = over = null
// for K4.
template <bool WIN>
int gap_global_entry(const GgArgs& a, int cw, int full, int clamp, cudaStream_t s) {
  if (a.B < 1 || a.n < 3 || a.Pm < 1 || a.Pm > 4095 || a.Lp < 1 || a.W < 1 || a.S < 1 ||
      a.n_cand < 1 || a.warps < 1 || a.warps > GG_MAX_WARPS || 32 * a.warps > GG_THREADS ||
      (!full && a.W > 32 * cw * a.warps) || (full && (cw != 9 || a.warps != GG_MAX_WARPS)))
    return (int)cudaErrorInvalidValue;
  return clamp ? gap_global_form<true, WIN>(a, cw, full != 0, s)
               : gap_global_form<false, WIN>(a, cw, full != 0, s);
}

}  // namespace rgt

// cw: the columns a lane (1, 3, 5 or 7; 9 in the full form); warps: the
// warps a read, one read a block (1 to 16; 16 in the full form); full:
// every row's m and y in the scratch; clamp: the clamped chain.
extern "C" int rgt_poa_gap_global_fill(
    const int* seq, const int* L, const int* bta, const int* table, const int* codes,
    const int* pred_idx, const int* min_pred, const int* r_values, const int* cand,
    const int* srow, const int* store_at, int n_cand, int B, int n, int Pm, int Lp, int o,
    int e, int cw, int warps, int full, int clamp, int S, int* ms, int* ys, int* bsp,
    int* mlast, int* score, int* last_row, int* last_col, int* packed, int* packed_x,
    int* packed_y, int* lefts, int* rights, void* stream) {
  using namespace rgt;
  const GgArgs a{seq, L, bta, table, codes, min_pred, r_values, pred_idx, srow, store_at, cand,
                 n_cand, B, n, Pm, Lp, o, e, warps, S, ms, ys, bsp, mlast, score, last_row,
                 last_col, packed, packed_x, packed_y, lefts, rights, Lp, nullptr, nullptr};
  return gap_global_entry<false>(a, cw, full, clamp, (cudaStream_t)stream);
}

// K6: as K4, each row storing W columns (W >= 8) from its window start;
// the layout (cw, warps, full) covers W columns.
extern "C" int rgt_poa_gap_global_win_fill(
    const int* seq, const int* L, const int* bta, const int* table, const int* codes,
    const int* pred_idx, const int* min_pred, const int* r_values, const int* cand,
    const int* srow, const int* store_at, int n_cand, int B, int n, int Pm, int Lp, int W,
    int o, int e, int cw, int warps, int full, int clamp, int S, int* ms, int* ys, int* bsp,
    int* mlast, int* score, int* last_row, int* last_col, int* packed, int* packed_x,
    int* packed_y, int* lefts, int* rights, int* wss, bool* over, void* stream) {
  using namespace rgt;
  if (W < 8) return (int)cudaErrorInvalidValue;
  const GgArgs a{seq, L, bta, table, codes, min_pred, r_values, pred_idx, srow, store_at, cand,
                 n_cand, B, n, Pm, Lp, o, e, warps, S, ms, ys, bsp, mlast, score, last_row,
                 last_col, packed, packed_x, packed_y, lefts, rights, W, wss, over};
  return gap_global_entry<true>(a, cw, full, clamp, (cudaStream_t)stream);
}
