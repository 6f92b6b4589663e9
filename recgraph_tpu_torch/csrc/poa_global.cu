// Mode-0 banded global linear-gap POA fill (global_abpoa.rs:260-427) for
// Hopper, one kernel body in three forms known when compiling (FORM): at
// full width (K1), with windowed rows for long reads (K3, WIN) and in the
// v1 TPU layout (K14, V1).
//
// K1 replaces the TPU kernel recgraph_tpu/ops/pallas_poa_global2.py:477
// fill_global_v2 and computes what poa_engine._fill_global
// (recgraph_tpu/ops/poa_engine.py:149-297) computes, bit for bit: the
// adaptive band from the predecessors' best columns (utils.rs:17-72, the
// last column at a row's maximum); U and D candidates as the first best
// over the covering predecessors in slot order (U over [lp, rp), D over
// (lp, rp]), gap * (i + j) and gap * (i + left) where none covers; the
// band start's value (m[min_pred] at its band start + gap where left == 0,
// else at least the fallback sm(seq[left], '-') (i + left)); packed
// pred * 16 + dir cells with tie order D >= U >= L, 'd' on a mismatch,
// zero outside the band and on row n-1; and the first-strict-max sink
// pick over the candidates.  K3 replaces
// recgraph_tpu/ops/pallas_poa_global_win.py:417 fill_global_win with the
// per-read window starts of poa_engine._fill_global_windowed (:300-480);
// K14 replaces recgraph_tpu/ops/pallas_poa.py:537 fill_global (v1), K1's
// function in the layout packed [n, B, Lp + 8].
//
// The in-row chain.  m[j] = max(A[j], m[j-1] + sm(seq[j], '-')), with
// A = NEG outside the band, is, with G the read's running sum of
// sm(seq[j], '-'),
//
//     m[j] = G[j] + max_{k <= j} (A[k] - G[k]),
//
// a prefix maximum over every column, as the JAX engine computes it
// (poa_engine.py:197-198 and, on a window, :411-412; no clamp): no range
// guard is needed.  G depends only on the read, so it is computed once and
// held in registers (in the full form and in WIN, also in a scratch row).
// Row 0 sums sm('-', seq[j]) instead, which differs for an asymmetric
// table: its G is computed first and row 0 runs apart from the loop over
// the other rows (the same row body, inlined twice), which then holds the
// other rows' G and no case of row 0's.
//
// The window (WIN).  Row i stores W columns from ws_i = (left_i / 8) * 8
// (row 0's is 0); at full width ws_i = 0 and W = Lp.  Every column below
// is absolute (j = ws_i + k for the row's k-th stored column), so the band,
// the candidates and the cells are K1's, and G is taken on absolute
// columns: on the window it differs from the reference's cumsum by a
// constant, which leaves m unchanged.  A predecessor p is read at column
// j - ws_p, NEG outside its window; m at column ws_i - 1 is NEG (left of
// the band); the band start's m and m at right - 1 are taken at the
// stored columns clamp(left - ws, 0, W - 1) and clamp(right - 1 - ws, 0,
// W - 1), as the plain version clamps them (_fill_global_rows in the
// port's ops/poa_engine.py); a read whose band passes ws_i + W sets
// over[b] and its rows keep what fits.
//
// The v1 layout (V1).  Row i of read b goes to packed at (i B + b)(Lp + 8):
// lanes [0, Lp) the cells, lane Lp the row's band start, lane Lp + 1 its
// band end, lanes Lp + 2 .. Lp + 7 zero, written once a row beside the
// cells; row n-1 all zero.  The band history stays in lefts / rights.
//
// Design (K2's, poa_local.cu, with K4's band, poa_gap_global.cu; one form
// a launch, cuda_poa_gap_local.plan, over the W stored columns for K3):
// - A read runs on one block of w warps (w = 1 for rows up to 224
//   columns), each lane holding CW = 1, 3, 5 or 7 contiguous columns in
//   registers.  A row is a pass that computes each column's U and D
//   candidates and A - G, a warp max scan (plus, for w > 1, the warp
//   totals through shared memory and a block barrier), and a pass that
//   applies the carry and writes the cells.  m at the lane's first column
//   minus one is G there plus the prefix before the lane, so no neighbour
//   exchange is needed.  The cell's direction needs only max(D, U), the
//   slot of each and four flags from the first pass, and no branch: the
//   predecessor of a slot past the first two is the only device read.
//   The row best (the last column at the row maximum, which the next
//   row's band needs) is two warp reductions; for w > 1 each warp's best
//   goes through shared memory and a second barrier.  No block barrier
//   with w = 1.
// - The band state stays on chip, as in K4: row i-1's band, best column
//   and m at its band start in registers, the next row's tables (code,
//   min_pred, r, the first two slots' predecessors and scratch rows)
//   loaded a row ahead, the band and best column of its far predecessors
//   (slots 0 and 1) loaded during this row.  lefts, rights, the best
//   columns and each row's m at its band start and at right - 1 (mfirst,
//   mlast [B, n], read back from the staged row) go to device memory for
//   far predecessors, the left == 0 base case of a row whose min_pred is
//   not row i-1, and the sink sweep.
// - Row i-1's m stays in registers.  Only rows that some row lists as a
//   predecessor other than its row i-1 go to a device scratch
//   (store_at[row] >= 0, cuda_poa_gap_local.stored_rows with every_row:
//   every mode-0 row sweeps its predecessors), read in the row's first
//   pass.
// - WIN: a row whose window moved against row i-1's (+8 on about one row
//   in eight of a diagonal alignment, negative where a far predecessor
//   pulls the band back, W or more after a jump) first realigns row i-1's
//   m from its staged copy in shared memory (every row is staged, two
//   buffers by row parity), NEG outside row i-1's window, and reloads the
//   lane's read codes and G (from the scratch row of G); a row whose
//   window did not move takes the registers as they are.
// - Rows past 16 warps x 224 columns take the full form: every row's m
//   in the scratch, G in one more scratch row (WIN: in its own [B, Lp]),
//   the row in windows of 16 warps x 9 columns a lane.
// - A warp stages its segment of the plane (and m) in shared memory, two
//   buffers by row parity, and writes it with coalesced 16-byte stores
//   (4-byte ones where the row's stride is not a multiple of 4).
//
// What bounds it on this card: the bytes of the packed plane (4 a cell)
// plus 4 a cell of the stored rows; a row's latency rules as in K2 (the
// rows of a read are sequential, a row a serial chain of one warp).  The
// one-warp form is compiled for GC_ONE_BLOCKS blocks an SM.
//
// The kernel allocates nothing, does not synchronise with the host and
// runs on the stream it is given.

#include "poa_common.cuh"

namespace rgt {

constexpr int GC_THREADS = 512;    // threads a block at most
constexpr int GC_PLANES = 2;       // staged: packed, m
constexpr int GC_MAX_WARPS = 16;   // warps a read
// blocks an SM holds of the one-warp form: 24 hold a stretch chunk of
// 3,047 reads on 132 SMs at once (at most 80 registers a thread; a build
// without the bound ran 22 % slower at that shape, H100 80GB HBM3, 700 W)
constexpr int GC_ONE_BLOCKS = 24;

// the forms: K1, K3 (windowed rows), K14 (the v1 layout)
enum : int { GC_K1 = 0, GC_WIN = 1, GC_V1 = 2 };

struct GcArgs {
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
  int n_cand, B, n, Pm, Lp;
  int warps;             // warps a read (a block)
  int S;                 // scratch rows a read (the full form: n rows, and G's but in WIN)
  int* ms;               // [B, S, W]
  int* bsp;              // [B, n] each row's best column
  int* mfirst;           // [B, n] each row's m at its band start (clamped into the row)
  int* mlast;            // [B, n] each row's m at right - 1 (clamped into the row)
  int* score;
  int* last_row;
  int* last_col;
  int* packed;           // [B, n, W]; V1: [n, B, Lp + 8]
  int* lefts;
  int* rights;
  int W;                 // columns a row stores (WIN; Lp otherwise)
  int* gs;               // [B, Lp] the other rows' G (WIN)
  int* wss;              // [B, n] each row's window start (WIN)
  bool* over;            // [B] a band passed its window (WIN)
};

// One slot q of the first-best sweeps over the predecessors (slot order,
// strict >, from NEG).  p's band [lp, rp) covers column j for U and
// (lp, rp] for D; a row's m is NEG outside its band and outside the read,
// so the strict > against NEG is the band test.  vm[c + 1]: m[p][j0 + c];
// vm[0]: m[p][j0 - 1].
// qs: the slot of U in bits 0-11, of D in bits 12-23.
template <int CW>
__device__ __forceinline__ void gc_slot(int q, const int (&vm)[CW + 1], int (&ub)[CW],
                                        int (&db)[CW], int (&qs)[CW]) {
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    if (vm[c + 1] > ub[c]) { ub[c] = vm[c + 1]; qs[c] = (qs[c] & ~0xfff) | q; }
    if (vm[c] > db[c]) { db[c] = vm[c]; qs[c] = (qs[c] & 0xfff) | q << 12; }
  }
}

// A stored row's m at the lane's columns j0 - 1 .. j0 + CW - 1 (NEG outside
// the read's width).
template <int CW>
__device__ __forceinline__ void gc_load_row(const int* mp, int j0, int Lp, int (&vm)[CW + 1]) {
  vm[0] = j0 > 0 && j0 <= Lp ? mp[j0 - 1] : NEG;
#pragma unroll
  for (int c = 0; c < CW; ++c) vm[c + 1] = j0 + c < Lp ? mp[j0 + c] : NEG;
}

// A stored row of the window form at its columns k0 - 1 .. k0 + CW - 1,
// k0 = j0 - ws_p; NEG outside its W columns.
template <int CW>
__device__ __forceinline__ void gc_load_win(const int* mp, int k0, int W, int (&vm)[CW + 1]) {
  vm[0] = k0 > 0 && k0 <= W ? mp[k0 - 1] : NEG;
#pragma unroll
  for (int c = 0; c < CW; ++c) vm[c + 1] = k0 + c >= 0 && k0 + c < W ? mp[k0 + c] : NEG;
}

// ONE: one warp a read, known when compiling; ALL: the full form; FORM:
// GC_K1 (K1), GC_WIN (K3) or GC_V1 (K14).
template <int CW, bool ALL, bool ONE, int FORM>
__global__ void __launch_bounds__(ONE ? 32 : GC_THREADS, ONE ? GC_ONE_BLOCKS : 1)
    poa_global_warp_kernel(const GcArgs a) {
  constexpr bool WIN = FORM == GC_WIN, V1 = FORM == GC_V1;
  __shared__ int s_table[NCODE * NCODE];
  __shared__ int s_tot[2][32];
  __shared__ long long s_best[32];
  extern __shared__ int4 s_dyn[];

  constexpr int SEG = 32 * CW;
  const int w = ONE ? 1 : a.warps, wi = ONE ? 0 : threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  for (int t = threadIdx.x; t < NCODE * NCODE; t += blockDim.x) s_table[t] = a.table[t];
  __syncthreads();

  const int n = a.n, Lp = a.Lp, Pm = a.Pm;
  const int Wd = WIN ? a.W : Lp;                    // columns a row stores
  const int L = a.L[b], bta = a.bta[b];
  const int* sb = a.seq + (size_t)b * Lp;
  const size_t plane = (size_t)b * n * Wd;
  const size_t brow = (size_t)b * n;
  // row i's cells: [B, n, W], or (V1) [n, B, Lp + 8]
  auto prow = [&](int i) {
    return V1 ? a.packed + ((size_t)i * a.B + b) * (Lp + 8) : a.packed + plane + (size_t)i * Wd;
  };
  int* st2 = reinterpret_cast<int*>(s_dyn) + (size_t)wi * 2 * GC_PLANES * SEG;
  const int win = w * SEG;                          // columns a window
  const int nwin = ALL ? (Wd + win - 1) / win : 1;
  const int nsum = ALL || WIN ? (Lp + win - 1) / win : 1;   // windows of the read's G
  const bool vec = (Wd & 3) == 0;                   // V1: (Lp + 8) % 4 == Lp % 4
  int* msb = a.ms + (size_t)b * a.S * Wd;
  // the scratch row of G (the full form and WIN)
  int* gsb = WIN ? a.gs + (size_t)b * Lp : msb + (size_t)(a.S - 1) * Lp;

  // G at the lane's columns (into its scratch row, window by window, where
  // the form has one; the registers keep the first window's): the running
  // sum of sm('-', seq[j]) for row 0, else of sm(seq[j], '-')
  int gv[CW];
  auto sums = [&](bool row0) {
    int gcarry = 0;   // G before the window
    for (int t = 0; t < nsum; ++t) {
      const int j0 = t * win + wi * SEG + lane * CW;
      int sum = 0, gt[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int sj = j0 + c < Lp ? sb[j0 + c] : GAP;
        sum += row0 ? s_table[GAP * NCODE + sj] : s_table[sj * NCODE + GAP];
        gt[c] = sum;
      }
      int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += y;
      }
      int carry = gcarry + incl - sum;
      if (w > 1) {
        if (lane == 31) s_tot[t & 1][wi] = incl;
        __syncthreads();
        for (int v = 0; v < w; ++v) {
          const int tv = s_tot[t & 1][v];
          carry += v < wi ? tv : 0;
          gcarry += tv;
        }
      } else if (nsum > 1) {
        gcarry += __shfl_sync(FULL, incl, 31);
      }
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        gt[c] += carry;
        if ((ALL || WIN) && j0 + c < Lp) gsb[j0 + c] = gt[c];
        if (t == 0) gv[c] = gt[c];
      }
    }
    if (w > 1) __syncthreads();   // s_tot and the G row are read
    else if (WIN) __syncwarp();   // the G row is read (a moved window)
  };
  sums(true);

  // the read's codes (3 bits a column) and G at the lane's columns from
  // absolute column j0, GAP past the read as in the sums (the full form,
  // and WIN where the window moved)
  auto lane_cols = [&](int j0, unsigned& cr) {
    cr = 0;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int j = j0 + c;
      cr |= (unsigned)(j < Lp ? sb[j] : GAP) << (3 * c);
      gv[c] = j < Lp ? gsb[j] : gsb[Lp - 1] + (j - Lp + 1) * s_table[GAP * NCODE + GAP];
    }
  };

  unsigned codes_reg = 0;   // the register form's read codes, 3 bits a column
  if (!ALL) {
    const int j0 = wi * SEG + lane * CW;
#pragma unroll
    for (int c = 0; c < CW; ++c)
      codes_reg |= (unsigned)(j0 + c < Lp ? sb[j0 + c] : GAP) << (3 * c);
  }

  // row n-1: all 0
  for (int t = 0; t < nwin; ++t) {
    const int c0 = t * win + wi * SEG;
    for (int k = lane; k < SEG && c0 + k < Wd; k += 32) prow(n - 1)[c0 + k] = 0;
  }
  if (V1 && threadIdx.x < 8) prow(n - 1)[Lp + threadIdx.x] = 0;

  // row i-1 in registers: m at the lane's columns, m left of the warp's
  // segment (lane 0 of warps past the first), band, best column, m at its
  // band start (one warp a read) and window start
  int mu[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) mu[c] = NEG;
  int m_left = NEG, left_u = 0, right_u = 0, bsp_u = 0, mf_u = 0, ws_u = 0;
  bool ovf = false;

  // the row's tables, loaded a row ahead, and the band start (WIN: the
  // window's) and best column of slots 0 and 1 where they are far rows
  int code_n = a.codes[0], minp_n = a.min_pred[0], r_n = a.r_values[0];
  int store_n = a.store_at[0];
  int pq0_n = -1, pq1_n = -1, sq0_n = -1, sq1_n = -1;
  int fl[2] = {0, 0}, fb[2] = {0, 0};
  // row i; row 0 runs apart, on its own G, so that the loop over the other
  // rows carries neither its G's sums nor its cases
  auto row = [&](const int i) __attribute__((always_inline)) {
    const int code = code_n, minp = minp_n, r = r_n, store = store_n;
    const int pq0 = pq0_n, pq1 = pq1_n, sq0 = sq0_n, sq1 = sq1_n;
    const int fl0 = fl[0], fl1 = fl[1];
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
    int* st = st2 + rpar * GC_PLANES * SEG;   // staging, by row parity
    const int gnode = s_table[code * NCODE + GAP];   // sm(lnz[i], '-')

    // the band (utils.rs:17-72) from the predecessors' best columns
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
    // the row's window (WIN; ws = 0 and jend = Lp otherwise)
    const int ws = WIN ? left / 8 * 8 : 0;
    const int jend = ws + Wd;                 // the row's stored columns end here
    if (WIN && right > jend) ovf = true;
    if (WIN && !ALL && ws != ws_u) {
      // row i-1's m realigned to this row's columns from its staged copy
      // (NEG outside its window), its m left of the lane, and the lane's
      // codes and G at its new columns
      const int k0 = wi * SEG + lane * CW + ws - ws_u;   // row i-1's column at the lane's first
      const int* s1 = reinterpret_cast<const int*>(s_dyn) + (rpar ^ 1) * GC_PLANES * SEG;
      auto staged = [&](int k) {
        return k < 0 || k >= Wd ? NEG : s1[(k / SEG) * 2 * GC_PLANES * SEG + SEG + k % SEG];
      };
#pragma unroll
      for (int c = 0; c < CW; ++c) mu[c] = staged(k0 + c);
      m_left = staged(k0 - 1);
      lane_cols(ws + wi * SEG + lane * CW, codes_reg);
    }
    // column left's value: the left == 0 base case m[min_pred] at its band
    // start + gap (":74-77"), else at least the j == 0 / left > 0 fallback
    // sm(seq[left], '-') (i + left) (":85", from the code of the lane that
    // holds column left); no D covers a column: gap (i + left)
    int base0 = 0;
    if (i > 0 && left == 0)
      base0 = (ONE && minp == i - 1 ? mf_u : a.mfirst[brow + minp]) + gnode;
    const int d_none = gnode * (i + left);
    // the stored columns of the band start and of right - 1
    const int jf = min(max(left - ws, 0), Wd - 1), jr = min(max(right - 1 - ws, 0), Wd - 1);

    int wcarry = INT_MIN;            // the max of A - G over the windows before
    long long wbest = LLONG_MIN;     // the warp's best (value, last column) of the row
    for (int t = 0; t < nwin; ++t) {
      const int c0 = t * win + wi * SEG;   // the warp's first stored column
      const int j0 = ws + c0 + lane * CW;  // the lane's first column
      const int kpar = ALL ? ((i * nwin + t) & 1) : rpar;
      if (ALL) st = st2 + kpar * GC_PLANES * SEG;
      unsigned cr = codes_reg;
      int ml = 0;   // row i-1's m at j0 - 1
      if (ALL) {
        lane_cols(j0, cr);
      } else {
        ml = __shfl_up_sync(FULL, mu[CW - 1], 1);
        if (lane == 0) ml = m_left;
      }
      // a stored row at the lane's columns (WIN: from its window start wsp)
      auto load = [&](int sr, int wsp, int (&vm)[CW + 1]) {
        if (WIN)
          gc_load_win<CW>(msb + (size_t)sr * Wd, j0 - wsp, Wd, vm);
        else
          gc_load_row<CW>(msb + (size_t)sr * Lp, j0, Lp, vm);
      };

      // pass 1: each column's U and D over the slots, in order; A - G for
      // the chain, and for the cell the larger of D and U with the slot of
      // each and the flags has_u, has_d, D >= U, and (at the band start
      // past column 0) max(D, U) >= the fallback
      int av[CW], pk[CW];
      {
        int ub[CW], db[CW];
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          ub[c] = db[c] = NEG;
          pk[c] = 0;
        }
        if (i > 0) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (q >= Pm) break;
            const int p = q == 0 ? pq0 : pq1;
            if (p < 0) continue;
            int vm[CW + 1];
            if (p == i - 1 && !ALL) {
              vm[0] = ml;
#pragma unroll
              for (int c = 0; c < CW; ++c) vm[c + 1] = mu[c];
            } else {
              load(p == i - 1 ? i - 1 : q == 0 ? sq0 : sq1,
                   p == i - 1 ? ws_u : (q == 0 ? fl0 : fl1) / 8 * 8, vm);
            }
            gc_slot<CW>(q, vm, ub, db, pk);
          }
          for (int q = 2; q < Pm; ++q) {
            const int p = pi[q];
            if (p < 0) continue;
            int vm[CW + 1];
            if (!ALL && p == i - 1) {
              vm[0] = ml;
#pragma unroll
              for (int c = 0; c < CW; ++c) vm[c + 1] = mu[c];
            } else {
              load(si[q], !WIN ? 0 : p == i - 1 ? ws_u : a.lefts[brow + p] / 8 * 8, vm);
            }
            gc_slot<CW>(q, vm, ub, db, pk);
          }
        }
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int j = j0 + c;
          const int sj = (cr >> (3 * c)) & 7;
          const bool has_u = ub[c] > NEG / 2, has_d = db[c] > NEG / 2;
          const int uv = has_u ? ub[c] + gnode : gnode * (i + j);
          const int dv = has_d ? db[c] + s_table[code * NCODE + sj] : d_none;
          const int mx = max(dv, uv);
          const int l_fb = s_table[sj * NCODE + GAP] * (i + left);   // used at j == left
          int A = mx;
          if (i == 0) A = j == 0 ? 0 : NEG;
          else if (j == left) A = left == 0 ? base0 : max(A, l_fb);
          av[c] = left <= j && j < right && (!WIN || j < jend) ? A : NEG;
          pk[c] |= (int)has_u << 24 | (int)has_d << 25 | (int)(dv >= uv) << 26 |
                   (int)(mx >= l_fb) << 27;
        }
      }

      // the lane's max of A - G, then the warp's exclusive prefix
      int lmax = INT_MIN;
#pragma unroll
      for (int c = 0; c < CW; ++c) lmax = max(lmax, av[c] - gv[c]);
      int incl = lmax;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl = max(incl, y);
      }
      int excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = INT_MIN;

      int carry = wcarry;   // the max of A - G over the columns before the warp
      if (w > 1) {
        if (lane == 31) s_tot[kpar][wi] = incl;
        __syncthreads();
        const int tv = lane < w ? s_tot[kpar][lane] : INT_MIN;
        carry = max(wcarry, __reduce_max_sync(FULL, lane < wi ? tv : INT_MIN));
        wcarry = max(wcarry, __reduce_max_sync(FULL, tv));
      }
      // the next row's far predecessors (rows i-1 and before): their band
      // start and best column, while this row finishes
      if (i + 1 < n - 1) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int p = q == 0 ? pq0_n : pq1_n;
          if (q < Pm && p >= 0 && p != i) {
            fl[q] = a.lefts[brow + p];
            fb[q] = a.bsp[brow + p];
          }
        }
      }

      // pass 2: m at each column from the running prefix, and the cells;
      // sm(seq[j], '-') is G[j] - G[j-1]
      int P = max(carry, excl);
      int mprev;   // m at j0 - 1: G there plus the prefix before the lane
      int gprev;   // G at j0 - 1
      {
        const int jl = j0 - 1;
        const int s0 = cr & 7;
        gprev = gv[0] - (i == 0 ? s_table[GAP * NCODE + s0] : s_table[s0 * NCODE + GAP]);
        mprev = jl < left || jl >= right || (WIN && jl >= jend) ? NEG : gprev + P;
      }
      // row i's m at j0 - 1 (WIN, one warp: NEG, column ws - 1 lies left of
      // the band; a realigned row may have set it)
      if (!ALL && (w > 1 || WIN) && lane == 0) m_left = mprev;
      int lbv = INT_MIN, lbj = 0;   // the lane's best (value, last column)
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int j = j0 + c;
        const int sj = (cr >> (3 * c)) & 7;
        const bool in_band = left <= j && j < right && (!WIN || j < jend);
        P = max(P, av[c] - gv[c]);
        const int mrow = in_band ? gv[c] + P : NEG;
        // the cell: max(D, U) against L (tie order D >= U >= L); at the band
        // start past column 0 L is the fallback, else m[j-1] + sm(seq[j], '-')
        const int pkc = pk[c];
        const bool ge_l = j == left ? (pkc >> 27) & 1 : av[c] >= mprev + (gv[c] - gprev);
        const bool d_ge_u = (pkc >> 26) & 1;
        const int q = d_ge_u ? (pkc >> 12) & 0xfff : pkc & 0xfff;   // the slot of D or U
        const bool has = (pkc >> (d_ge_u ? 25 : 24)) & 1;
        int sp = q == 0 ? pq0 : pq1;
        if (q >= 2) sp = pi[q];
        int dcode = !ge_l ? DIR_L : !d_ge_u ? DIR_U : sj == code ? DIR_D : DIR_LOW_D;
        int psel = !ge_l ? (j > left ? i : minp) : has ? sp : minp;
        if (j == left && left == 0) {   // base case (global_abpoa.rs:74-77)
          dcode = DIR_U;
          psel = minp;
        }
        if (i == 0) {
          dcode = j == 0 ? DIR_O : DIR_L;
          psel = 0;
        }
        const int k = lane * CW + c;
        st[k] = in_band ? psel * 16 + dcode : 0;
        st[SEG + k] = mrow;
        if (!ALL) mu[c] = mrow;
        if (j < jend && mrow >= lbv) { lbv = mrow; lbj = j; }
        mprev = mrow;
        gprev = gv[c];
      }

      // the warp's best (value, last column) of the window
      const int vmax = __reduce_max_sync(FULL, lbv);
      const int jmax = __reduce_max_sync(FULL, lbv == vmax ? lbj : -1);
      if (vmax != INT_MIN) {
        const long long key = make_key(vmax, (unsigned)jmax);
        wbest = key > wbest ? key : wbest;
      }

      // m at the band start and at right - 1 from the staged row, and the
      // staged segment to the plane (and the scratch), coalesced
      __syncwarp();
      if (lane == 0 && c0 <= jf && jf < c0 + SEG) a.mfirst[brow + i] = st[SEG + jf - c0];
      if (lane == 0 && c0 <= jr && jr < c0 + SEG) a.mlast[brow + i] = st[SEG + jr - c0];
      if (ONE) mf_u = st[SEG + jf];
      const int len = min(SEG, Wd - c0);
      if (len > 0) {
        const int sr = ALL ? i : store;
        int* const dst[GC_PLANES] = {prow(i) + c0, msb + (size_t)max(sr, 0) * Wd + c0};
        if (vec) {
          warp_flush<SEG, true>(st, len, sr >= 0 ? 2 : 1, dst, lane);
        } else {
          warp_flush<SEG, false>(st, len, sr >= 0 ? 2 : 1, dst, lane);
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
    // V1: the band and six zeros beside the row's cells
    if (V1 && threadIdx.x < 8)
      prow(i)[Lp + threadIdx.x] = threadIdx.x == 0 ? left : threadIdx.x == 1 ? right : 0;
    if (w == 1) __syncwarp();   // publishes the row's scratch, staging, band and best column
  };
  row(0);
  sums(false);   // the other rows' G
  for (int i = 1; i < n - 1; ++i) row(i);

  if (w > 1) __syncthreads(); else __syncwarp();
  if (threadIdx.x == 0) {
    a.lefts[brow + n - 1] = 0;
    a.rights[brow + n - 1] = 0;
    if (WIN) {
      a.wss[brow + n - 1] = 0;
      a.over[b] = ovf;
    }
    // the sink candidates (global_abpoa.rs:397-405): the first best m at
    // right - 1, row n-2 first
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

template <int CW, bool ALL, bool ONE, int FORM>
int global_launch(const GcArgs& a, cudaStream_t stream) {
  const int threads = 32 * a.warps;
  const int smem = threads / 32 * 2 * GC_PLANES * 32 * CW * (int)sizeof(int);
  auto kern = poa_global_warp_kernel<CW, ALL, ONE, FORM>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<a.B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int CW, int FORM>
int global_chain(const GcArgs& a, cudaStream_t stream) {
  return a.warps == 1 ? global_launch<CW, false, true, FORM>(a, stream)
                      : global_launch<CW, false, false, FORM>(a, stream);
}

// The checks and the launch of the three entries: W = Lp and gs = wss =
// over = null but for K3; the full form's scratch holds G's row but in K3.
template <int FORM>
int global_entry(const GcArgs& a, int cw, int full, cudaStream_t s) {
  if (a.B < 1 || a.n < 3 || a.Pm < 1 || a.Pm > 4095 || a.Lp < 1 || a.W < 1 || a.S < 1 ||
      a.n_cand < 1 || a.warps < 1 || a.warps > GC_MAX_WARPS || 32 * a.warps > GC_THREADS ||
      (!full && a.W > 32 * cw * a.warps) ||
      (full && (cw != 9 || a.warps != GC_MAX_WARPS || a.S != a.n + (FORM != GC_WIN))))
    return (int)cudaErrorInvalidValue;
  if (full) return global_launch<9, true, false, FORM>(a, s);
  switch (cw) {
    case 1: return global_chain<1, FORM>(a, s);
    case 3: return global_chain<3, FORM>(a, s);
    case 5: return global_chain<5, FORM>(a, s);
    case 7: return global_chain<7, FORM>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rgt

// K1.  cw: the columns a lane (1, 3, 5 or 7; 9 in the full form); warps:
// the warps a read, one read a block (1 to 16; 16 in the full form); full:
// every row's m in the scratch (S = n + 1: G's row last).
extern "C" int rgt_poa_global_fill(
    const int* seq, const int* L, const int* bta, const int* table, const int* codes,
    const int* pred_idx, const int* min_pred, const int* r_values, const int* cand,
    const int* srow, const int* store_at, int n_cand, int B, int n, int Pm, int Lp, int cw,
    int warps, int full, int S, int* ms, int* bsp, int* mfirst, int* mlast, int* score,
    int* last_row, int* last_col, int* packed, int* lefts, int* rights, void* stream) {
  using namespace rgt;
  const GcArgs a{seq, L, bta, table, codes, min_pred, r_values, pred_idx, srow, store_at, cand,
                 n_cand, B, n, Pm, Lp, warps, S, ms, bsp, mfirst, mlast, score, last_row,
                 last_col, packed, lefts, rights, Lp, nullptr, nullptr, nullptr};
  return global_entry<GC_K1>(a, cw, full, (cudaStream_t)stream);
}

// K3: as K1, each row storing W columns (W >= 8) from its window start;
// the layout (cw, warps, full) covers W columns; ms [B, S, W] (the full
// form: S = n), gs [B, Lp] the other rows' G.
extern "C" int rgt_poa_global_win_fill(
    const int* seq, const int* L, const int* bta, const int* table, const int* codes,
    const int* pred_idx, const int* min_pred, const int* r_values, const int* cand,
    const int* srow, const int* store_at, int n_cand, int B, int n, int Pm, int Lp, int W,
    int cw, int warps, int full, int S, int* ms, int* gs, int* bsp, int* mfirst, int* mlast,
    int* score, int* last_row, int* last_col, int* packed, int* lefts, int* rights, int* wss,
    bool* over, void* stream) {
  using namespace rgt;
  if (W < 8) return (int)cudaErrorInvalidValue;
  const GcArgs a{seq, L, bta, table, codes, min_pred, r_values, pred_idx, srow, store_at, cand,
                 n_cand, B, n, Pm, Lp, warps, S, ms, bsp, mfirst, mlast, score, last_row,
                 last_col, packed, lefts, rights, W, gs, wss, over};
  return global_entry<GC_WIN>(a, cw, full, (cudaStream_t)stream);
}

// K14: K1's arguments, packed [n, B, Lp + 8]; lefts and rights [B, n] are
// the band history.
extern "C" int rgt_poa_global_v1_fill(
    const int* seq, const int* L, const int* bta, const int* table, const int* codes,
    const int* pred_idx, const int* min_pred, const int* r_values, const int* cand,
    const int* srow, const int* store_at, int n_cand, int B, int n, int Pm, int Lp, int cw,
    int warps, int full, int S, int* ms, int* bsp, int* mfirst, int* mlast, int* score,
    int* last_row, int* last_col, int* packed, int* lefts, int* rights, void* stream) {
  using namespace rgt;
  const GcArgs a{seq, L, bta, table, codes, min_pred, r_values, pred_idx, srow, store_at, cand,
                 n_cand, B, n, Pm, Lp, warps, S, ms, bsp, mfirst, mlast, score, last_row,
                 last_col, packed, lefts, rights, Lp, nullptr, nullptr, nullptr};
  return global_entry<GC_V1>(a, cw, full, (cudaStream_t)stream);
}

extern "C" const char* rgt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
