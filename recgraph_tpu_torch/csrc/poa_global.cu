// Mode-0 banded global linear-gap POA fill (global_abpoa.rs:260-427) at
// full width for Hopper (K1).
//
// Replaces the TPU kernel recgraph_tpu/ops/pallas_poa_global2.py:477
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
// pick over the candidates.
//
// The in-row chain.  m[j] = max(A[j], m[j-1] + sm(seq[j], '-')), with
// A = NEG outside the band, is, with G the read's running sum of
// sm(seq[j], '-'),
//
//     m[j] = G[j] + max_{k <= j} (A[k] - G[k]),
//
// a prefix maximum over every column, as the JAX engine computes it
// (poa_engine.py:197-198, no clamp): no range guard is needed.  G depends
// only on the read, so it is computed once and held in registers (in the
// full form, in a scratch row).  Row 0 sums sm('-', seq[j]) instead, which
// differs for an asymmetric table: its G is computed first and row 0 runs
// apart from the loop over the other rows (the same row body, inlined
// twice), which then holds the other rows' G and no case of row 0's.
//
// Design (K2's, poa_local.cu, with K4's band, poa_gap_global.cu; one form
// a launch, cuda_poa_gap_local.plan):
// - A read runs on one block of w warps (w = 1 for reads up to 224
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
// - Reads past 16 warps x 224 columns take the full form: every row's m
//   in the scratch, G in one more scratch row, the row in windows of 16
//   warps x 9 columns a lane.
// - A warp stages its segment of the plane (and m where the row is
//   stored) in shared memory, two buffers by row parity, and writes it
//   with coalesced 16-byte stores (4-byte ones where Lp is not a multiple
//   of 4).
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
  int S;                 // scratch rows a read (the full form: n rows and G's)
  int* ms;               // [B, S, Lp]
  int* bsp;              // [B, n] each row's best column
  int* mfirst;           // [B, n] each row's m at its band start (clamped into [0, Lp))
  int* mlast;            // [B, n] each row's m at right - 1 (clamped into [0, Lp))
  int* score;
  int* last_row;
  int* last_col;
  int* packed;           // [B, n, Lp]
  int* lefts;
  int* rights;
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

// ONE: one warp a read, known when compiling; ALL: the full form.
template <int CW, bool ALL, bool ONE>
__global__ void __launch_bounds__(ONE ? 32 : GC_THREADS, ONE ? GC_ONE_BLOCKS : 1)
    poa_global_warp_kernel(const GcArgs a) {
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
  const int L = a.L[b], bta = a.bta[b];
  const int* sb = a.seq + (size_t)b * Lp;
  const size_t plane = (size_t)b * n * Lp;
  const size_t brow = (size_t)b * n;
  int* st2 = reinterpret_cast<int*>(s_dyn) + (size_t)wi * 2 * GC_PLANES * SEG;
  const int win = w * SEG;                          // columns a window
  const int nwin = ALL ? (Lp + win - 1) / win : 1;
  const bool vec = (Lp & 3) == 0;
  int* msb = a.ms + (size_t)b * a.S * Lp;
  int* gsb = msb + (size_t)(a.S - 1) * Lp;          // the full form's G row

  // G at the lane's columns (the full form: into its scratch row, window by
  // window): the running sum of sm('-', seq[j]) for row 0, else of
  // sm(seq[j], '-')
  int gv[CW];
  auto sums = [&](bool row0) {
    int gcarry = 0;   // G before the window
    for (int t = 0; t < nwin; ++t) {
      const int j0 = t * win + wi * SEG + lane * CW;
      int sum = 0;
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int sj = j0 + c < Lp ? sb[j0 + c] : GAP;
        sum += row0 ? s_table[GAP * NCODE + sj] : s_table[sj * NCODE + GAP];
        gv[c] = sum;
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
      }
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        gv[c] += carry;
        if (ALL && j0 + c < Lp) gsb[j0 + c] = gv[c];
      }
    }
    if (w > 1) __syncthreads();   // s_tot and the G row are read
  };
  sums(true);

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
    for (int k = lane; k < SEG && c0 + k < Lp; k += 32)
      a.packed[plane + (size_t)(n - 1) * Lp + c0 + k] = 0;
  }

  // row i-1 in registers: m at the lane's columns, m left of the warp's
  // segment (lane 0 of warps past the first), band, best column and m at
  // its band start (one warp a read)
  int mu[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) mu[c] = NEG;
  int m_left = NEG, left_u = 0, right_u = 0, bsp_u = 0, mf_u = 0;

  // the row's tables, loaded a row ahead, and the band and best column of
  // slots 0 and 1 where they are far rows
  int code_n = a.codes[0], minp_n = a.min_pred[0], r_n = a.r_values[0];
  int store_n = a.store_at[0];
  int pq0_n = -1, pq1_n = -1, sq0_n = -1, sq1_n = -1;
  int fl[2] = {0, 0}, fr[2] = {0, 0}, fb[2] = {0, 0};
  // row i; row 0 runs apart, on its own G, so that the loop over the other
  // rows carries neither its G's sums nor its cases
  auto row = [&](const int i) __attribute__((always_inline)) {
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
    // column left's value: the left == 0 base case m[min_pred] at its band
    // start + gap (":74-77"), else at least the j == 0 / left > 0 fallback
    // sm(seq[left], '-') (i + left) (":85", from the code of the lane that
    // holds column left); no D covers a column: gap (i + left)
    int base0 = 0;
    if (i > 0 && left == 0)
      base0 = (ONE && minp == i - 1 ? mf_u : a.mfirst[brow + minp]) + gnode;
    const int d_none = gnode * (i + left);
    const int jf = min(left, Lp - 1), jr = min(max(right - 1, 0), Lp - 1);

    int wcarry = INT_MIN;            // the max of A - G over the windows before
    long long wbest = LLONG_MIN;     // the warp's best (value, last column) of the row
    for (int t = 0; t < nwin; ++t) {
      const int c0 = t * win + wi * SEG;   // the warp's first column
      const int j0 = c0 + lane * CW;       // the lane's first column
      const int kpar = ALL ? ((i * nwin + t) & 1) : rpar;
      if (ALL) st = st2 + kpar * GC_PLANES * SEG;
      unsigned cr = codes_reg;
      int ml = 0;   // row i-1's m at j0 - 1
      if (ALL) {
        cr = 0;
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int j = j0 + c;
          cr |= (unsigned)(j < Lp ? sb[j] : GAP) << (3 * c);
          gv[c] = j < Lp ? gsb[j] : 0;
        }
      } else {
        ml = __shfl_up_sync(FULL, mu[CW - 1], 1);
        if (lane == 0) ml = m_left;
      }

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
              gc_load_row<CW>(msb + (size_t)(p == i - 1 ? i - 1 : q == 0 ? sq0 : sq1) * Lp, j0,
                              Lp, vm);
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
              gc_load_row<CW>(msb + (size_t)si[q] * Lp, j0, Lp, vm);
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
          av[c] = left <= j && j < right ? A : NEG;
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
      // and best column, while this row finishes
      if (i + 1 < n - 1) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int p = q == 0 ? pq0_n : pq1_n;
          if (q < Pm && p >= 0 && p != i) {
            fl[q] = a.lefts[brow + p];
            fr[q] = a.rights[brow + p];
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
        mprev = jl < left || jl >= right ? NEG : gprev + P;
      }
      if (!ALL && w > 1 && lane == 0) m_left = mprev;   // row i's m at j0 - 1
      int lbv = INT_MIN, lbj = 0;   // the lane's best (value, last column)
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int j = j0 + c;
        const int sj = (cr >> (3 * c)) & 7;
        const bool in_band = left <= j && j < right;
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
        if (j < Lp && mrow >= lbv) { lbv = mrow; lbj = j; }
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
      const int len = min(SEG, Lp - c0);
      if (len > 0) {
        const size_t at = plane + (size_t)i * Lp + c0;
        const int sr = ALL ? i : store;
        int* const dst[GC_PLANES] = {a.packed + at, msb + (size_t)max(sr, 0) * Lp + c0};
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
      __syncthreads();   // also publishes the row's scratch and planes
      key = s_best[0];
      for (int v = 1; v < w; ++v) key = max(key, s_best[v]);
      __syncthreads();   // s_best is read
    }
    left_u = left;
    right_u = right;
    bsp_u = (int)key_tie(key);
    if (threadIdx.x == 0) {
      a.lefts[brow + i] = left;
      a.rights[brow + i] = right;
      a.bsp[brow + i] = bsp_u;
    }
    if (w == 1) __syncwarp();   // publishes the row's scratch, band and best column
  };
  row(0);
  sums(false);   // the other rows' G
  for (int i = 1; i < n - 1; ++i) row(i);

  if (w > 1) __syncthreads(); else __syncwarp();
  if (threadIdx.x == 0) {
    a.lefts[brow + n - 1] = 0;
    a.rights[brow + n - 1] = 0;
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

template <int CW, bool ALL, bool ONE>
int global_launch(const GcArgs& a, cudaStream_t stream) {
  const int threads = 32 * a.warps;
  const int smem = threads / 32 * 2 * GC_PLANES * 32 * CW * (int)sizeof(int);
  auto kern = poa_global_warp_kernel<CW, ALL, ONE>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<a.B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int CW>
int global_chain(const GcArgs& a, cudaStream_t stream) {
  return a.warps == 1 ? global_launch<CW, false, true>(a, stream)
                      : global_launch<CW, false, false>(a, stream);
}

}  // namespace rgt

// cw: the columns a lane (1, 3, 5 or 7; 9 in the full form); warps: the
// warps a read, one read a block (1 to 16; 16 in the full form); full:
// every row's m in the scratch (S = n + 1: G's row last).
extern "C" int rgt_poa_global_fill(
    const int* seq, const int* L, const int* bta, const int* table, const int* codes,
    const int* pred_idx, const int* min_pred, const int* r_values, const int* cand,
    const int* srow, const int* store_at, int n_cand, int B, int n, int Pm, int Lp, int cw,
    int warps, int full, int S, int* ms, int* bsp, int* mfirst, int* mlast, int* score,
    int* last_row, int* last_col, int* packed, int* lefts, int* rights, void* stream) {
  using namespace rgt;
  if (B < 1 || n < 3 || Pm < 1 || Pm > 4095 || Lp < 1 || S < 1 || n_cand < 1 || warps < 1 ||
      warps > GC_MAX_WARPS || 32 * warps > GC_THREADS || (!full && Lp > 32 * cw * warps) ||
      (full && (cw != 9 || warps != GC_MAX_WARPS || S != n + 1)))
    return (int)cudaErrorInvalidValue;
  const GcArgs a{seq, L, bta, table, codes, min_pred, r_values, pred_idx, srow, store_at, cand,
                 n_cand, B, n, Pm, Lp, warps, S, ms, bsp, mfirst, mlast, score, last_row,
                 last_col, packed, lefts, rights};
  const cudaStream_t s = (cudaStream_t)stream;
  if (full) return global_launch<9, true, false>(a, s);
  switch (cw) {
    case 1: return global_chain<1>(a, s);
    case 3: return global_chain<3>(a, s);
    case 5: return global_chain<5>(a, s);
    case 7: return global_chain<7>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rgt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
