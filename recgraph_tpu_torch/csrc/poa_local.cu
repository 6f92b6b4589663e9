// Mode-1 local linear-gap POA fill (local_poa.rs:181-255) for Hopper, one
// kernel body in three forms known when compiling (FORM): K2's layout
// [B, n, Lp] (K2), the rows-first layout of the TPU's earlier generations
// (ROWS: K13, K15 and K17) and the rows-first score plane without
// directions (SCORES: K16).
//
// K2 replaces the TPU kernel recgraph_tpu/ops/pallas_poa_v5.py:251
// fill_local_v5 and computes what poa_engine._fill_local
// (recgraph_tpu/ops/poa_engine.py:553-643) computes, bit for bit: the
// transposed scoring table (sm(seq[j], lnz[i]), sm('-', lnz[i])), the zero
// floor, start rows whose first-best sweeps over the predecessor slots
// begin at 0 / index 0, non-start rows from row i-1, tie order D >= U >= L
// with all-negative cells as O, column 0 and the columns past the read as
// O, and the row-major running best that moves on a strictly greater row
// maximum (first column).  It stores packed int32[B, n, Lp] (row n-1 all
// 0).  K13 replaces recgraph_tpu/ops/pallas_poa.py:217 fill_local and K15
// recgraph_tpu/ops/pallas_poa_v2.py:182 fill_local_v2: K2's function with
// packed in the layout [n_store, B, Lp] (K13: n_store = n, int32; K15:
// n_store = 8 ceil(n / 8), int32 or int16).  K17 replaces
// tools/pallas_poa_v4.py:218 fill_local_v4: ROWS at n_store =
// 8 ceil((n - 1) / 8), int32 (n_store = n - 1 where (n - 1) % 8 == 0: row
// n-1 is then not stored and nothing is zeroed past the rows).  K16
// replaces tools/pallas_poa_v3.py:137 fill_local_scores: the score plane m
// int32[n_store, B, Lp] at K17's n_store, rows first, as the output and no
// packed plane (SCORES).
//
// The rows-first layout (ROWS).  Row i of read b goes to packed at
// (i B + b) Lp, of element type PT (int or short); rows 0 and n-1 ..
// n_store-1 are zero, written by the read's own block.  K13's layout is
// K15's at n_store = n and int32, so the two share one form.  int16
// cells are staged as int32 (exact: the wrapper refuses n >= 2,048 and
// max |table| x Lp >= 16k) and keep their low 16 bits in the flush
// (warp_flush_i16), 8 cells a 16-byte store where Lp % 8 == 0, else 2
// a 4-byte store where Lp is even, else one a 2-byte store: the wrapper
// passes the width (i16).  m, the scratch, stays int32.
//
// The score plane (SCORES).  Row i's m (0 at column 0, NEG past the read;
// row 0 and rows n-1 .. n_store-1 zero) goes to (i B + b) Lp.  A row
// keeps the first-best sweeps that A needs and computes m and the row
// best; the direction work (slot indices, L, the cell) is not done, and
// one plane (m) is staged.  Every row of m is in the output, so a start
// row reads its far predecessors (and the full form row i-1) there, at
// row stride B Lp, and the scratch holds only the full form's G row (S =
// 1).  (Writing them to K2's stored-rows scratch as well, and reading
// them there, was 8-13 % slower at 3,047 x 152: H100 80GB HBM3, 700 W.)
//
// The in-row chain.  m[j] = max(A[j], m[j-1] + sm(seq[j], '-')) with
// A[j] = max(D[j], U[j], 0) (A[0] = 0) is, with G the read's running sum
// of sm(seq[j], '-'),
//
//     m[j] = G[j] + max_{k <= j} (A[k] - G[k]),
//
// a prefix maximum, as the JAX engine computes it (poa_engine.py:590-591,
// no clamp): no range guard is needed.  G depends only on the read, so it
// is computed once, before the rows, and held in registers (in the full
// form, in a scratch row).
//
// Design (K5's, poa_gap_local.cu, with one plane; cuda_poa_gap_local.plan
// lays out the launch, one form a launch):
// - A read runs on one block of w warps (w = 1 for reads up to 224
//   columns), each lane holding CW = 1, 3, 5 or 7 contiguous columns in
//   registers.  A row is one pass that computes each column's A - G, a
//   warp max scan (plus, for w > 1, the warp totals through shared memory
//   and one block barrier), and a pass that applies the carry to the
//   lane's columns and writes their cells.  m at the lane's first column
//   minus one is G there plus the prefix before the lane, so no neighbour
//   exchange is needed.  The row best is two warp reductions (value,
//   first column); for w > 1 each warp's best goes through shared memory
//   and is folded in after the next barrier.  No block barrier with
//   w = 1, one a row with w > 1.
// - Row i-1's m stays in registers: a non-start row (its one predecessor
//   is row i-1) reads nothing from memory.  Only rows that a start row
//   lists as a predecessor other than its row i-1 are written to a device
//   scratch (store_at[row] >= 0, cuda_poa_gap_local.stored_rows, K5's
//   rule), read in the start row's first pass.  (Loading them a row
//   ahead, as K5 does, spilled registers past the 80 this form has and
//   was 1-3 % slower on stretch chunks: H100 80GB HBM3, 700 W.)
// - Reads past 16 warps x 224 columns take the full form: every row's m
//   in the scratch, G in one more scratch row, the row in windows of 16
//   warps x 9 columns a lane.
// - A warp stages its segment of the plane (and m where the row is
//   stored) in shared memory, two buffers by row parity, and writes it
//   with coalesced 16-byte stores (4-byte ones where Lp is not a multiple
//   of 4).
//
// What bounds it on this card: the bytes of the packed plane (4 a cell,
// 2 in K15's int16 form; K16's m plane 4) plus 4 a cell of the stored
// rows (none in K16); as in K5 a
// row's latency rules (the rows of a read are sequential, a row a serial
// chain of one warp).  The one-warp form is compiled for 24 blocks an SM,
// so a stretch chunk of 3,047 reads is resident at once on 132 SMs.
//
// The kernel allocates nothing, does not synchronise with the host and
// runs on the stream it is given.

#include "poa_common.cuh"

namespace rgt {

constexpr int LC_THREADS = 512;   // threads a block at most
constexpr int LC_PLANES = 2;      // staged: packed, m
constexpr int LC_MAX_WARPS = 16;  // warps a read
constexpr int LC_ONE_BLOCKS = 24; // one-warp blocks an SM (85 registers a thread)

// the forms: K2 ([B, n, Lp]), K13, K15 and K17 (rows first, [n_store, B,
// Lp]), K16 (m rows first, [n_store, B, Lp])
enum : int { LC_K2 = 0, LC_ROWS = 1, LC_SCORES = 2 };


struct LcArgs {
  const int* seq;         // [B, Lp]
  const int* L;           // [B]
  const int* table;       // [7, 7]
  const int* codes;       // [n]
  const int* node_start;  // [n]
  const int* pred_idx;    // [n, Pm] -1 padded
  const int* srow;        // [n, Pm] scratch row of each slot's predecessor, -1 for none
  const int* store_at;    // [n] scratch row a row is written to, -1 for none
  int B, n, Pm, Lp;
  int warps;              // warps a read (a block)
  int S;                  // scratch rows a read (the full form: n rows and G's)
  int* ms;                // [B, S, Lp]
  int* best_val;
  int* best_i;
  int* best_j;
  int* packed;            // int32[B, n, Lp]; ROWS: int32 or int16 [n_store, B, Lp];
                          // SCORES: m int32[n_store, B, Lp]
};

// A stored row's m at the lane's columns j0 - 1 .. j0 + CW - 1 (0 outside
// the read's width).
template <int CW>
__device__ __forceinline__ void lc_load_row(const int* mp, int j0, int Lp, int (&vm)[CW + 1]) {
  vm[0] = j0 > 0 && j0 <= Lp ? mp[j0 - 1] : 0;
#pragma unroll
  for (int c = 0; c < CW; ++c) vm[c + 1] = j0 + c < Lp ? mp[j0 + c] : 0;
}

// One slot q of a start row's first-best sweeps over its predecessors, in
// slot order; padding slots read NEG at index 0.
template <int CW>
__device__ __forceinline__ void lc_slot(int q, int j0, const int (&vm)[CW + 1], int (&dpre)[CW],
                                        int (&um)[CW], int (&dq)[CW], int (&uq)[CW]) {
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    const int vd = j0 + c > 0 ? vm[c] : NEG;
    if (q == 0 || vd > dpre[c]) { dpre[c] = vd; dq[c] = q; }
    if (q == 0 || vm[c + 1] > um[c]) { um[c] = vm[c + 1]; uq[c] = q; }
  }
}

// ONE: one warp a read, known when compiling; ALL: the full form; FORM:
// LC_K2, LC_ROWS or LC_SCORES; PT: packed's element type (int, or short
// in ROWS).  ROWS and SCORES: n_store, the rows of the output (rows n-1 ..
// n_store-1 zero), and at
// int16 i16, the cells a store (8, 2 or 1).  (They are kernel arguments
// beside LcArgs: a larger LcArgs changed K2's registers.)
template <int CW, bool ALL, bool ONE, int FORM, typename PT>
__global__ void __launch_bounds__(ONE ? 32 : LC_THREADS, ONE ? LC_ONE_BLOCKS : 1)
    poa_local_kernel(const LcArgs a, const int n_store, const int i16) {
  constexpr bool SCORES = FORM == LC_SCORES;
  constexpr bool ROWS = FORM != LC_K2;                 // rows first
  constexpr int NPL = SCORES ? 1 : LC_PLANES;          // staged planes
  constexpr int MPL = NPL - 1;                         // m's staged plane
  __shared__ int s_table[NCODE * NCODE];
  __shared__ int s_tot[2][32];
  __shared__ long long s_best[2][32];
  extern __shared__ int4 s_dyn[];

  constexpr int SEG = 32 * CW;
  const int w = ONE ? 1 : a.warps, wi = ONE ? 0 : threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  for (int t = threadIdx.x; t < NCODE * NCODE; t += blockDim.x) s_table[t] = a.table[t];
  __syncthreads();

  const int n = a.n, Lp = a.Lp, Pm = a.Pm;
  const int L = a.L[b];
  const int* sb = a.seq + (size_t)b * Lp;
  const size_t plane = (size_t)b * n * Lp;
  // row i's column j in packed: [B, n, Lp], or (ROWS) [n_store, B, Lp]
  auto cell = [&](int i, size_t j) -> PT* {
    if constexpr (ROWS) {
      return reinterpret_cast<PT*>(a.packed) + ((size_t)i * a.B + b) * Lp + j;
    } else {
      return reinterpret_cast<PT*>(a.packed) + (plane + (size_t)i * Lp + j);
    }
  };
  int* st2 = reinterpret_cast<int*>(s_dyn) + (size_t)wi * 2 * NPL * SEG;
  const int win = w * SEG;                          // columns a window
  const int nwin = ALL ? (Lp + win - 1) / win : 1;
  const bool vec = (Lp & 3) == 0;
  int* msb = a.ms + (size_t)b * a.S * Lp;
  int* gsb = msb + (size_t)(a.S - 1) * Lp;          // the full form's G row
  // row p's m: scratch row s, or (SCORES) row p of the output
  auto m_at = [&](int p, int s) -> const int* {
    if constexpr (SCORES) {
      return reinterpret_cast<const int*>(cell(p, 0));
    } else {
      return msb + (size_t)s * Lp;
    }
  };

  // G, the running sum of sm(seq[j], '-'), at the lane's columns (the full
  // form: into its scratch row, window by window); the read's codes
  int gv[CW];
  unsigned codes_reg = 0;   // the register form's read codes, 3 bits a column
  {
    int gcarry = 0;   // G before the window
    for (int t = 0; t < nwin; ++t) {
      const int c0 = t * win + wi * SEG;
      const int j0 = c0 + lane * CW;
      int sum = 0;
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int sj = j0 + c < Lp ? sb[j0 + c] : GAP;
        if (!ALL) codes_reg |= (unsigned)sj << (3 * c);
        sum += s_table[sj * NCODE + GAP];
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
  }

  // rows 0 and n-1 (ROWS: n-1 .. n_store-1 after the rows, where the
  // loop over them costs no registers): all 0 and 'O'; row 0's scratch
  // copy, if any, 0
  {
    const int s0 = a.store_at[0];
    for (int t = 0; t < nwin; ++t) {
      const int c0 = t * win + wi * SEG;
      for (int k = lane; k < SEG && c0 + k < Lp; k += 32) {
        const size_t j = c0 + k;
        *cell(0, j) = 0;
        if constexpr (!ROWS) *cell(n - 1, j) = 0;
        if (!SCORES && s0 >= 0) msb[(size_t)s0 * Lp + j] = 0;
      }
    }
  }
  if (w > 1) __syncthreads(); else __syncwarp();

  // the register form's row i-1 (row 0: all 0) and its m left of the
  // warp's segment (lane 0 of warps past the first)
  int mu[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) mu[c] = 0;
  int m_left = 0;

  int bv = 0, bi = 0, bj = 0;   // the running best (w = 1: every lane; else thread 0)
  // the row's tables, loaded a row ahead: code, start flag, scratch row,
  // and the first two slots' predecessors and scratch rows
  int code_n = a.codes[1], start_n = a.node_start[1], store_n = a.store_at[1];
  int pq0_n = a.pred_idx[Pm], sq0_n = a.srow[Pm];
  int pq1_n = Pm > 1 ? a.pred_idx[Pm + 1] : -1, sq1_n = Pm > 1 ? a.srow[Pm + 1] : -1;
  for (int i = 1; i < n - 1; ++i) {
    const int code = code_n, store = store_n, pq0 = pq0_n, pq1 = pq1_n;
    const bool is_start = start_n != 0;
    const int sq0 = sq0_n, sq1 = sq1_n;
    if (i + 1 < n - 1) {
      code_n = a.codes[i + 1];
      start_n = a.node_start[i + 1];
      store_n = a.store_at[i + 1];
      pq0_n = a.pred_idx[(size_t)(i + 1) * Pm];
      sq0_n = a.srow[(size_t)(i + 1) * Pm];
      if (Pm > 1) {
        pq1_n = a.pred_idx[(size_t)(i + 1) * Pm + 1];
        sq1_n = a.srow[(size_t)(i + 1) * Pm + 1];
      }
    }
    const int* pi = a.pred_idx + (size_t)i * Pm;
    const int* si = a.srow + (size_t)i * Pm;
    const int gnode = s_table[GAP * NCODE + code];   // transposed: sm('-', lnz[i])
    const int rpar = i & 1;
    int* st = st2 + rpar * NPL * SEG;   // staging, by row parity

    int wcarry = INT_MIN;            // the max of A - G over the windows before
    long long wbest = LLONG_MIN;     // the warp's best (value, first column) of the row
    for (int t = 0; t < nwin; ++t) {
      const int c0 = t * win + wi * SEG;   // the warp's first column
      const int j0 = c0 + lane * CW;       // the lane's first column
      const int kpar = ALL ? ((i * nwin + t) & 1) : rpar;
      if (ALL) st = st2 + kpar * NPL * SEG;
      unsigned cr = codes_reg;
      int ml;   // row i-1's m at j0 - 1
      if (ALL) {
        cr = 0;
        const int* mp = m_at(i - 1, i - 1);
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int j = j0 + c;
          const bool live = j < Lp;
          cr |= (unsigned)(live ? sb[j] : GAP) << (3 * c);
          mu[c] = live ? mp[j] : 0;
          gv[c] = live ? gsb[j] : 0;
        }
        ml = j0 > 0 && j0 <= Lp ? mp[j0 - 1] : 0;
      } else {
        ml = __shfl_up_sync(FULL, mu[CW - 1], 1);
        if (lane == 0) ml = m_left;
      }

      // pass 1: each column's D and U values, and A - G for the chain
      int dv[CW], uv[CW], pk[CW];
      if (is_start) {
        int dpre[CW], um[CW], dq[CW], uq[CW];
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          dpre[c] = um[c] = NEG;
          dq[c] = uq[c] = 0;
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q >= Pm) break;
          const int p = q == 0 ? pq0 : pq1;
          int vm[CW + 1];   // vm[c + 1]: m[p][j0 + c]; vm[0]: m[p][j0 - 1]
          if (p < 0) {
#pragma unroll
            for (int c = 0; c <= CW; ++c) vm[c] = NEG;
          } else if (!ALL && p == i - 1) {
            vm[0] = ml;
#pragma unroll
            for (int c = 0; c < CW; ++c) vm[c + 1] = mu[c];
          } else {
            lc_load_row<CW>(m_at(p, q == 0 ? sq0 : sq1), j0, Lp, vm);
          }
          lc_slot<CW>(q, j0, vm, dpre, um, dq, uq);
        }
        for (int q = 2; q < Pm; ++q) {
          const int p = pi[q];
          int vm[CW + 1];
          if (p < 0) {
#pragma unroll
            for (int c = 0; c <= CW; ++c) vm[c] = NEG;
          } else if (!ALL && p == i - 1) {
            vm[0] = ml;
#pragma unroll
            for (int c = 0; c < CW; ++c) vm[c + 1] = mu[c];
          } else {
            lc_load_row<CW>(m_at(p, si[q]), j0, Lp, vm);
          }
          lc_slot<CW>(q, j0, vm, dpre, um, dq, uq);
        }
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int sj = (cr >> (3 * c)) & 7;
          dv[c] = max(dpre[c], 0) + s_table[sj * NCODE + code];
          uv[c] = max(um[c], 0) + gnode;
          pk[c] = dq[c] | uq[c] << 12 | (int)(dpre[c] > 0) << 24 | (int)(um[c] > 0) << 25;
        }
      } else {
        // non-start rows: row i-1 alone
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int sj = (cr >> (3 * c)) & 7;
          dv[c] = (j0 + c > 0 ? (c > 0 ? mu[c - 1] : ml) : NEG) + s_table[sj * NCODE + code];
          uv[c] = mu[c] + gnode;
          pk[c] = 0;
        }
      }
      // the lane's max of A - G, then the warp's exclusive prefix
      int lmax = INT_MIN;
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int A = j0 + c == 0 ? 0 : max(max(dv[c], uv[c]), 0);
        lmax = max(lmax, A - gv[c]);
      }
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
        if (threadIdx.x == 0 && t == 0 && i > 1) {   // the previous row's best
          long long k = LLONG_MIN;
          for (int v = 0; v < w; ++v) k = max(k, s_best[rpar ^ 1][v]);
          const int rmax = key_value(k);
          if (rmax > bv) {
            bv = rmax;
            bi = i - 1;
            bj = (int)(0x7fffffffu - key_tie(k));
          }
        }
        const int tv = lane < w ? s_tot[kpar][lane] : INT_MIN;
        carry = max(wcarry, __reduce_max_sync(FULL, lane < wi ? tv : INT_MIN));
        wcarry = max(wcarry, __reduce_max_sync(FULL, tv));
      }
      // pass 2: m at each column from the running prefix, and the cells
      int P = max(carry, excl);
      int mprev;   // m at j0 - 1: G there plus the prefix before the lane
      {
        const int jl = j0 - 1;
        const int gl = gv[0] - s_table[((cr & 7) * NCODE) + GAP];
        mprev = jl <= 0 ? (jl == 0 ? 0 : NEG) : jl >= L ? NEG : gl + P;
      }
      if (!ALL && w > 1 && lane == 0) m_left = mprev;   // row i's m at j0 - 1
      int lbv = INT_MIN, lbj = 0;
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int j = j0 + c;
        const int sj = (cr >> (3 * c)) & 7;
        const int A = j == 0 ? 0 : max(max(dv[c], uv[c]), 0);
        P = max(P, A - gv[c]);
        const bool valid = j < L;
        const int mrow = j == 0 ? 0 : valid ? gv[c] + P : NEG;
        const int l_val = mprev + s_table[sj * NCODE + GAP];
        int didx = i - 1, uidx = i - 1;
        if (is_start) {   // uniform over the warp
          const int pkc = pk[c];
          const int dq = pkc & 0xfff, uq = (pkc >> 12) & 0xfff;
          didx = (pkc >> 24) & 1 ? max(dq == 0 ? pq0 : dq == 1 ? pq1 : pi[dq], 0) : 0;
          uidx = (pkc >> 25) & 1 ? max(uq == 0 ? pq0 : uq == 1 ? pq1 : pi[uq], 0) : 0;
        }
        // directions, zero floor (local_poa.rs:222-233); D >= U >= L
        const bool d_ge_u = dv[c] >= uv[c];
        const bool isD = d_ge_u && dv[c] >= l_val;
        const bool isU = !d_ge_u && uv[c] >= l_val;
        const int cell = isD ? didx * 16 + (sj == code ? DIR_D : DIR_LOW_D)
                       : isU ? uidx * 16 + DIR_U : i * 16 + DIR_L;
        const bool off = j == 0 || !valid || (dv[c] < 0 && uv[c] < 0 && l_val < 0);
        const bool better = valid && mrow > lbv;
        lbj = better ? j : lbj;
        lbv = better ? mrow : lbv;
        const int k = lane * CW + c;
        if constexpr (!SCORES) st[k] = off ? 0 : cell;   // SCORES: no direction work
        st[MPL * SEG + k] = mrow;
        if (!ALL) mu[c] = mrow;
        mprev = mrow;
      }

      // the row's best: the warp's (value, first column), then the row's
      const int vmax = __reduce_max_sync(FULL, lbv);
      const unsigned jmin = __reduce_min_sync(FULL, lbv == vmax ? (unsigned)lbj : 0xffffffffu);
      if (vmax != INT_MIN) {
        const long long key = make_key(vmax, 0x7fffffffu - jmin);
        wbest = key > wbest ? key : wbest;
      }

      // the staged segment to the plane (and the scratch), coalesced; the
      // staging alternates between two buffers, so one __syncwarp a row
      __syncwarp();
      const int len = min(SEG, Lp - c0);
      if (len > 0) {
        const int sr = ALL ? i : store;
        if constexpr (SCORES) {   // K16: m to its output row only
          int* const dm[1] = {cell(i, c0)};
          if (vec) {
            warp_flush<SEG, true>(st, len, 1, dm, lane);
          } else {
            warp_flush<SEG, false>(st, len, 1, dm, lane);
          }
        } else if constexpr (sizeof(PT) == 2) {   // K15 at int16: the cells packed, then m
          PT* const d = cell(i, c0);
          if (i16 == 8) {
            warp_flush_i16<SEG, 8>(st, len, d, lane);
          } else if (i16 == 2) {
            warp_flush_i16<SEG, 2>(st, len, d, lane);
          } else {
            warp_flush_i16<SEG, 1>(st, len, d, lane);
          }
          if (sr >= 0) {
            int* const dm[1] = {msb + (size_t)sr * Lp + c0};
            if (vec) {
              warp_flush<SEG, true>(st + SEG, len, 1, dm, lane);
            } else {
              warp_flush<SEG, false>(st + SEG, len, 1, dm, lane);
            }
          }
        } else {
          int* const dst[LC_PLANES] = {cell(i, c0), msb + (size_t)max(sr, 0) * Lp + c0};
          if (vec) {
            warp_flush<SEG, true>(st, len, sr >= 0 ? 2 : 1, dst, lane);
          } else {
            warp_flush<SEG, false>(st, len, sr >= 0 ? 2 : 1, dst, lane);
          }
        }
      }
    }

    if (w == 1) {
      const int rmax = key_value(wbest);
      if (wbest != LLONG_MIN && rmax > bv) {
        bv = rmax;
        bi = i;
        bj = (int)(0x7fffffffu - key_tie(wbest));
      }
    } else {
      if (lane == 0) s_best[rpar][wi] = wbest;
      if (ALL) __syncthreads();   // publishes the row's scratch to every warp
    }
  }

  if constexpr (ROWS) {
    for (int t = 0; t < nwin; ++t) {
      const int c0 = t * win + wi * SEG;
      for (int k = lane; k < SEG && c0 + k < Lp; k += 32)
        for (int r = n - 1; r < n_store; ++r) *cell(r, c0 + k) = 0;
    }
  }

  if (w > 1) {
    __syncthreads();
    if (threadIdx.x == 0 && n > 2) {
      long long k = LLONG_MIN;
      for (int v = 0; v < w; ++v) k = max(k, s_best[(n - 2) & 1][v]);
      const int rmax = key_value(k);
      if (rmax > bv) {
        bv = rmax;
        bi = n - 2;
        bj = (int)(0x7fffffffu - key_tie(k));
      }
    }
  }
  if (threadIdx.x == 0) {
    a.best_val[b] = bv;
    a.best_i[b] = bi;
    a.best_j[b] = bj;
  }
}

template <int CW, bool ALL, bool ONE, int FORM, typename PT>
int local_launch(const LcArgs& a, int n_store, int i16, cudaStream_t stream) {
  const int threads = 32 * a.warps;
  const int planes = FORM == LC_SCORES ? 1 : LC_PLANES;
  const int smem = threads / 32 * 2 * planes * 32 * CW * (int)sizeof(int);
  auto kern = poa_local_kernel<CW, ALL, ONE, FORM, PT>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<a.B, threads, smem, stream>>>(a, n_store, i16);
  return (int)cudaGetLastError();
}

template <int CW, int FORM, typename PT>
int local_chain(const LcArgs& a, int n_store, int i16, cudaStream_t stream) {
  return a.warps == 1 ? local_launch<CW, false, true, FORM, PT>(a, n_store, i16, stream)
                      : local_launch<CW, false, false, FORM, PT>(a, n_store, i16, stream);
}

// The checks and the launch of the three entries.
template <int FORM, typename PT>
int local_entry(const LcArgs& a, int n_store, int i16, int cw, int full, cudaStream_t s) {
  if (a.B < 1 || a.n < 3 || a.Pm < 1 || a.Pm > 4095 || a.Lp < 1 || a.S < 1 || a.warps < 1 ||
      a.warps > LC_MAX_WARPS || 32 * a.warps > LC_THREADS ||
      (!full && a.Lp > 32 * cw * a.warps) ||
      (full && (cw != 9 || a.warps != LC_MAX_WARPS ||
                a.S != (FORM == LC_SCORES ? 1 : a.n + 1))))
    return (int)cudaErrorInvalidValue;
  if (full) return local_launch<9, true, false, FORM, PT>(a, n_store, i16, s);
  switch (cw) {
    case 1: return local_chain<1, FORM, PT>(a, n_store, i16, s);
    case 3: return local_chain<3, FORM, PT>(a, n_store, i16, s);
    case 5: return local_chain<5, FORM, PT>(a, n_store, i16, s);
    case 7: return local_chain<7, FORM, PT>(a, n_store, i16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rgt

// K2.  cw: the columns a lane (1, 3, 5 or 7; 9 in the full form); warps:
// the warps a read, one read a block (1 to 16; 16 in the full form); full:
// every row's m in the scratch (S = n + 1: G's row last).
extern "C" int rgt_poa_local_fill(
    const int* seq, const int* L, const int* table, const int* codes, const int* node_start,
    const int* pred_idx, const int* srow, const int* store_at, int B, int n, int Pm, int Lp,
    int cw, int warps, int full, int S, int* ms, int* best_val, int* best_i, int* best_j,
    int* packed, void* stream) {
  using namespace rgt;
  const LcArgs a{seq, L, table, codes, node_start, pred_idx, srow, store_at, B, n, Pm, Lp,
                 warps, S, ms, best_val, best_i, best_j, packed};
  return local_entry<LC_K2, int>(a, n, 0, cw, full, (cudaStream_t)stream);
}

// K13: K2's arguments and n_store (n), packed int32[n_store, B, Lp].
extern "C" int rgt_poa_local_v1_fill(
    const int* seq, const int* L, const int* table, const int* codes, const int* node_start,
    const int* pred_idx, const int* srow, const int* store_at, int B, int n, int Pm, int Lp,
    int n_store, int cw, int warps, int full, int S, int* ms, int* best_val, int* best_i,
    int* best_j, int* packed, void* stream) {
  using namespace rgt;
  if (n_store < n - 1) return (int)cudaErrorInvalidValue;
  const LcArgs a{seq, L, table, codes, node_start, pred_idx, srow, store_at, B, n, Pm, Lp,
                 warps, S, ms, best_val, best_i, best_j, packed};
  return local_entry<LC_ROWS, int>(a, n_store, 0, cw, full, (cudaStream_t)stream);
}

// K15: K2's arguments, n_store (8 ceil(n / 8)) and i16, packed
// [n_store, B, Lp] of int32 (i16 = 0) or int16 (i16: the cells a store, 8,
// 2 or 1, dividing Lp; the wrapper checks that the values fit).
extern "C" int rgt_poa_local_v2_fill(
    const int* seq, const int* L, const int* table, const int* codes, const int* node_start,
    const int* pred_idx, const int* srow, const int* store_at, int B, int n, int Pm, int Lp,
    int n_store, int i16, int cw, int warps, int full, int S, int* ms, int* best_val,
    int* best_i, int* best_j, void* packed, void* stream) {
  using namespace rgt;
  if (n_store < n - 1 || !(i16 == 0 || i16 == 1 || i16 == 2 || i16 == 8) ||
      (i16 && Lp % i16 != 0))
    return (int)cudaErrorInvalidValue;
  const LcArgs a{seq, L, table, codes, node_start, pred_idx, srow, store_at, B, n, Pm, Lp,
                 warps, S, ms, best_val, best_i, best_j, (int*)packed};
  const cudaStream_t s = (cudaStream_t)stream;
  return i16 ? local_entry<LC_ROWS, short>(a, n_store, i16, cw, full, s)
             : local_entry<LC_ROWS, int>(a, n_store, 0, cw, full, s);
}

// K17: K13's arguments, n_store = 8 ceil((n - 1) / 8), packed
// int32[n_store, B, Lp].
extern "C" int rgt_poa_local_v4_fill(
    const int* seq, const int* L, const int* table, const int* codes, const int* node_start,
    const int* pred_idx, const int* srow, const int* store_at, int B, int n, int Pm, int Lp,
    int n_store, int cw, int warps, int full, int S, int* ms, int* best_val, int* best_i,
    int* best_j, int* packed, void* stream) {
  using namespace rgt;
  if (n_store < n - 1) return (int)cudaErrorInvalidValue;
  const LcArgs a{seq, L, table, codes, node_start, pred_idx, srow, store_at, B, n, Pm, Lp,
                 warps, S, ms, best_val, best_i, best_j, packed};
  return local_entry<LC_ROWS, int>(a, n_store, 0, cw, full, (cudaStream_t)stream);
}

// K16: K13's arguments, n_store = 8 ceil((n - 1) / 8), the score plane m
// int32[n_store, B, Lp] as the output (no packed plane).
extern "C" int rgt_poa_local_scores_fill(
    const int* seq, const int* L, const int* table, const int* codes, const int* node_start,
    const int* pred_idx, const int* srow, const int* store_at, int B, int n, int Pm, int Lp,
    int n_store, int cw, int warps, int full, int S, int* ms, int* best_val, int* best_i,
    int* best_j, int* m, void* stream) {
  using namespace rgt;
  if (n_store < n - 1) return (int)cudaErrorInvalidValue;
  const LcArgs a{seq, L, table, codes, node_start, pred_idx, srow, store_at, B, n, Pm, Lp,
                 warps, S, ms, best_val, best_i, best_j, m};
  return local_entry<LC_SCORES, int>(a, n_store, 0, cw, full, (cudaStream_t)stream);
}
