// Mode-3 affine-gap local POA fill (gap_local_poa.rs:8-129) for Hopper (K5).
//
// Replaces the TPU kernel recgraph_tpu/ops/pallas_gap_local.py:271
// fill_gap_local_v2 and computes what poa_gap_engine._fill_gap_local
// (recgraph_tpu/ops/poa_gap_engine.py:550-686) computes, bit for bit,
// for every sign of the penalties o, e: the transposed scoring table
// (sm(seq[j], lnz[i])), the zero floor, start rows whose first-best
// sweeps begin at 0 / index 0 (ties => Y), non-start rows from row i-1
// (ties => M), the in-row (M, X) recurrence, tie order D >= U >= L with
// all-negative cells as O, three packed planes, and the row-major
// running best that moves on a strictly greater row maximum (first
// column).
//
// The in-row recurrence.  With m[j] = max(c[j], x[j]) and
// x[j] = max(m[j-1] + o + e, x[j-1] + e), x[j] = max(c[j-1] + o + e,
// x[j-1] + g) with g = max(o + e, e): a one-state (max,+) chain with a
// constant step, so
//
//     x[j] = j g + max(0, max_{k < j} w[k]),  w[k] = c~[k] + o + e - (k + 1) g
//
// (c~[0] = 0: column 0 is the (0, 0) state), a prefix maximum.  The 2x2
// map scan of the reference clamps to NEG; the clamp never acts while
// |o| + |e| times the read length stays below 2^27, so the two agree.
// Past that (cuda_poa_gap_local.check_chain_range), the clamped form
// (CLAMP) scans the maps x -> max(x + g, c~[j] + o + e) composed with the
// reference's clamp (poa_common.cuh chain_apply): a map's A is its run's
// steps, known from the run's length, so the warp scan moves B alone and
// the warps' runs compose in order through shared memory.  Both forms
// give the reference's outputs; the clamped one where its clamp acts too,
// since x then only falls below values it is compared with.
//
// Design (one form a launch, cuda_poa_gap_local.plan picks it):
// - A read runs on one block of w warps (w = 1 for reads up to 224
//   columns), each lane holding CW = 1, 3, 5 or 7 contiguous columns
//   in registers (odd, so that the staging has no bank conflicts; 9
//   columns spilled registers in this form).  A row is one pass that
//   computes each column's D and Y candidates and w, a warp max scan
//   (plus, for w > 1, the warp totals through shared memory and one block
//   barrier), and a pass that applies the carry to the lane's columns
//   serially.  The left
//   neighbours of a lane's first column come from one shuffle of its
//   neighbour's column data, not from the neighbour's results.  The row
//   best is two warp reductions (value, first column); for w > 1 each
//   warp's best goes through shared memory and is folded in after the
//   next barrier.  No block barrier with w = 1, one a row with w > 1.
//   The one-warp form is compiled apart (w = 1 known, and the register
//   budget of a 32-thread block: 140 registers at 5 columns a lane
//   where the shared 512-thread bound of the other forms spilled).
// - The register form keeps row i-1's m and y in registers: a non-start
//   row reads nothing from memory.  Only rows that a start row lists as a
//   predecessor other than its row i-1 are written to a device scratch
//   (store_at[row] >= 0, cuda_poa_gap_local.stored_rows); a start row reads
//   those through srow and its row i-1 from registers.
// - Reads past 16 warps x 224 columns take the full form: every row's m
//   and y in a device scratch, the row in windows of 16 warps x 9
//   columns a lane, one barrier a window and one a row.
// - The next row's tables (code, start flag, scratch row, the first two
//   slots) are loaded a row ahead, and with one warp a read and up to 5
//   columns a lane the next row's far predecessors (slots 0 and 1) are
//   loaded during this row's second pass.
// - A warp stages its segment of the three planes (and m, y where the row
//   is stored) in shared memory, two buffers by row parity so that one
//   __syncwarp a row orders them, and writes it with coalesced 16-byte
//   stores (4-byte ones where Lp is not a multiple of 4).  The second
//   pass is branch-free.
//
// What bounds it on this card: the bytes of the three planes (12 a cell)
// plus 8 a cell of the stored rows set the bound (1.52 ms for a stretch
// chunk of 1,241 reads); the kernel runs at ~34 % of it (~13 % on long
// reads; PERF.md), held by a row's latency: the rows of a read are
// sequential, and a row is a serial chain of one warp's instructions,
// with about 2 such warps a scheduler on a stretch chunk.
//
// The kernel allocates nothing, does not synchronise with the host and
// runs on the stream it is given.

#include "poa_common.cuh"

namespace rgt {

constexpr int GL_THREADS = 512;   // threads a block at most
constexpr int GL_PLANES = 5;      // staged: packed, packed_x, packed_y, m, y
constexpr int GL_MAX_WARPS = 16;  // warps a read
// blocks an SM holds of the one-warp form: its register budget (168 a
// thread) keeps a stretch chunk of 1,241 reads resident on 132 SMs
constexpr int GL_ONE_BLOCKS = 12;

struct GlArgs {
  const int* seq;       // [B, Lp]
  const int* L;         // [B]
  const int* table;     // [7, 7]
  const int* codes;     // [n]
  const int* node_start;  // [n]
  const int* pred_idx;  // [n, Pm] -1 padded
  const int* srow;      // [n, Pm] scratch row of each slot's predecessor, -1 for none
  const int* store_at;  // [n] scratch row a row is written to, -1 for none
  int B, n, Pm, Lp, o, e;
  int warps;            // warps a read (a block)
  int S;                // scratch rows a read
  int* ms;              // [B, S, Lp]
  int* ys;
  int* best_val;
  int* best_i;
  int* best_j;
  int* packed;
  int* packed_x;
  int* packed_y;
};

// The first-best sweep of a start row keeps, per column, the slot of its
// D and U arguments and three flags.
__device__ __forceinline__ int gl_pack(int dq, int uq, bool dpos, bool upos, bool py_y) {
  return dq | uq << 12 | (int)dpos << 24 | (int)upos << 25 | (int)py_y << 26;
}

// One slot q of a start row's first-best sweeps over its predecessors,
// in slot order; padding slots read NEG.
template <int CW>
__device__ __forceinline__ void gl_slot(int q, int j0, const int (&vm)[CW + 1],
                                        const int (&vy)[CW], int (&dpre)[CW], int (&um)[CW],
                                        int (&uy)[CW], int (&dq)[CW], int (&uq)[CW],
                                        int (&yq)[CW]) {
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    const int vd = j0 + c > 0 ? vm[c] : NEG;
    if (q == 0 || vd > dpre[c]) { dpre[c] = vd; dq[c] = q; }
    if (q == 0 || vm[c + 1] > um[c]) { um[c] = vm[c + 1]; uq[c] = q; }
    if (q == 0 || vy[c] > uy[c]) { uy[c] = vy[c]; yq[c] = q; }
  }
}

// ONE: one warp a read, known when compiling (no cross-warp code, and
// the register budget of a 32-thread block).  CLAMP: the clamped chain.
template <int CW, bool ALL, bool ONE, bool CLAMP>
__global__ void __launch_bounds__(ONE ? 32 : GL_THREADS, ONE ? GL_ONE_BLOCKS : 1)
    poa_gap_local_kernel(const GlArgs a) {
  __shared__ int s_table[NCODE * NCODE];
  __shared__ int s_tot[2][32], s_part[2][32], s_clast[2][32];
  __shared__ long long s_best[2][32];
  extern __shared__ int4 s_dyn[];

  constexpr int SEG = 32 * CW;
  const int w = ONE ? 1 : a.warps, wi = ONE ? 0 : threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  for (int t = threadIdx.x; t < NCODE * NCODE; t += blockDim.x) s_table[t] = a.table[t];
  __syncthreads();

  const int n = a.n, Lp = a.Lp, Pm = a.Pm, o = a.o, e = a.e, oe = o + e;
  const int g = max(oe, e);
  const int L = a.L[b];
  const int* sb = a.seq + (size_t)b * Lp;
  const size_t plane = (size_t)b * n * Lp;
  int* st2 = reinterpret_cast<int*>(s_dyn) + (size_t)wi * 2 * GL_PLANES * SEG;
  const int win = w * SEG;                          // columns a window
  const int nwin = ALL ? (Lp + win - 1) / win : 1;
  const bool vec = (Lp & 3) == 0;
  int* msb = a.ms + (size_t)b * a.S * Lp;
  int* ysb = a.ys + (size_t)b * a.S * Lp;

  // rows 0 and n-1: all 0 and 'O'; row 0's scratch copy, if any, 0
  {
    const int s0 = a.store_at[0];
    for (int t = 0; t < nwin; ++t) {
      const int c0 = t * win + wi * SEG;
      for (int k = lane; k < SEG && c0 + k < Lp; k += 32) {
        const size_t j = c0 + k;
        a.packed[plane + j] = a.packed_x[plane + j] = a.packed_y[plane + j] = 0;
        const size_t jl = plane + (size_t)(n - 1) * Lp + j;
        a.packed[jl] = a.packed_x[jl] = a.packed_y[jl] = 0;
        if (s0 >= 0) msb[(size_t)s0 * Lp + j] = ysb[(size_t)s0 * Lp + j] = 0;
      }
    }
  }
  if (w > 1) __syncthreads(); else __syncwarp();

  // the register form's row i-1 (row 0: all 0) and its m left of the
  // warp's segment (lane 0 of warps past the first)
  int mu[CW], yu[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) mu[c] = yu[c] = 0;
  int m_left = 0;
  unsigned codes_reg = 0;   // the register form's read codes, 3 bits a column
  if (!ALL) {
    const int j0 = wi * SEG + lane * CW;
#pragma unroll
    for (int c = 0; c < CW; ++c)
      codes_reg |= (unsigned)(j0 + c < Lp ? sb[j0 + c] : GAP) << (3 * c);
  }

  int bv = 0, bi = 0, bj = 0;   // the running best (w = 1: every lane; else thread 0)
  // the row's tables, loaded a row ahead: code, start flag, scratch row,
  // and the first two slots' predecessors and scratch rows
  // the next row's far predecessors prefetched (one warp a read: on
  // several warps their registers would spill)
  constexpr bool PF = ONE && CW <= 5;
  int code_n = a.codes[1], start_n = a.node_start[1], store_n = a.store_at[1];
  int pq0_n = a.pred_idx[Pm], sq0_n = a.srow[Pm];
  int pq1_n = Pm > 1 ? a.pred_idx[Pm + 1] : -1, sq1_n = Pm > 1 ? a.srow[Pm + 1] : -1;
  int fm[2][CW + 1], fy[2][CW];   // PF: the current row's far predecessors (slots 0, 1)
  if (PF && start_n) {   // row 1's predecessors are row 0, kept in registers; any other is far
    const int j0 = wi * SEG + lane * CW;
    if (pq0_n > 0) load_row<CW>(msb + (size_t)sq0_n * Lp, ysb + (size_t)sq0_n * Lp, j0, Lp,
                                   fm[0], fy[0]);
    if (pq1_n > 0) load_row<CW>(msb + (size_t)sq1_n * Lp, ysb + (size_t)sq1_n * Lp, j0, Lp,
                                   fm[1], fy[1]);
  }
  for (int i = 1; i < n - 1; ++i) {
    const int code = code_n, store = store_n, pq0 = pq0_n, pq1 = pq1_n;
    const bool is_start = start_n != 0;
    int sq0 = sq0_n, sq1 = sq1_n;
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
    const int* sub_col = s_table + code;   // sm(seq[j], lnz[i]) = table[seq[j]][code]
    const int rpar = i & 1;
    int* st = st2 + rpar * GL_PLANES * SEG;   // staging, by row parity

    // fast: the max of w over the windows before; clamped: the state x
    // entering the window (x[0] = 0)
    int wcarry = 0;
    // the previous window's last column (ALL): its prefix before it (fast)
    // or its x (clamped), and its c
    int left_p = 0, left_c = 0;
    long long wbest = LLONG_MIN;     // the warp's best (value, first column) of the row
    for (int t = 0; t < nwin; ++t) {
      const int c0 = t * win + wi * SEG;   // the warp's first column
      const int j0 = c0 + lane * CW;       // the lane's first column
      const int kpar = ALL ? ((i * nwin + t) & 1) : rpar;
      if (ALL) st = st2 + kpar * GL_PLANES * SEG;
      unsigned cr = codes_reg;
      int ml;   // row i-1's m at j0 - 1
      if (ALL) {
        cr = 0;
        const int* mp = msb + (size_t)(i - 1) * Lp;
        const int* yp = ysb + (size_t)(i - 1) * Lp;
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int j = j0 + c;
          const bool live = j < Lp;
          cr |= (unsigned)(live ? sb[j] : GAP) << (3 * c);
          mu[c] = live ? mp[j] : 0;
          yu[c] = live ? yp[j] : 0;
        }
        ml = j0 > 0 && j0 <= Lp ? mp[j0 - 1] : 0;
      } else {
        ml = __shfl_up_sync(FULL, mu[CW - 1], 1);
        if (lane == 0) ml = m_left;
      }

      // pass 1: each column's D and Y candidates, and w for the x chain
      int dv[CW], yv[CW], pk[CW];
      if (is_start) {
        int dpre[CW], um[CW], uy[CW], dq[CW], uq[CW], yq[CW];
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          dpre[c] = um[c] = uy[c] = NEG;
          dq[c] = uq[c] = yq[c] = 0;
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q >= Pm) break;
          const int p = q == 0 ? pq0 : pq1;
          int vm[CW + 1], vy[CW];   // vm[c + 1]: m[p][j0 + c]; vm[0]: m[p][j0 - 1]
          if (p < 0) {
#pragma unroll
            for (int c = 0; c <= CW; ++c) vm[c] = NEG;
#pragma unroll
            for (int c = 0; c < CW; ++c) vy[c] = NEG;
          } else if (!ALL && p == i - 1) {
            vm[0] = ml;
#pragma unroll
            for (int c = 0; c < CW; ++c) {
              vm[c + 1] = mu[c];
              vy[c] = yu[c];
            }
          } else if (PF) {
#pragma unroll
            for (int c = 0; c <= CW; ++c) vm[c] = fm[q][c];
#pragma unroll
            for (int c = 0; c < CW; ++c) vy[c] = fy[q][c];
          } else {
            const int sr = q == 0 ? sq0 : sq1;
            load_row<CW>(msb + (size_t)sr * Lp, ysb + (size_t)sr * Lp, j0, Lp, vm, vy);
          }
          gl_slot<CW>(q, j0, vm, vy, dpre, um, uy, dq, uq, yq);
        }
        for (int q = 2; q < Pm; ++q) {
          const int p = pi[q];
          int vm[CW + 1], vy[CW];
          if (p < 0) {
#pragma unroll
            for (int c = 0; c <= CW; ++c) vm[c] = NEG;
#pragma unroll
            for (int c = 0; c < CW; ++c) vy[c] = NEG;
          } else if (!ALL && p == i - 1) {
            vm[0] = ml;
#pragma unroll
            for (int c = 0; c < CW; ++c) {
              vm[c + 1] = mu[c];
              vy[c] = yu[c];
            }
          } else {
            load_row<CW>(msb + (size_t)si[q] * Lp, ysb + (size_t)si[q] * Lp, j0, Lp, vm, vy);
          }
          gl_slot<CW>(q, j0, vm, vy, dpre, um, uy, dq, uq, yq);
        }
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int sub = sub_col[NCODE * ((cr >> (3 * c)) & 7)];
          const int um_pre = um[c] + o;
          dv[c] = max(dpre[c], 0) + sub;
          const int ums = max(um_pre, 0), uys = max(uy[c], 0);
          const bool from_m = ums > uys;   // ties => Y (":166-171")
          yv[c] = max(ums, uys) + e;
          pk[c] = gl_pack(dq[c], from_m ? uq[c] : yq[c], dpre[c] > 0,
                          from_m ? um_pre > 0 : uy[c] > 0, !from_m);
        }
      } else {
        // non-start rows (":56-73"): plain i-1; ties => M
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int sub = sub_col[NCODE * ((cr >> (3 * c)) & 7)];
          dv[c] = (j0 + c > 0 ? (c > 0 ? mu[c - 1] : ml) : NEG) + sub;
          yv[c] = max(mu[c] + o, yu[c]) + e;
          pk[c] = (int)(yu[c] > mu[c] + o) << 26;   // strict => Y
        }
      }
      // the lane's chain summary over all its columns and over all but the
      // last: fast, the max of w; clamped, B of the composite map (its A
      // is the columns' steps, chain_steps)
      int lsum = CLAMP ? NEG : INT_MIN, lpart = lsum;
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int j = j0 + c;
        const int cc = j == 0 ? 0 : max(max(dv[c], yv[c]), 0);
        if (c == CW - 1) lpart = lsum;
        if (CLAMP) {
          lsum = c == 0 ? max(cc + oe, NEG) : chain_apply(lsum, g, cc + oe);
        } else {
          const int wv = cc + oe - (j + 1) * g;
          lsum = c == 0 ? wv : max(lsum, wv);
        }
      }
      const int c_last = j0 + CW - 1 == 0 ? 0 : max(max(dv[CW - 1], yv[CW - 1]), 0);
      int incl = lsum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl = CLAMP ? chain_apply(y, chain_steps(d * CW, g), incl) : max(incl, y);
      }
      int excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = CLAMP ? NEG : INT_MIN;
      // the chain up to (not including) the lane's last column
      const int part = CLAMP ? chain_apply(excl, chain_steps(CW - 1, g), lpart) : max(excl, lpart);
      // the left neighbour's data: the prefix before its last column (fast)
      // and its last column's c
      int lp = __shfl_up_sync(FULL, part, 1);
      int lc = __shfl_up_sync(FULL, c_last, 1);

      int carry = wcarry;   // max of w over the columns before the warp
      if (w > 1) {
        if (lane == 31) {
          s_tot[kpar][wi] = incl;
          s_part[kpar][wi] = part;
          s_clast[kpar][wi] = c_last;
        }
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
        if (CLAMP) {
          // the states in warp order: entering warp v, and x at the column
          // before it (the previous window's last for v = 0)
          const int a_w = chain_steps(32 * CW, g), a_p = chain_steps(32 * CW - 1, g);
          int xin = wcarry, xlast = left_p;
          for (int v = 0; v < w; ++v) {
            if (v == wi) {
              carry = xin;
              if (lane == 0) lp = xlast;
            }
            xlast = chain_apply(xin, a_p, s_part[kpar][v]);
            xin = chain_apply(xin, a_w, s_tot[kpar][v]);
          }
          if (lane == 0) lc = wi > 0 ? s_clast[kpar][wi - 1] : left_c;
          left_p = xlast;   // for the next window's first column
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
      } else if (lane == 0) {
        lp = 0;
        lc = 0;
      }
      // the next row's far predecessors (rows i-1 and before, published by
      // this row's barrier or the last __syncwarp), while this row finishes
      if (PF && start_n && i + 1 < n - 1) {
        if (pq0_n >= 0 && pq0_n != i)
          load_row<CW>(msb + (size_t)sq0_n * Lp, ysb + (size_t)sq0_n * Lp, j0, Lp, fm[0], fy[0]);
        if (pq1_n >= 0 && pq1_n != i)
          load_row<CW>(msb + (size_t)sq1_n * Lp, ysb + (size_t)sq1_n * Lp, j0, Lp, fm[1], fy[1]);
      }

      // pass 2: the carry applied to the lane's columns, in order: x at
      // each column (fast: the running prefix, then the columns' own
      // terms; clamped: the state entering the lane, then its maps)
      int xs[CW];
      int xl;   // x at j0 - 1
      if (CLAMP) {
        xs[0] = chain_apply(carry, chain_steps(lane * CW, g), excl);
#pragma unroll
        for (int c = 0; c + 1 < CW; ++c) {
          const int j = j0 + c;
          xs[c + 1] = chain_apply(xs[c], g, (j == 0 ? 0 : max(max(dv[c], yv[c]), 0)) + oe);
        }
        xl = __shfl_up_sync(FULL, xs[CW - 1], 1);
        if (lane == 0) xl = lp;
      } else {
        int P = max(max(carry, excl), 0);
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int j = j0 + c;
          xs[c] = j * g + P;
          P = max(P, (j == 0 ? 0 : max(max(dv[c], yv[c]), 0)) + oe - (j + 1) * g);
        }
        xl = (j0 - 1) * g + max(lane == 0 ? lp : max(lp, carry), 0);
      }
      int xp, mp_;   // the left neighbour's x and m, border-adjusted
      {
        const int jl = j0 - 1;
        const bool bl = jl <= 0 || jl >= L;
        xp = bl ? 0 : xl;
        mp_ = bl ? 0 : max(lc, xl);
      }
      if (!ALL && w > 1 && lane == 0) m_left = mp_;   // row i's m at j0 - 1
      int lbv = INT_MIN, lbj = 0;
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const int j = j0 + c;
        const bool valid = j < L;
        const bool border = j == 0 || !valid;
        const int sj = (cr >> (3 * c)) & 7;
        const int x = xs[c];
        const int cv = max(max(dv[c], yv[c]), 0);
        const int mrow = border ? 0 : max(cv, x);
        const int xrow = border ? 0 : x;
        const int yrow = border ? 0 : yv[c];
        const int xl = c == 0 ? xp : (j == 1 ? 0 : xs[c - 1]);
        const int mlft = c == 0 ? mp_ : (j == 1 ? 0 : max(max(max(dv[c - 1], yv[c - 1]), 0), xs[c - 1]));
        const int pkc = pk[c];
        const int dq = pkc & 0xfff, uq = (pkc >> 12) & 0xfff;
        int didx = i - 1, uidx = i - 1;
        if (is_start) {   // uniform over the warp
          didx = (pkc >> 24) & 1 ? max(dq == 0 ? pq0 : dq == 1 ? pq1 : pi[dq], 0) : 0;
          uidx = (pkc >> 25) & 1 ? max(uq == 0 ? pq0 : uq == 1 ? pq1 : pi[uq], 0) : 0;
        }
        // path_x (":40-54"): X iff x[j-1] > m[j-1] + o (ties => M)
        const int cell_x = border ? 0 : i * 16 + (xl > mlft + o ? DIR_X : DIR_M);
        const int cell_y = border ? 0 : uidx * 16 + ((pkc >> 26) & 1 ? DIR_Y : DIR_M);
        // M directions with zero floor (":96-110"); D >= U >= L
        const bool d_ge_u = dv[c] >= yv[c];
        const bool isD = d_ge_u && dv[c] >= x;
        const bool isU = !d_ge_u && yv[c] >= x;
        const int mcell = isD ? didx * 16 + (sj == code ? DIR_D : DIR_LOW_D)
                        : isU ? uidx * 16 + DIR_U : i * 16 + DIR_L;
        const int cell = border || (dv[c] < 0 && yv[c] < 0 && x < 0) ? 0 : mcell;
        const bool better = valid && mrow > lbv;
        lbj = better ? j : lbj;
        lbv = better ? mrow : lbv;
        const int k = lane * CW + c;
        st[k] = cell;
        st[SEG + k] = cell_x;
        st[2 * SEG + k] = cell_y;
        st[3 * SEG + k] = mrow;
        st[4 * SEG + k] = yrow;
        if (!ALL) {
          mu[c] = mrow;
          yu[c] = yrow;
        }
      }

      // the row's best: the warp's (value, first column), then the row's
      const int vmax = __reduce_max_sync(FULL, lbv);
      const unsigned jmin = __reduce_min_sync(FULL, lbv == vmax ? (unsigned)lbj : 0xffffffffu);
      if (vmax != INT_MIN) {
        const long long key = make_key(vmax, 0x7fffffffu - jmin);
        wbest = key > wbest ? key : wbest;
      }

      // the staged segment to the planes (and the scratch), coalesced; the
      // staging alternates between two buffers, so one __syncwarp a row
      __syncwarp();
      const int len = min(SEG, Lp - c0);
      if (len > 0) {
        const size_t at = plane + (size_t)i * Lp + c0;
        const int sr = ALL ? i : store;
        int* const dst[GL_PLANES] = {a.packed + at, a.packed_x + at, a.packed_y + at,
                                     msb + (size_t)max(sr, 0) * Lp + c0,
                                     ysb + (size_t)max(sr, 0) * Lp + c0};
        if (vec) {
          warp_flush<SEG, true>(st, len, sr >= 0 ? 5 : 3, dst, lane);
        } else {
          warp_flush<SEG, false>(st, len, sr >= 0 ? 5 : 3, dst, lane);
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

template <int CW, bool ALL, bool ONE, bool CLAMP>
int gap_local_launch(const GlArgs& a, cudaStream_t stream) {
  const int threads = 32 * a.warps;
  const int smem = threads / 32 * 2 * GL_PLANES * 32 * CW * (int)sizeof(int);
  auto kern = poa_gap_local_kernel<CW, ALL, ONE, CLAMP>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<a.B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int CW, bool CLAMP>
int gap_local_chain(const GlArgs& a, cudaStream_t stream) {
  return a.warps == 1 ? gap_local_launch<CW, false, true, CLAMP>(a, stream)
                      : gap_local_launch<CW, false, false, CLAMP>(a, stream);
}

template <bool CLAMP>
int gap_local_form(const GlArgs& a, int cw, bool full, cudaStream_t stream) {
  if (full) return gap_local_launch<9, true, false, CLAMP>(a, stream);
  switch (cw) {
    case 1: return gap_local_chain<1, CLAMP>(a, stream);
    case 3: return gap_local_chain<3, CLAMP>(a, stream);
    case 5: return gap_local_chain<5, CLAMP>(a, stream);
    case 7: return gap_local_chain<7, CLAMP>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rgt

// cw: the columns a lane (1, 3, 5 or 7; 9 in the full form); warps:
// the warps a read, one read a block (1 to 16; 16 in the full form);
// full: every row's m and y in the scratch; clamp: the clamped chain.
extern "C" int rgt_poa_gap_local_fill(
    const int* seq, const int* L, const int* table, const int* codes, const int* node_start,
    const int* pred_idx, const int* srow, const int* store_at, int B, int n, int Pm, int Lp,
    int o, int e, int cw, int warps, int full, int clamp, int S, int* ms, int* ys,
    int* best_val, int* best_i, int* best_j, int* packed, int* packed_x, int* packed_y,
    void* stream) {
  using namespace rgt;
  if (B < 1 || n < 3 || Pm < 1 || Pm > 4095 || Lp < 1 || S < 1 || warps < 1 ||
      warps > GL_MAX_WARPS || 32 * warps > GL_THREADS || (!full && Lp > 32 * cw * warps) ||
      (full && (cw != 9 || warps != GL_MAX_WARPS)))
    return (int)cudaErrorInvalidValue;
  const GlArgs a{seq, L, table, codes, node_start, pred_idx, srow, store_at, B, n, Pm, Lp, o, e,
                 warps, S, ms, ys, best_val, best_i, best_j, packed, packed_x, packed_y};
  const cudaStream_t s = (cudaStream_t)stream;
  return clamp ? gap_local_form<true>(a, cw, full != 0, s)
               : gap_local_form<false>(a, cw, full != 0, s);
}
