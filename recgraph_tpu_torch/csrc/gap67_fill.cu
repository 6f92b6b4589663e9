// Modes 6/7 pathwise affine-gap fill in delta form (K11) for Hopper.
//
// Replaces the TPU kernel recgraph_tpu/ops/pallas_gap67_fill.py:671
// fill_gap67_pallas, for every graph: none of its gates (the packed
// 16-bit chain, P <= 128, the SMEM budget) applies here.  It computes
// what pathwise_gap_engine._fill_gap (recgraph_tpu/ops/
// pathwise_gap_engine.py:334-820) computes, cell for cell: Dm, X, Y
// int32[n, B, P, Lp] of the reference's alpha/delta-compressed dpm, x
// and y (pathwise_alignment_gap.rs, _gap_semi.rs), row 0 the
// open+extend ladder on its alpha lane in Dm and Y (0 in X), row n-1
// all 0, lanes no block writes 0, column 0 of Y 0, the first column
// (mode 6; 0 in mode 7) with its insertion-order fixup.
//
// Design: one thread block per read, rows in order; the three output
// planes are the row history, so a node-start row reads its predecessor
// blocks' rows straight from global memory (no ring), and a barrier at
// the end of each row publishes it.  Lanes past the row alpha's clamp
// read lane P-1, as the JAX engine's dynamic_slice does.
//
// - Easy rows (one predecessor whose alpha lane is the row's): the
//   alpha lane's (max,+) chain and the latest "inject" column are block
//   prefix scans over column tiles (carried across tiles, any Lp), with
//   the per-column selectors kept in a per-read scratch; then every
//   (lane, column) cell of the mask lanes replays its value on its own.
// - Hard rows: the column-parallel staging (every block's U/y pass, D
//   candidates and owner-collapsed D sources, pathwise_gap_engine.py:
//   529-580) into the scratch, the y fixup per column, then one warp
//   runs K12's column program (gap67_hardrow.cuh) across the columns.
//
// Host tables (pathwise_gap_engine.GapTables): rows [n, 8] (code,
// alpha, flags, pr, eap, fap), lanemask [n, P] (emask | fmask << 1),
// blocks [n, MB, 4] (pred, pred alpha, tb, flags), blockmask
// [n, MB, P] (bmask | bmaskq << 1 | bfixmem << 2), lanes [n, 4, P].
//
// What bounds it on this card: the three planes written once (12 bytes
// a cell); one block's row latency (a hard row's Lp - 1 sequential
// columns on one warp) bounds the time when reads are few.
//
// hard_ran (one int, zeroed by the caller) gains the number of (read,
// hard row) column programs the launch ran.  The kernel allocates
// nothing, does not synchronise with the host and runs on the stream it
// is given.

#include "gap67_hardrow.cuh"
#include "pathwise_common.cuh"

namespace rgt {

enum : int { F_EASY = 1, F_START = 2, F_EDELTA = 4, F_FCAP = 8 };
enum : int { BF_VALID = 1, BF_DELTA = 2, BF_CASE1 = 4, BF_FIRST = 8, BF_FIRE = 16,
             BF_ISA = 32, BF_AFTER = 64 };
constexpr int ROWW = 8;   // ints per row of `rows`
constexpr int BLKW = 4;   // ints per block of `blocks`

struct Planes {
  int* Dm;
  int* X;
  int* Y;
  size_t row;   // ints between rows of one plane: B * P * Lp
  size_t read;  // offset of this read within a row: b * P * Lp
  __device__ int* d(int i) const { return Dm + i * row + read; }
  __device__ int* x(int i) const { return X + i * row + read; }
  __device__ int* y(int i) const { return Y + i * row + read; }
};

__device__ __forceinline__ int clampP(int a, int P) { return a < P ? a : P - 1; }

__global__ void __launch_bounds__(MAX_THREADS, 1)
gap67_fill_kernel(const int* __restrict__ seq, const int* __restrict__ table,
                  const int* __restrict__ rows, const int* __restrict__ lanemask,
                  const int* __restrict__ blocks, const int* __restrict__ blockmask,
                  const int* __restrict__ lanes, int n, int P, int MB, int Lp, int o, int e,
                  int semiglobal, int* scratch, int* Dm, int* X, int* Y, int* hard_ran) {
  __shared__ int s_table[NCODE * NCODE];
  __shared__ int s_warp[32];
  __shared__ int s_left[MAX_THREADS];
  extern __shared__ int sm[];
  int* s_x0 = sm;                   // P: the row's first column
  int* s_st = s_x0 + P;             // 4 P: K12's state
  int* s_ln = s_st + 4 * P;         // 4 P: the row's lane maps
  int* s_blk = s_ln + 4 * P;        // 8 MB: pred, ap, tb, flags, nd, fire, isa, after

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int ntiles = (Lp + T - 1) / T;
  for (int t = tid; t < NCODE * NCODE; t += T) s_table[t] = table[t];
  const int* sb = seq + (size_t)b * Lp;
  const size_t pl = (size_t)P * Lp;
  const Planes pln{Dm, X, Y, (size_t)gridDim.x * pl, (size_t)b * pl};
  int* scr = scratch + (size_t)b * (3 + 2 * MB + 2 * P) * Lp;
  int* sc_usel = scr;               // easy rows: per column usel, dsel, src
  int* sc_dsel = scr + Lp;
  int* sc_src = scr + 2 * Lp;
  int* st_U = scr + 3 * Lp;         // hard rows: U, Dc [MB, Lp]; Dfd, Ypre [P, Lp]
  int* st_Dc = st_U + (size_t)MB * Lp;
  int* st_Dfd = st_Dc + (size_t)MB * Lp;
  int* st_Ypre = st_Dfd + pl;
  int* s_pred = s_blk;
  int* s_ap = s_blk + MB;
  int* s_tb = s_blk + 2 * MB;
  int* s_fl = s_blk + 3 * MB;

  // row 0: the open+extend ladder on the alpha lane of Dm and Y; row n-1: 0
  {
    const int a0 = rows[1];
    int *d0 = pln.d(0), *x0r = pln.x(0), *y0 = pln.y(0);
    int *dl = pln.d(n - 1), *xl = pln.x(n - 1), *yl = pln.y(n - 1);
    for (size_t t = tid; t < pl; t += T) {
      const int q = (int)(t / Lp), j = (int)(t % Lp);
      const int v = (q == a0 && j >= 1) ? o + e * j : 0;
      d0[t] = v;
      y0[t] = v;
      x0r[t] = 0;
      dl[t] = 0;
      xl[t] = 0;
      yl[t] = 0;
    }
  }
  __syncthreads();

  int ran = 0;   // thread 0: the hard rows whose column program this block ran
  for (int i = 1; i < n - 1; ++i) {
    const int* R = rows + (size_t)i * ROWW;
    const int code = R[0], ai = R[1], flags = R[2];
    const bool start = flags & F_START;
    const bool easy = flags & F_EASY;
    const int aic = clampP(ai, P);
    const int* sub_row = s_table + code * NCODE;
    const int* lm = lanemask + (size_t)i * P;
    const int* bm = blockmask + (size_t)i * MB * P;
    int *Di = pln.d(i), *Xi = pln.x(i), *Yi = pln.y(i);
    if (start) {
      for (int s = tid; s < MB; s += T) {
        const int* Bk = blocks + ((size_t)i * MB + s) * BLKW;
        const int fl = Bk[3];
        s_pred[s] = Bk[0];
        s_ap[s] = Bk[1];
        s_tb[s] = Bk[2];
        s_fl[s] = fl;
        s_blk[4 * MB + s] = Bk[2] != ai;
        s_blk[5 * MB + s] = (fl & BF_FIRE) != 0;
        s_blk[6 * MB + s] = (fl & BF_ISA) != 0;
        s_blk[7 * MB + s] = (fl & BF_AFTER) != 0;
      }
      if (!easy)
        for (int t = tid; t < 4 * P; t += T) s_ln[t] = lanes[(size_t)i * 4 * P + t];
    }
    __syncthreads();

    // ---- 1. the first column (gap.rs:35-147; 0 in mode 7) ----
    if (semiglobal) {
      for (int q = tid; q < P; q += T) s_x0[q] = 0;
    } else if (!start) {
      const int* Xp = pln.x(i - 1);
      const int fap = R[5];
      const bool cap = flags & F_FCAP;
      const int xp_ai = Xp[(size_t)aic * Lp], xp_ap = Xp[(size_t)clampP(fap, P) * Lp];
      const int x_ai = i == 1 ? o + e : (cap ? xp_ai + e : xp_ai + xp_ap + e);
      for (int q = tid; q < P; q += T) {
        const int xq = Xp[(size_t)q * Lp];
        int v = (lm[q] & 2) ? (cap ? xq : xq - xp_ai) : 0;
        if (q == ai) v = x_ai;
        s_x0[q] = v;
      }
    } else {
      for (int q = tid; q < P; q += T) {
        int v = 0;
        for (int s = 0; s < MB; ++s) {
          if (!(s_fl[s] & BF_VALID)) continue;
          const int p = s_pred[s], tb = s_tb[s];
          const int ds = (s_fl[s] & BF_DELTA) ? 1 : 0;
          const int* Xp = pln.x(p);
          const int xp_tb = Xp[(size_t)tb * Lp];
          if (bm[(size_t)s * P + q] & 1) v = Xp[(size_t)q * Lp] - ds * xp_tb;
          if (q == tb) v = p == 0 ? o + e : xp_tb + ds * Xp[(size_t)clampP(s_ap[s], P) * Lp] + e;
        }
        s_x0[q] = v;
      }
      // the insertion-order fixup, block by block (gap.rs:133-147)
      for (int s = 0; s < MB; ++s) {
        if (!(s_fl[s] & BF_FIRE)) continue;
        __syncthreads();
        const int tb = s_tb[s];
        const int va = s_x0[tb] - s_x0[ai];
        __syncthreads();
        for (int q = tid; q < P; q += T) {
          if (q == tb) s_x0[q] = va;
          else if (bm[(size_t)s * P + q] & 4) s_x0[q] += va;
        }
      }
    }
    __syncthreads();

    if (easy) {
      // ---- 2. an easy row (pathwise_gap_engine.py:414-506) ----
      const int* pD = pln.d(R[3]);
      const int* pY = pln.y(R[3]);
      const int apc = clampP(R[4], P);
      const int dl = (flags & F_EDELTA) ? 1 : 0;
      const int x0_ai = s_x0[aic];
      const int* pDap = pD + (size_t)apc * Lp;
      const int* pDai = pD + (size_t)aic * Lp;
      const int* pYap = pY + (size_t)apc * Lp;
      const int* pYai = pY + (size_t)aic * Lp;
      int cM = INT_MIN, cS = INT_MIN, leftM = 0, leftF = 0;
      for (int t = 0; t < ntiles; ++t) {
        const int j = t * T + tid;
        const bool live = j < Lp;
        int qv = INT_MIN, y_a = 0, d_col = 0, cst = 0, usel = 0;
        if (live) {
          const int u_y = pYap[j] + dl * pYai[j] + e;
          const int u_dpm = pDap[j] + dl * pDai[j] + o + e;
          usel = u_dpm >= u_y;
          y_a = usel ? u_dpm : u_y;
          const int jm = j > 0 ? j - 1 : Lp - 1;
          d_col = pDap[jm] + dl * pDai[jm] + sub_row[sb[j]];
          cst = max(d_col, y_a);
          qv = j == 0 ? max(x0_ai, x0_ai - o) : cst - e * j;
        }
        const int Mi = tile_prefix_max(qv, s_warp, cM);
        const int Mprev = left_neighbour(Mi, leftM, s_left);
        const int x_a = j == 0 ? x0_ai : o + e * j + Mprev;
        const int dpm_a = j == 0 ? x0_ai : max(cst, x_a);
        const int lsel = dpm_a + o >= x_a;
        const int dsel = dpm_a == d_col ? 0 : (dpm_a == y_a ? 1 : 2);
        const int f = lsel && (j == 0 || dsel != 2);
        const int fprev = left_neighbour(f, leftF, s_left);
        const int src = tile_prefix_max(j >= 1 && fprev ? j : 0, s_warp, cS);
        if (live) {
          sc_usel[j] = usel;
          sc_dsel[j] = dsel;
          sc_src[j] = src;
          if (ai < P) {
            Di[(size_t)ai * Lp + j] = dpm_a;
            Xi[(size_t)ai * Lp + j] = x_a;
            Yi[(size_t)ai * Lp + j] = j == 0 ? 0 : y_a;
          }
        }
      }
      __syncthreads();
      // every mask lane replays its cell from the latest inject column
      for (size_t t = tid; t < pl; t += T) {
        const int q = (int)(t / Lp), j = (int)(t % Lp);
        if (q == ai) continue;
        int dv = 0, xv = 0, yv = 0;
        if (j == 0) {
          dv = xv = s_x0[q];
        } else if (lm[q] & 1) {
          const int* Dq = pD + (size_t)q * Lp;
          const int* Yq = pY + (size_t)q * Lp;
          const int dsel = sc_dsel[j], src = sc_src[j];
          yv = sc_usel[j] ? Dq[j] - dl * pDai[j] : Yq[j] - dl * pYai[j];
          const int dm_sh = Dq[j - 1] - dl * pDai[j - 1];
          if (src == 0) {
            xv = s_x0[q];
          } else {
            const int k = src - 1;
            if (k == 0) xv = s_x0[q];
            else if (sc_dsel[k] == 0) xv = Dq[k - 1] - dl * pDai[k - 1];
            else xv = sc_usel[k] ? Dq[k] - dl * pDai[k] : Yq[k] - dl * pYai[k];
          }
          dv = dsel == 0 ? dm_sh : (dsel == 1 ? yv : xv);
        }
        Di[t] = dv;
        Xi[t] = xv;
        Yi[t] = yv;
      }
    } else {
      // ---- 3. a hard row (gap.rs:150-539) ----
      // staging: y per block in order, and the owner's D source, per cell
      for (size_t t = tid; t < pl; t += T) {
        const int q = (int)(t / Lp), j = (int)(t % Lp);
        int yc = 0;
        for (int s = 0; s < MB; ++s) {
          const int fl = s_fl[s];
          if (!(fl & BF_VALID)) continue;
          const int tb = s_tb[s], apc = clampP(s_ap[s], P);
          const int ds = (fl & BF_DELTA) ? 1 : 0;
          const int* Dp = pln.d(s_pred[s]);
          const int* Yp = pln.y(s_pred[s]);
          const int yp_tb = Yp[(size_t)tb * Lp + j], dp_tb = Dp[(size_t)tb * Lp + j];
          const int u_y = Yp[(size_t)apc * Lp + j] + ds * yp_tb + e;
          const int u_dpm = Dp[(size_t)apc * Lp + j] + ds * dp_tb + o + e;
          const bool usel = u_dpm >= u_y;
          const int m = bm[(size_t)s * P + q];
          if (usel && (m & 1)) yc = Dp[t] - ds * dp_tb;
          if (!usel && (m & ((fl & BF_CASE1) ? 2 : 1))) yc = Yp[t] - ds * yp_tb;
          if (q == tb) yc = usel ? u_dpm : u_y;
        }
        st_Ypre[t] = yc;
        Yi[t] = yc;
        int dfd = 0;
        const int s = s_ln[q];
        if (s >= 0 && j >= 1) {
          const int* Dp = pln.d(s_pred[s]);
          const int ds = (s_fl[s] & BF_DELTA) ? 1 : 0;
          dfd = Dp[t - 1] - ds * Dp[(size_t)s_tb[s] * Lp + j - 1];
        }
        st_Dfd[t] = dfd;
      }
      // staging: every block's U and D candidates per column
      for (int t = tid; t < MB * Lp; t += T) {
        const int s = t / Lp, j = t % Lp;
        const int fl = s_fl[s];
        int u = 0, dcand = 0;
        if ((fl & BF_VALID) && j >= 1) {
          const int tb = s_tb[s], apc = clampP(s_ap[s], P);
          const int ds = (fl & BF_DELTA) ? 1 : 0;
          const int* Dp = pln.d(s_pred[s]);
          const int* Yp = pln.y(s_pred[s]);
          const int dp_tb = Dp[(size_t)tb * Lp + j];
          const int u_y = Yp[(size_t)apc * Lp + j] + ds * Yp[(size_t)tb * Lp + j] + e;
          const int u_dpm = Dp[(size_t)apc * Lp + j] + ds * dp_tb + o + e;
          u = u_dpm >= u_y ? u_dpm : u_y;
          dcand = Dp[(size_t)apc * Lp + j - 1] + ds * Dp[(size_t)tb * Lp + j - 1] +
                  sub_row[sb[j]];
        }
        st_U[t] = u;
        st_Dc[t] = dcand;
      }
      __syncthreads();
      // y's multi-alpha fixup per column (the column program reads the
      // pre-fixup y); column 0: y 0, x and d the first column
      for (int j = tid; j < Lp; j += T) {
        if (j == 0) {
          for (int q = 0; q < P; ++q) {
            Yi[(size_t)q * Lp] = 0;
            Xi[(size_t)q * Lp] = s_x0[q];
            Di[(size_t)q * Lp] = s_x0[q];
          }
          continue;
        }
        for (int s = 0; s < MB; ++s) {
          if (!(s_fl[s] & BF_FIRE)) continue;
          const int tb = s_tb[s];
          const int va = Yi[(size_t)tb * Lp + j] - Yi[(size_t)ai * Lp + j];
          Yi[(size_t)tb * Lp + j] = va;
          for (int q = 0; q < P; ++q)
            if (bm[(size_t)s * P + q] & 4) Yi[(size_t)q * Lp + j] += va;
        }
      }
      __syncthreads();
      // K12: the column chain on one warp
      if (tid < 32) {
        const HardBlocks hb{s_tb, s_blk + 4 * MB, s_blk + 5 * MB, s_blk + 6 * MB,
                            s_blk + 7 * MB, MB};
        const HardLanes hl{s_ln, s_ln + P, s_ln + 2 * P, s_ln + 3 * P};
        gap67_hard_cols(st_U + 1, st_Dc + 1, Lp, st_Dfd + 1, st_Ypre + 1, Lp, Lp - 1, hb, hl,
                        s_x0, P, ai, o, e, Xi + 1, Di + 1, Lp, s_st);
        if (tid == 0) ++ran;
      }
    }
    // publishes row i before later rows read it
    __syncthreads();
  }
  if (tid == 0 && ran) atomicAdd(hard_ran, ran);
}

}  // namespace rgt

extern "C" int rgt_gap67_fill(const int* seq, const int* table, const int* rows,
                              const int* lanemask, const int* blocks, const int* blockmask,
                              const int* lanes, int B, int n, int P, int MB, int Lp, int o, int e,
                              int semiglobal, int* scratch, int* Dm, int* X, int* Y,
                              int* hard_ran, void* stream) {
  if (B < 1 || n < 3 || P < 1 || MB < 1 || Lp < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(9 * P + 8 * MB) * sizeof(int);
  if (smem > 40 * 1024) return (int)cudaErrorInvalidValue;
  rgt::gap67_fill_kernel<<<B, rgt::block_threads(Lp), smem, (cudaStream_t)stream>>>(
      seq, table, rows, lanemask, blocks, blockmask, lanes, n, P, MB, Lp, o, e, semiglobal,
      scratch, Dm, X, Y, hard_ran);
  return (int)cudaGetLastError();
}
