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
//   the per-column selectors packed into one int a column, kept in
//   shared memory while it holds them (meta_smem) and else in the
//   per-read scratch (reads past ~40 kbp); then every (lane, column)
//   cell of the mask lanes replays its value on its own.
// - Hard rows: the column-parallel staging (every block's U/y pass, D
//   candidates and owner-collapsed D sources, pathwise_gap_engine.py:
//   529-580), kept per lane as K12's two inputs V and W in a per-read
//   scratch; then warp 0 runs K12's column chain (gap67_hardrow.cuh)
//   while the other warps apply y's fixup, and, for P > 32, every warp
//   follows the lanes past the chain's 32.
//
// Host tables (pathwise_gap_engine.GapTables): rows [n, 10] (code,
// alpha, flags, pr, eap, fap, hubs, alpha slot, isa slot), lanemask
// [n, P] (emask | fmask << 1), blocks [n, MB, 4] (pred, pred alpha, tb,
// flags), blockmask [n, MB, P] (bmask | bmaskq << 1 | bfixmem << 2),
// lanes [n, 4, P] (lane_maps; the fill reads the owning block), chain
// [n, 4, P] (K12's lane coefficients).
//
// What bounds it on this card: the three planes written once (12 bytes
// a cell); a read's row latency bounds the time when reads are few: a
// hard row's Lp - 1 sequential columns on one warp, ten shuffles and
// some twenty dependent integer operations each.  The block size
// follows the row's cells (P * Lp, at most 640 threads) and is halved
// while the card could not hold every read's block at once.
//
// hard_ran (one 64-bit count) gains the number of (read, hard row)
// column programs the launch ran; the caller reads it when it wants.
// The kernel allocates nothing, does not synchronise with the host and
// runs on the stream it is given; Lp must be a multiple of 4.

#include <algorithm>

#include "gap67_hardrow.cuh"
#include "pathwise_common.cuh"

namespace rgt {

enum : int { F_EASY = 1, F_START = 2, F_EDELTA = 4, F_FCAP = 8 };
enum : int { BF_VALID = 1, BF_DELTA = 2, BF_CASE1 = 4, BF_FIRST = 8, BF_FIRE = 16,
             BF_ISA = 32, BF_AFTER = 64 };
constexpr int ROWW = 10;  // ints per row of `rows`
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

// At most 640 threads a block, so that a thread may hold ~100 registers:
// K12's chain warp keeps its state, inputs and stores in registers, and
// at 1,024 threads (64 registers) the kernel spilled.
constexpr int FILL_THREADS = 640;

__global__ void __launch_bounds__(FILL_THREADS, 1)
gap67_fill_kernel(const int* __restrict__ seq, const int* __restrict__ table,
                  const int* __restrict__ rows, const int* __restrict__ lanemask,
                  const int* __restrict__ blocks, const int* __restrict__ blockmask,
                  const int* __restrict__ lanes, const int* __restrict__ chain, int n, int P,
                  int MB, int Lp, int o, int e, int semiglobal, int meta_smem, int* scratch,
                  int* Dm, int* X, int* Y, unsigned long long* hard_ran) {
  __shared__ int s_table[NCODE * NCODE];
  __shared__ int s_warp[32];
  __shared__ int s_left[FILL_THREADS];
  extern __shared__ int sm[];
  int* s_x0 = sm;                   // P: the row's first column
  int* s_own = s_x0 + P;            // P: each lane's owning block
  int* s_st = s_own + P;            // 4 P: K12's state past 32 hubs
  int* s_blk = s_st + 4 * P;        // 4 MB: pred, ap, tb, flags

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int ntiles = (Lp + T - 1) / T;
  for (int t = tid; t < NCODE * NCODE; t += T) s_table[t] = table[t];
  const int* sb = seq + (size_t)b * Lp;
  const size_t pl = (size_t)P * Lp;
  const Planes pln{Dm, X, Y, (size_t)gridDim.x * pl, (size_t)b * pl};
  int* st_V = scratch + (size_t)b * (2 * P + MB + 1) * Lp;   // hard rows: K12's V and W [P, Lp]
  int* st_W = st_V + pl;
  int* st_VA = st_W + pl;           // hard rows: y's fixup corrections [MB, Lp]
  // Lp: easy rows' src << 3 | dsel << 1 | usel, in shared memory if it fits
  int* s_meta = meta_smem ? s_blk + 4 * MB : st_VA + (size_t)MB * Lp;
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
        s_pred[s] = Bk[0];
        s_ap[s] = Bk[1];
        s_tb[s] = Bk[2];
        s_fl[s] = Bk[3];
      }
      if (!easy)
        for (int q = tid; q < P; q += T) s_own[q] = lanes[(size_t)i * 4 * P + q];
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
          s_meta[j] = src << 3 | dsel << 1 | usel;
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
          const int mj = s_meta[j];
          const int dsel = (mj >> 1) & 3, src = mj >> 3;
          yv = (mj & 1) ? Dq[j] - dl * pDai[j] : Yq[j] - dl * pYai[j];
          const int dm_sh = Dq[j - 1] - dl * pDai[j - 1];
          if (src == 0) {
            xv = s_x0[q];
          } else {
            const int k = src - 1, mk = s_meta[k];
            if (k == 0) xv = s_x0[q];
            else if (((mk >> 1) & 3) == 0) xv = Dq[k - 1] - dl * pDai[k - 1];
            else xv = (mk & 1) ? Dq[k] - dl * pDai[k] : Yq[k] - dl * pYai[k];
          }
          dv = dsel == 0 ? dm_sh : (dsel == 1 ? yv : xv);
        }
        Di[t] = dv;
        Xi[t] = xv;
        Yi[t] = yv;
      }
    } else {
      // ---- 3. a hard row (gap.rs:150-539) ----
      // staging, per cell: y per block in order, and the owner's U, D
      // candidate and D source, kept as K12's V and W
      for (size_t t = tid; t < pl; t += T) {
        const int q = (int)(t / Lp), j = (int)(t % Lp);
        const int so = s_own[q];
        int yc = 0, u_own = 0;
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
          if (s == so) u_own = usel ? u_dpm : u_y;
        }
        Yi[t] = yc;
        if (so >= 0 && j >= 1) {
          const int* Dp = pln.d(s_pred[so]);
          const int ds = (s_fl[so] & BF_DELTA) ? 1 : 0;
          const int dtb = Dp[(size_t)s_tb[so] * Lp + j - 1];
          const int dfd = Dp[t - 1] - ds * dtb;
          const int dcand = Dp[(size_t)clampP(s_ap[so], P) * Lp + j - 1] + ds * dtb +
                            sub_row[sb[j]];
          st_V[t] = max(dcand, u_own);
          st_W[t] = dcand >= u_own ? dfd : yc;
        }
      }
      __syncthreads();
      // K12's column chain on warp 0 (gap67_hardrow.cuh) while the other
      // warps apply y's multi-alpha fixup (the chain read the pre-fixup
      // y); then, for P > 32, every warp follows the lanes past the hubs
      const HardRow hr{st_V, st_W, Lp, chain + (size_t)i * 4 * P, s_x0, P, R[6], R[7], R[8],
                       o, e, Xi, Di, Lp};
      gap67_hard_row(hr, s_st, [&] {
        const int ST = T - 32;
        // the fixup's corrections per column, firing block by block in
        // order (gap.rs:521-537), tracked on the lanes they read: a fire
        // block's tb lane gains earlier blocks' corrections, and so does
        // the row alpha
        for (int j = tid - 32 + 1; j < Lp; j += ST) {
          int ya = Yi[(size_t)ai * Lp + j];
          for (int s = 0; s < MB; ++s) {
            if (!(s_fl[s] & BF_FIRE)) continue;
            const int tb = s_tb[s];
            int yt = Yi[(size_t)tb * Lp + j];
            for (int s2 = 0; s2 < s; ++s2)
              if ((s_fl[s2] & BF_FIRE) && (bm[(size_t)s2 * P + tb] & 4))
                yt += st_VA[(size_t)s2 * Lp + j];
            const int va = yt - ya;
            st_VA[(size_t)s * Lp + j] = va;
            if (bm[(size_t)s * P + ai] & 4) ya += va;
          }
        }
        asm volatile("bar.sync 1, %0;" ::"r"(ST) : "memory");   // warps 1.. only
        // then every cell: a fire block's tb lane takes its correction
        // (plus a later block's, whose fixup members hold it), any other
        // member of a firing block's fixup adds that block's; column 0 is 0
        for (size_t t = tid - 32; t < pl; t += ST) {
          const int q = (int)(t / Lp), j = (int)(t % Lp);
          if (j == 0) {
            Yi[t] = 0;
            continue;
          }
          int hs = -1, f = -1;
          for (int s = 0; s < MB; ++s) {
            if (!(s_fl[s] & BF_FIRE)) continue;
            if (s_tb[s] == q) hs = s;
            if (bm[(size_t)s * P + q] & 4) f = s;
          }
          if (hs >= 0) Yi[t] = st_VA[(size_t)hs * Lp + j] + (f > hs ? st_VA[(size_t)f * Lp + j] : 0);
          else if (f >= 0) Yi[t] += st_VA[(size_t)f * Lp + j];
        }
      });
      if (tid == 0) ++ran;
    }
    // publishes row i before later rows read it
    __syncthreads();
  }
  if (tid == 0 && ran) atomicAdd(hard_ran, (unsigned long long)ran);
}

}  // namespace rgt

namespace {

// Threads per block: the row's cells (P * Lp, at least 64, at most
// FILL_THREADS), halved while the card could not hold all B blocks at
// once (a block's time is one read's row latency, so a second wave would
// double it).
int gap67_threads(int B, int P, int Lp, size_t smem) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int T = std::min(rgt::FILL_THREADS, std::max(64, rgt::block_threads(P * Lp)));
  for (; T > 64; T = std::max(64, (T / 2 + 31) / 32 * 32)) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rgt::gap67_fill_kernel, T, smem);
    if ((long long)per_sm * sms >= B) break;
  }
  return T;
}

}  // namespace

extern "C" int rgt_gap67_fill(const int* seq, const int* table, const int* rows,
                              const int* lanemask, const int* blocks, const int* blockmask,
                              const int* lanes, const int* chain, int B, int n, int P, int MB,
                              int Lp, int o, int e, int semiglobal, int* scratch, int* Dm, int* X,
                              int* Y, unsigned long long* hard_ran, void* stream) {
  if (B < 1 || n < 3 || P < 1 || MB < 1 || Lp < 4 || Lp % 4) return (int)cudaErrorInvalidValue;
  // the easy rows' selectors (Lp ints) join shared memory while it holds
  // them; longer reads keep them in the scratch (scratch holds both)
  constexpr size_t SMEM_MAX = 160 * 1024;
  size_t smem = (size_t)(6 * P + 4 * MB) * sizeof(int);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int meta_smem = smem + (size_t)Lp * sizeof(int) <= SMEM_MAX;
  if (meta_smem) smem += (size_t)Lp * sizeof(int);
  if (smem > 40 * 1024) {   // past the default 48 KB with the static arrays (3 KB)
    const cudaError_t err = cudaFuncSetAttribute(
        rgt::gap67_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int T = gap67_threads(B, P, Lp, smem);
  rgt::gap67_fill_kernel<<<B, T, smem, (cudaStream_t)stream>>>(
      seq, table, rows, lanemask, blocks, blockmask, lanes, chain, n, P, MB, Lp, o, e,
      semiglobal, meta_smem, scratch, Dm, X, Y, hard_ran);
  return (int)cudaGetLastError();
}
