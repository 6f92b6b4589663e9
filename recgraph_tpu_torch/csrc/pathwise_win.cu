// Mode-4 windowed long-read pathwise fill for Hopper (K10), and its
// reverse form S2, the windowed mode-8 reverse fill (below the K10 notes).
//
// Replaces the TPU kernel recgraph_tpu/ops/pallas_pathwise_win.py:409
// fill_pathwise_win_pallas, but computes what the XLA engine
// pathwise_window._fill_pathwise_win (recgraph_tpu/ops/
// pathwise_window.py:82-259) computes, cell for cell, not the Pallas
// kernel's tile-uniform, 128-quantised window start: per read and row
// the window start ws_i is the centre of the predecessor rows' best
// positions, pulled right to cover L - rmin[i] + 2 + W/8 and floored to a
// multiple of 8.  Outputs: Aw int32[B, P, n, W] (off-path lanes 0,
// columns past the read NEG), ws int32[B, n] and the exit bound
// bound[b] = R + smax * (L - 1), where R is the running max of
// value - smax * column over the predecessor cells a row's window
// strands, each row's right-edge cell and row 0's.
//
// Design: the one of K7/K8 (pathwise_common.cuh), with the window.
// - One read is one thread block (cuda_pathwise_win.plan).  Per read, in
//   shared memory where it fits (else in device memory): the read's gap
//   prefix sums and codes, every row's window start and best position,
//   the row's (src, add) table and floor, the lanes' rows i-1 and i, and
//   the staged source rows of lanes whose pred row is not i-1.  The row
//   tables come from one packed array, one load a lane, a row ahead.
// - Per row, every warp places the window itself: row i-1's best
//   position from one shared 64-bit key (each warp folded its best
//   (value, lane) into it with atomicMax), then a warp min/max over the
//   groups' predecessor best positions.
// - Each group's rep chain runs on up to 4 warps from the block's last
//   warp down, 2 columns a lane (windows of 256 for wider W), reading
//   the rep's row i-1 from shared memory, with the realignment shift = ws - ws[pred] folded in.  With x[k] the
//   rep's candidate minus Gw[k], a column moves D or U (or restarts)
//   iff x[k] reaches the prefix maximum, so one max-scan over (x,
//   position) keys gives every column its nearest such column k'; the
//   table reads k''s candidates again and writes src already shifted
//   into the predecessor's window (-1 where it falls outside), add = the
//   move's addend + Gw[k] - Gw[k'], and floor[k] = Gw[k] - 2^16 (the
//   clamp of the XLA engine's packed chain):
//
//       row_q[k] = src[k] < 0 ? floor[k] : max(Aq[src[k]] + add[k], floor[k]).
//
//   Its plain form is pathwise_window.win_replay_table_plain.
// - While the chains run, cp.async stages the other lanes' source rows;
//   after the row's first barrier the replay reads only shared memory, 4
//   cells a thread with 16-byte stores, and folds the stranded
//   predecessor cells and the right-edge cell into the exit bound R.  A
//   row costs two barriers: after the chains and after the replay.
//
// What bounds it on this card: the bytes of Aw it writes (4 a cell) set
// the bound (1.28 ms for 110 long reads at W 256); the kernel runs at
// ~12 % of it (PERF.md), held by a row's latency: the rows of a read are
// sequential, and a row's group chains and its window placement run on
// a few warps while the other warps wait at the row's first barrier.
//
// The kernel allocates nothing, does not synchronise with the host and
// runs on the stream it is given.

// S2, the reverse form (REV = true): the windowed mode-8 reverse fill of
// recombination_window._fill_pathwise_rev_win (recgraph_tpu/ops/
// recombination_window.py:67-262; XLA, no TPU kernel), the port's own
// kernel, as K8 is the reverse form of K7.  What changes, by the form:
// - rows run n-2 down to 1 and read their successor rows; the read is the
//   reverse read (seq shifted left, the sentinel at L - 1) and G its
//   suffix gap sums over the read (0 past it), absolute, not window-local;
// - the window: centre c = (min + max of the on-lanes' successor best
//   positions) / 2 - 1, ws = min(c - W/2, min(ms - 2, c) - W/8), clipped
//   to [0, Lp - W] and floored to a multiple of 8;
// - the chain runs right to left: positions r = W-1-k, keys (x, r), so
//   the max-scan gives every column its nearest column at or after it
//   that moves D or U; column L - 1 restarts (U from the successor's
//   column L - 1) and cuts the replay there; D reads column j + 1;
// - the replay floor is G[k] - 2^16, the clamp of the packed chain
//   (W - k) << 17 | (V - G + 2^16); constant-0 lanes (qsrc < 0) and
//   off-path lanes are 0, column 0 is 0, columns past the read NEG;
//   delta-leak lanes read their source plane qsrc, as K8 does;
// - the best position is the leftmost best over the on-lanes at columns
//   >= 1; the exit account Rr collects the successor cells the window
//   strands (column <= ws or >= ws + W, on-lane, 1 <= column < L) and the
//   row's left-edge cell, each as value - smax (L - 1 - column), and row
//   n-1's left-edge cell; Rr is returned normalised (not + smax (L - 1));
// - row n-1 holds the suffix gap chain in a window at the right end
//   while the rows above read it, then only plane 0 keeps it; row 0 is 0.
//   The window placement reads each on-lane's successor row from its own
//   table entry (constant-0 lanes have none: row 0, whose best position
//   is 0).

#include "pathwise_common.cuh"

namespace rgt {

constexpr int WIN_OFF = 1 << 16;   // pathwise_window.OFF
constexpr int FAR = 1 << 28;       // the min over no on-lane
constexpr int PWW_CW = 2;          // chain columns a lane
constexpr int PWW_CHAIN_WARPS = 4; // warps a group's chain (fewer when the row has many groups)
constexpr int PWW_THREADS = 512;

struct PwwArgs {
  const int* seq;     // [B, Lp] '$'-prefixed read codes
  const int* L;       // [B]
  const int* table;   // [7, 7]
  const int* meta;    // [n, pww_meta_n] the row tables (cuda_pathwise_win.row_tables)
  const int* rmin;    // [n] (K10 only)
  int n, P, Lp, Gd, W;
  int smem_form;      // the per-read scratch in shared memory
  unsigned char* scratch;  // device scratch, `stride` bytes a block
  long long stride;
  int* Aw;            // [B, P, n, W]
  int* ws;            // [B, n]
  int* bound;         // [B] K10: R + smax (L - 1); S2: Rr
};

__host__ __device__ inline int pww_a4(int x) { return (x + 3) & ~3; }

// A row's table entries: code | groups << 8, grep[Gd], gpred[Gd], pslot[P]
// and, for S2, qsrc[P] and each lane's successor row for the window
// placement (-1 off-path, 0 for a constant-0 lane).
__host__ __device__ inline int pww_meta_n(bool rev, int Gd, int P) {
  return 1 + 2 * Gd + (rev ? 3 : 1) * P;
}

// The per-read scratch, in shared or device memory.
struct PwwScratch {
  int* Gab;             // [LpA] the read's gap prefix (K10) or suffix (S2) sums
  int* wsr;             // [nA] each row's window start
  int* bspr;            // [nA] each row's best position
  int* floor;           // [WA] Gw[k] - WIN_OFF
  int* src;             // [Gd, WA]
  int* add;             // [Gd, WA]
  int* pred;            // [P, WA] each lane's source row when it is not the last row, staged
  int* last;            // [2, P, WA] the lanes' rows i-1 and i (S2: i+1 and i) by row parity
  unsigned char* code;  // [LpA] read (K10) or reverse read (S2) codes
};

// The sums of sm(seq[t], '-') over t = 0 .. j, with t past the read
// clamped to its last column; Gw[k] of the window at ws is
// gsum(ws + k) - gsum(ws - 1).
__device__ __forceinline__ int gsum(const int* Gab, int Lp, int glast, int j) {
  return j < 0 ? 0 : Gab[min(j, Lp - 1)] + max(j - Lp + 1, 0) * glast;
}

// One group's rep chain on w warps (wi: this warp's index among them,
// named barrier 1 + g) over the window, in windows of 32 w CW positions:
// the group's (src, add) table (and, for `floor_too`, the row's floor).
// Position r is column k = r (K10) or k = W-1-r (S2).  With x[k] = A~[k]
// - G[k] (A~ the rep's D/U candidate: U at K10's read column 0 and at
// S2's column L - 1, NEG past S2's read), the rep's row is G[k] + the max
// of x over the positions up to r, and a column moves D or U (or
// restarts) iff x[k] reaches that maximum: the nearest such column is
// the last position of the maximum.  So one max-scan over (x, position)
// keys gives it for every column (warp shuffles, carried across the
// group's warps through s_xt, by window parity, and across windows in
// registers); the table then reads that column's D and U candidates
// again (D iff d >= u there, not at a restart column).  The window's
// first position is its own nearest column; S2's column L - 1 cuts the
// columns left of it.
template <bool REV, int CW>
__device__ __forceinline__ void pww_chain(const PwwScratch& s, int g, int w, int wi,
                                          const int* Ar, int W, int WA, int Lp, int L, int glast,
                                          int ws, int shift, int gap, const int* sub_row,
                                          bool floor_too, long long (*s_xt)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, w0 = warp - wi;
  int* xs = s.src + (size_t)g * WA;
  int* ds = s.add + (size_t)g * WA;
  constexpr int DS = REV ? 1 : -1;   // the D read's column offset
  auto al = [&](int idx) { return idx >= 0 && idx < W ? Ar[idx] : NEG; };
  auto sub_at = [&](int k) { return sub_row[s.code[min(ws + k, Lp - 1)]]; };
  // K10: Gw[k] + gsum(ws - 1); S2: the suffix sum at ws + k (ws + k < Lp)
  auto gs = [&](int k) { return REV ? s.Gab[ws + k] : gsum(s.Gab, Lp, glast, ws + k); };
  const int gbase = REV ? 0 : gsum(s.Gab, Lp, glast, ws - 1);
  const int rcol = REV ? L - 1 - ws : -ws;   // the restart column, window-relative
  long long pc = LLONG_MIN;   // the prefix max key before the window
  for (int base = 0, par = 0; base < W; base += 32 * w * CW, par ^= 1) {
    const int r0 = base + (wi * 32 + lane) * CW;
    long long key[CW];
    int gk[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int r = r0 + c, k = REV ? W - 1 - r : r;
      if (REV && r >= W) {   // past the window (S2's columns would be negative)
        key[c] = LLONG_MIN;
        gk[c] = 0;
        continue;
      }
      gk[c] = gs(k);
      const int d = al(shift + k + DS) + sub_at(k), u = al(shift + k) + gap;
      const int a = k == rcol ? u : (REV && ws + k >= L) ? NEG : max(d, u);
      key[c] = r < W ? make_key(a - (gk[c] - gbase), (unsigned)r) : LLONG_MIN;
    }
    long long m = key[0];
#pragma unroll
    for (int c = 1; c < CW; ++c) m = max(m, key[c]);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(FULL, m, o);
      if (lane >= o) m = max(m, y);
    }
    long long p = __shfl_up_sync(FULL, m, 1);
    if (lane == 0) p = LLONG_MIN;
    long long wtot = __shfl_sync(FULL, m, 31);
    if (w > 1) {
      if (lane == 31) s_xt[par][warp] = m;
      group_sync(g, w);
      wtot = LLONG_MIN;
      for (int v = 0; v < w; ++v) {
        const long long t = s_xt[par][w0 + v];
        if (v < wi) p = max(p, t);
        wtot = max(wtot, t);
      }
    }
    p = max(p, pc);
    pc = max(pc, wtot);
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int r = r0 + c, k = REV ? W - 1 - r : r;
      p = max(p, key[c]);
      if (r < W) {
        const int rr = (int)key_tie(p);   // the nearest position <= r that moved D, U or restarted
        int kk = REV ? W - 1 - rr : rr;
        if (REV && k <= rcol && kk > rcol) kk = rcol;   // column L - 1 restarts the replay
        const int sk = sub_at(kk);
        const bool formD = kk != rcol && al(shift + kk + DS) + sk >= al(shift + kk) + gap;
        const int idx = shift + kk + (formD ? DS : 0);
        xs[k] = idx >= 0 && idx < W ? idx : -1;
        ds[k] = (formD ? sk : gap) + gk[c] - gs(kk);
        if (floor_too) s.floor[k] = gk[c] - gbase - WIN_OFF;
      }
    }
  }
}

// The cells of replay item t (V columns from k0 of lane ql) into row i
// of Aw; folds the item's stranded source cells and the edge cell (K10:
// the right edge; S2: the left) into R and its on-path cells into the
// (value, column) key (K10: rightmost of the best; S2: leftmost, at
// columns >= 1).  `ws_prev` is the window of the last row (K10: i-1; S2:
// i+1), `prev` the lanes' rows there.
template <bool REV, int V>
__device__ __forceinline__ void pww_replay_item(const PwwScratch& s, const PwMeta& mt,
                                                const PwItem& t, int* Ab, size_t plane, int W,
                                                int WA, int i, int ws, int L, int smax,
                                                int ws_prev, const int* prev, int* cur, int& R,
                                                int& kv, int& kc) {
  const int g = mt.slot(t.ql);
  Cells<V> o;
  if (g < 0) {
    // off-path (S2: also constant-0) lanes: 0 in the read, NEG past it
    const bool on0 = REV && mt.m[1 + 2 * mt.Gd + 2 * mt.nl + t.ql] >= 0;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const int k = t.j0 + c;
      o.v[c] = ws + k < L || (REV && ws + k == 0) ? 0 : NEG;
      if (REV && on0) {
        // a constant-0 lane: 0 at columns >= 1 in the read, and its
        // source is row 0 (0, window at 0)
        if (ws + k >= 1 && ws + k < L) {
          if (0 > kv || (0 == kv && k < kc)) {
            kv = 0;
            kc = k;
          }
          if (k == 0) R = max(R, -smax * (L - 1 - ws));
        }
        if ((k <= ws || k >= ws + W) && k >= 1 && k < L) R = max(R, -smax * (L - 1 - k));
      }
    }
  } else {
    const int p = mt.pred(g);
    const int wsp = p == (REV ? i + 1 : i - 1) ? ws_prev : s.wsr[p];
    const int* sg = s.src + (size_t)g * WA + t.j0;
    const int* ag = s.add + (size_t)g * WA + t.j0;
    const int* fl = s.floor + t.j0;
    const int qs = REV ? mt.src(t.ql) : t.ql;   // the lane's source plane
    const int* row = p == (REV ? i + 1 : i - 1) ? prev + (size_t)qs * WA
                                                : s.pred + (size_t)t.ql * WA;
    int sv[V], av[V], fv[V];
    if constexpr (V == 4) {
      const int4 s4 = *reinterpret_cast<const int4*>(sg);
      const int4 a4 = *reinterpret_cast<const int4*>(ag);
      const int4 f4 = *reinterpret_cast<const int4*>(fl);
      sv[0] = s4.x; sv[1] = s4.y; sv[2] = s4.z; sv[3] = s4.w;
      av[0] = a4.x; av[1] = a4.y; av[2] = a4.z; av[3] = a4.w;
      fv[0] = f4.x; fv[1] = f4.y; fv[2] = f4.z; fv[3] = f4.w;
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        sv[c] = sg[c];
        av[c] = ag[c];
        fv[c] = fl[c];
      }
    }
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const int k = t.j0 + c;
      const int v = sv[c] < 0 ? fv[c] : max(row[sv[c]] + av[c], fv[c]);
      const bool in_read = ws + k < L;
      const int jp = wsp + k;   // the source cell's column: stranded by this window?
      if constexpr (REV) {
        // column 0 is 0; the leftmost best at columns >= 1, and the
        // left-edge cell
        o.v[c] = ws + k == 0 ? 0 : in_read ? v : NEG;
        if (in_read && ws + k >= 1) {
          if (v > kv || (v == kv && k < kc)) {
            kv = v;
            kc = k;
          }
          if (k == 0) R = max(R, v - smax * (L - 1 - ws));
        }
        if ((jp <= ws || jp >= ws + W) && jp >= 1 && jp < L)
          R = max(R, row[k] - smax * (L - 1 - jp));
      } else {
        o.v[c] = in_read ? v : NEG;
        if (in_read && (v > kv || (v == kv && k > kc))) {
          kv = v;
          kc = k;
        }
        if (in_read && k == W - 1) R = max(R, v - smax * (ws + k));
        if ((jp < ws || jp >= ws + W - 1) && jp < L) R = max(R, row[k] - smax * jp);
      }
    }
  }
  pw_store<V>(Ab + (size_t)t.ql * plane + (size_t)i * W + t.j0, o);
  pw_store<V>(cur + (size_t)t.ql * WA + t.j0, o);
}

// Block b of the grid is read b.  Dynamic shared memory: the row tables
// twice (K10: pw_meta_ints; S2: pww_meta_n rounded up to 4), then, in the shared-memory form,
// the per-read scratch.
template <bool REV, bool SMEM>
__global__ void __launch_bounds__(PWW_THREADS, 1) pathwise_win_kernel(const PwwArgs a) {
  __shared__ int s_table[NCODE * NCODE];
  // the row's best (value, column) key, by row parity: the value's bits
  // with the sign flipped, then K10 column + 1, S2 W - column (0: no
  // on-path cell in the read)
  __shared__ unsigned long long s_bkey[2];
  __shared__ int s_warp[32];
  __shared__ long long s_xt[2][32];   // the chains' carries across warps
  extern __shared__ int4 s_dyn[];

  const int b = blockIdx.x;
  const int P = a.P, Lp = a.Lp, Gd = a.Gd, n = a.n, W = a.W;
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = T >> 5;
  const int WA = pww_a4(W), LpA = pww_a4(Lp), nA = pww_a4(n);
  const int nmeta = pww_meta_n(REV, Gd, P);
  const int MW = REV ? pww_a4(nmeta) : pw_meta_ints(Gd, P);
  // entry t of row r's tables (PwMeta's layout): one load
  auto meta_at = [&](int r, int t) { return a.meta[(size_t)r * nmeta + t]; };
  int* s_meta = reinterpret_cast<int*>(s_dyn);   // [2, MW]
  unsigned char* base = SMEM ? reinterpret_cast<unsigned char*>(s_meta + 2 * MW)
                             : a.scratch + (size_t)blockIdx.x * a.stride;
  PwwScratch s;
  s.Gab = reinterpret_cast<int*>(base);
  s.wsr = s.Gab + LpA;
  s.bspr = s.wsr + nA;
  s.floor = s.bspr + nA;
  s.src = s.floor + WA;
  s.add = s.src + (size_t)Gd * WA;
  s.pred = s.add + (size_t)Gd * WA;
  s.last = s.pred + (size_t)P * WA;
  s.code = reinterpret_cast<unsigned char*>(s.last + (size_t)2 * P * WA);

  for (int t = tid; t < NCODE * NCODE; t += T) s_table[t] = a.table[t];
  const int* sb = a.seq + (size_t)b * Lp;
  const int L = a.L[b];
  // S2: the reverse read, seq shifted left by one (wrapping), the sentinel at L - 1
  for (int j = tid; j < Lp; j += T)
    s.code[j] = REV ? (j == L - 1 ? SENTINEL : sb[j + 1 < Lp ? j + 1 : 0]) : sb[j];
  const int ifirst = REV ? n - 2 : 1;
  for (int t = tid; t < nmeta; t += T) s_meta[t] = meta_at(ifirst, t);
  __syncthreads();
  int smax = 0;
  for (int t = 0; t < NCODE * NCODE; ++t) smax = max(smax, s_table[t]);
  {
    // K10: prefix sums of sm(seq[j], '-'); S2: suffix sums of sm(rev[j],
    // '-') over the read, 0 past it.  Position r is column j = r (K10) or
    // Lp - 1 - r (S2).
    int carry = 0;
    for (int t = 0; t < (Lp + T - 1) / T; ++t) {
      const int r = t * T + tid, j = REV ? Lp - 1 - r : r;
      const int gv = r < Lp && (!REV || j < L) ? s_table[s.code[j] * NCODE + GAP] : 0;
      const int v = tile_prefix_sum(gv, s_warp, carry);
      if (r < Lp) s.Gab[j] = v;
    }
  }
  __syncthreads();
  const int glast = s_table[s.code[Lp - 1] * NCODE + GAP];

  const size_t plane = (size_t)n * W;   // one path's [n, W] plane
  int* Ab = a.Aw + (size_t)b * P * plane;
  int R = NEG;   // this thread's share of the exit bound
  // K10: row 0 with its window at 0, every path at G[k] - G[0]; row n-1
  // stays 0.  S2: row n-1 in a window at the right end, every path on
  // the suffix gap chain (0 at column 0, NEG past the read); row 0 is 0.
  const int ws_last = REV ? min(max((L - W) / 8 * 8, 0), max(Lp - W, 0)) : 0;
  {
    const int g0 = s.Gab[0];
    for (int it = tid; it < P * W; it += T) {
      const int ql = it / W, k = it - ql * W;
      int* r0 = Ab + (size_t)ql * plane;
      int* rl = r0 + (size_t)(n - 1) * W;
      if (REV) {
        const int j = ws_last + k;
        const int v = j >= L ? NEG : j > 0 ? s.Gab[j] : 0;
        rl[k] = s.last[(size_t)((n - 1) & 1) * P * WA + (size_t)ql * WA + k] = v;
        r0[k] = 0;
      } else {
        r0[k] = s.last[(size_t)ql * WA + k] = s.Gab[k] - g0;
        rl[k] = 0;
      }
    }
  }
  if (tid == 0) {
    if (REV) {
      const int j = ws_last;
      if (j > 0) R = (j >= L ? NEG : s.Gab[j]) - smax * (L - 1 - j);
      s.wsr[n - 1] = ws_last;
      s.bspr[n - 1] = L - 1;
    } else if (W - 1 < L) {
      R = s.Gab[W - 1] - s.Gab[0] - smax * (W - 1);
    }
    s.wsr[0] = s.bspr[0] = 0;
    a.ws[(size_t)b * n] = 0;
    a.ws[(size_t)b * n + n - 1] = ws_last;
    s_bkey[0] = s_bkey[1] = 0;
  }
  __syncthreads();

  const bool vec = (W & 3) == 0;
  const int V = vec ? 4 : 1, nq = W / V, items = P * nq;
  const PwItem ta = pw_item(tid, items, nq, V), tb = pw_item(tid + T, items, nq, V);
  // the last row's window start and best position (K10: row i-1; S2: row i+1)
  int ws_prev = ws_last, bsp_prev = REV ? L - 1 : 0;
  int rmin_n = REV ? 0 : a.rmin[1];
  for (int step = 0; step < n - 2; ++step) {
    const int i = REV ? n - 2 - step : 1 + step;
    const int ilast = REV ? i + 1 : i - 1;
    const PwMeta mt{s_meta + (step & 1) * MW, Gd, P};
    int* next = s_meta + ((step + 1) & 1) * MW;
    const bool more = step + 1 < n - 2;
    const int inext = REV ? i - 1 : i + 1;
    const int pre = more && tid < nmeta ? meta_at(inext, tid) : 0;
    const int rmin_i = rmin_n;
    if (!REV && more) rmin_n = a.rmin[i + 1];
    // the lanes' rows of the last row (read) and of row i (written)
    const int* prev = s.last + (size_t)(ilast & 1) * P * WA;
    int* cur = s.last + (size_t)(i & 1) * P * WA;

    // this row's key starts at none (its parity was last read at the
    // last row's start, before the last row barrier); the last row's best
    // position comes from its key
    if (tid == 0) s_bkey[i & 1] = 0;
    if (step > 0) {
      const unsigned long long key = s_bkey[ilast & 1];
      const int kt = (int)(key & 0xffffffffu);
      bsp_prev = ws_prev + (REV ? (key ? W - kt : 0) : (key ? kt - 1 : W - 1));
    }

    // the window
    const int ng = mt.groups();
    int lmin = FAR, lmax = 0;
    if (REV) {
      // left of the centre of the on-lanes' successor best positions
      for (int q = lane; q < P; q += 32) {
        const int p = mt.m[1 + 2 * Gd + 2 * P + q];
        if (p < 0) continue;
        const int v = p == ilast ? bsp_prev : s.bspr[p];
        lmin = min(lmin, v);
        lmax = max(lmax, v);
      }
    } else {
      for (int g = lane; g < ng; g += 32) {
        const int p = mt.pred(g);
        const int v = p == ilast ? bsp_prev : s.bspr[p];
        lmin = min(lmin, v);
        lmax = max(lmax, v);
      }
    }
    const int ms = __reduce_min_sync(FULL, lmin), me = __reduce_max_sync(FULL, lmax);
    int ws;
    if (REV) {
      const int center = (ms + me) / 2 - 1;
      const int left_target = min(ms - 2, center) - W / 8;
      ws = min(max(min(center - W / 2, left_target), 0), max(Lp - W, 0)) / 8 * 8;
    } else {
      // centred on the predecessors' best positions, covering column
      // L - rmin[i] with W/8 to spare on the right
      const int center = (ms + me) / 2 + 1;
      const int right_target = max(me + 2, L - rmin_i + 2) + W / 8;
      ws = max(max(center - W / 2, right_target - W), 0) / 8 * 8;
    }

    // stage the lanes' source rows (shared-memory form: asynchronously)
    auto stage = [&](const PwItem& t) {
      if (t.ql < 0) return;
      const int g = mt.slot(t.ql);
      if (g < 0 || mt.pred(g) == ilast) return;   // the last row: read from `prev`
      const int qs = REV ? mt.src(t.ql) : t.ql;
      const int* src = Ab + (size_t)qs * plane + (size_t)mt.pred(g) * W + t.j0;
      int* dst = s.pred + (size_t)t.ql * WA + t.j0;
      if constexpr (SMEM) {
        if (vec) {
          cp_async<4>(dst, src, false);
        } else {
          cp_async<1>(dst, src, false);
        }
      } else if (vec) {
        pw_store<4>(dst, pw_load<4>(src, false));
      } else {
        pw_store<1>(dst, pw_load<1>(src, false));
      }
    };
    auto stage_all = [&]() {
      stage(ta);
      stage(tb);
      for (int it = tid + 2 * T; it < items; it += T) stage(pw_item(it, items, nq, V));
    };
    if constexpr (SMEM) stage_all();

    // each group's rep chain on w warps, from the block's last warp down
    const int code = mt.code();
    const int gap = s_table[code * NCODE + GAP];
    const int* sub_row = s_table + code * NCODE;
    const int w = ng > 0 ? max(1, min(PWW_CHAIN_WARPS, nwarps / ng)) : 1;
    const int rw = nwarps - 1 - warp;   // this warp counted from the last
    for (int g = rw / w; g < ng && rw < (nwarps / w) * w; g += nwarps / w) {
      const int wi = w - 1 - rw % w;
      const int rep = mt.rep(g), p = mt.pred(g);
      const int shift = ws - (p == ilast ? ws_prev : s.wsr[p]);
      const int* Ar = p == ilast ? prev + (size_t)rep * WA
                                 : Ab + (size_t)rep * plane + (size_t)p * W;
      pww_chain<REV, PWW_CW>(s, g, w, wi, Ar, W, WA, Lp, L, glast, ws, shift, gap, sub_row,
                             g == 0, s_xt);
    }
    if constexpr (SMEM) {
      asm volatile("cp.async.wait_all;" ::: "memory");
    } else {
      stage_all();
    }
    __syncthreads();

    // the replay
    int kv = INT_MIN, kc = REV ? W : -1;
    auto replay = [&](const PwItem& t) {
      if (vec) {
        pww_replay_item<REV, 4>(s, mt, t, Ab, plane, W, WA, i, ws, L, smax, ws_prev, prev, cur,
                                R, kv, kc);
      } else {
        pww_replay_item<REV, 1>(s, mt, t, Ab, plane, W, WA, i, ws, L, smax, ws_prev, prev, cur,
                                R, kv, kc);
      }
    };
    if (ta.ql >= 0) replay(ta);
    if (tb.ql >= 0) replay(tb);
    for (int it = tid + 2 * T; it < items; it += T) replay(pw_item(it, items, nq, V));
    {
      const int vmax = __reduce_max_sync(FULL, kv);
      if (REV) {
        const int cmin = __reduce_min_sync(FULL, kv == vmax ? kc : W);
        if (lane == 0 && cmin < W)
          atomicMax(&s_bkey[i & 1], (unsigned long long)((unsigned)vmax ^ 0x80000000u) << 32 |
                                        (unsigned)(W - cmin));
      } else {
        const int cmax = __reduce_max_sync(FULL, kv == vmax ? kc : -1);
        if (lane == 0 && cmax >= 0)
          atomicMax(&s_bkey[i & 1], (unsigned long long)((unsigned)vmax ^ 0x80000000u) << 32 |
                                        (unsigned)(cmax + 1));
      }
    }
    if (tid == 0) {
      s.wsr[i] = ws;
      s.bspr[ilast] = bsp_prev;
      a.ws[(size_t)b * n + i] = ws;
    }
    if (more) {
      if (tid < nmeta) next[tid] = pre;
      for (int t = tid + T; t < nmeta; t += T) next[t] = meta_at(inext, t);
    }
    ws_prev = ws;
    __syncthreads();   // publishes the row
  }

  // S2, row n-1: only the alpha (path 0) plane keeps the chain
  if (REV) {
    for (int it = tid; it < (P - 1) * W; it += T)
      Ab[(size_t)(1 + it / W) * plane + (size_t)(n - 1) * W + it % W] = 0;
  }
  // the exit bound: the max over the read's threads
  R = block_max_int(R, s_warp);
  if (tid == 0) a.bound[b] = REV ? R : R + smax * (L - 1);
}

template <bool REV>
auto pww_kernel_for(int smem_form) {
  return smem_form ? pathwise_win_kernel<REV, true> : pathwise_win_kernel<REV, false>;
}

template <bool REV>
int pww_launch(const PwwArgs& a, int B, int threads, int smem, cudaStream_t stream) {
  auto kern = pww_kernel_for<REV>(a.smem_form);
  if (B < 1 || a.n < 3 || a.P < 1 || a.Gd < 1 || a.W < 8 || a.W > a.Lp || threads < 32 ||
      threads > PWW_THREADS || threads % 32 || smem < 0 || (!REV && !a.rmin) ||
      (!a.smem_form && (a.stride < 1 || a.stride % 16)))
    return (int)cudaErrorInvalidValue;
  if (smem > 40 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool REV>
int pww_per_sm(int threads, int smem, int smem_form) {
  auto kern = pww_kernel_for<REV>(smem_form);
  if (smem > 40 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return -(int)err;
  }
  int per_sm = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, (size_t)smem);
  return err == cudaSuccess ? per_sm : -(int)err;
}

}  // namespace rgt

extern "C" int rgt_pathwise_win_fill(
    const int* seq, const int* L, const int* table, const int* meta, const int* rmin, int B,
    int n, int P, int Lp, int Gd, int W, int threads, int smem, int smem_form,
    unsigned char* scratch, long long stride, int* Aw, int* ws, int* bound, void* stream) {
  const rgt::PwwArgs a{seq, L, table, meta, rmin, n, P, Lp, Gd, W, smem_form, scratch, stride,
                       Aw, ws, bound};
  return rgt::pww_launch<false>(a, B, threads, smem, (cudaStream_t)stream);
}

extern "C" int rgt_pathwise_win_per_sm(int threads, int smem, int smem_form) {
  return rgt::pww_per_sm<false>(threads, smem, smem_form);
}

// S2: as K10 without rmin; Rr in place of the bound.
extern "C" int rgt_pathwise_rev_win_fill(
    const int* seq, const int* L, const int* table, const int* meta, int B, int n, int P,
    int Lp, int Gd, int W, int threads, int smem, int smem_form, unsigned char* scratch,
    long long stride, int* Aw, int* ws, int* Rr, void* stream) {
  const rgt::PwwArgs a{seq, L, table, meta, nullptr, n, P, Lp, Gd, W, smem_form, scratch,
                       stride, Aw, ws, Rr};
  return rgt::pww_launch<true>(a, B, threads, smem, (cudaStream_t)stream);
}

extern "C" int rgt_pathwise_rev_win_per_sm(int threads, int smem, int smem_form) {
  return rgt::pww_per_sm<true>(threads, smem, smem_form);
}
