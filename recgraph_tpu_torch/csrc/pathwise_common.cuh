// Shared pieces of the pathwise fill kernels (pathwise*.cu), on top of
// poa_common.cuh's block scans, and the one design of the dense
// pathwise fills K7 (pathwise.cu) and K8 (pathwise_rev.cu).
//
// The score tensor A[B, P, n, Lp] stays in device memory: pathwise
// predecessor spans are unbounded (a haplotype path may skip any number
// of nodes), so A is the row history, as the TPU kernels' result buffer
// in HBM is (pallas_pathwise.py:20-25).
//
// Per row, each group of the row (the distinct (rep, pred) pairs of its
// on-path lanes, encode.group_table) is solved once: the rep's (max,+)
// chain gives its D/U/L moves and, for each column j, the nearest
// non-L column k in the chain's direction.  Every lane of the group then
// replays those moves from its own plane with no scan at all:
//
//     row_q[j] = V_q[k] + G[j] - G[k],  V_q[k] the D, U or restart
//     candidate of lane q at column k,
//
// which the chain stores per (group, column) as a source column and an
// addend, so that a cell is one load and one add:
//
//     row_q[j] = (src[j] < 0 ? 0 : Aq[src[j]]) + add[j].
//
// That is the exact replay of the XLA engine (``encode_chain=False``);
// the plain form of the table is pathwise_engine.replay_table_plain.
//
// Design of K7/K8 (pathwise_fill_kernel below):
// - One read is one thread block, or a cluster of S blocks (S = 2, 4,
//   8) that split the read's lanes (paths): the card's counterpart of the
//   TPU's path tiles (pallas_pathwise_bigp.py).  Every block of a
//   cluster solves all of the row's groups (a group's rep may be another
//   block's lane, read from device memory) and replays its own lanes.
// - A group's chain runs on one warp, CW = 5 or 8 columns a lane held in
//   registers (the wrapper picks the fewest that cover the read: 5 up to
//   160 columns, the 150-bp reads), or, on longer reads, on w warps at
//   once in windows of 32 w CW columns (CW = 8; also where the scratch is
//   in device memory).  The (max,+) prefix and the nearest non-L column
//   are warp scans, carried across the group's warps through shared
//   memory and a named barrier, and across windows in registers.
// - The threads copy their replay items' source rows (a lane's plane at
//   its group's pred row, 16 bytes an item) into the scratch while the
//   chains run (cp.async, no registers), so that the replay after the
//   row's barrier reads only the scratch: one load and one add a cell,
//   four cells a thread with 16-byte stores where Lp is a multiple of 4;
//   off-path lanes are written 0 in the same pass.  A row
//   costs two barriers: after the chains and after the replay (a cluster
//   barrier when S > 1, which publishes the row's stores to the other
//   blocks).  The next row's tables load meanwhile.
// - The per-read scratch (gap sums, read codes, the (src, add) table and
//   the staged source rows: 4 (1 + 2 Gd + nl) + 1 bytes a column for nl
//   lanes) lives in shared memory when it fits, else in device memory
//   (the wrapper chooses, cuda_pathwise.plan); both forms run the same
//   code.
// - Reads of A that another block of the cluster may have written go
//   through L2 (ld.global.cg).
#pragma once

#include <cooperative_groups.h>

#include "poa_common.cuh"

namespace rgt {

struct IntMax {
  __device__ __forceinline__ int operator()(int a, int b) const { return max(a, b); }
};

struct IntSum {
  __device__ __forceinline__ int operator()(int a, int b) const { return a + b; }
};

// One tile of an inclusive prefix max carried across tiles: returns
// max(carry, prefix) and folds the tile's total into `carry`.
__device__ __forceinline__ int tile_prefix_max(int x, int* warp, int& carry) {
  int total;
  const int s = block_scan(x, warp, total, IntMax());
  const int r = max(carry, s);
  carry = max(carry, total);
  return r;
}

// One tile of an inclusive prefix sum carried across tiles.
__device__ __forceinline__ int tile_prefix_sum(int x, int* warp, int& carry) {
  int total;
  const int s = block_scan(x, warp, total, IntSum());
  const int r = carry + s;
  carry += total;
  return r;
}

// Block-wide maximum of an int; every thread gets the result.
__device__ __forceinline__ int block_max_int(int x, int* s) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x = max(x, __shfl_xor_sync(FULL, x, d));
  if (lane == 0) s[wid] = x;
  __syncthreads();
  int r = s[0];
  for (int w = 1; w < nw; ++w) r = max(r, s[w]);
  __syncthreads();
  return r;
}

// ---------------------------------------------------------------------
// K7/K8: the dense pathwise fills
// ---------------------------------------------------------------------

constexpr int SENTINEL = 6;  // scoring.SENTINEL ('$' and 'F')
// At most 512 threads a block, so that a thread may hold 128 registers: a
// chain lane keeps its columns of the rep's row, sub and G in registers,
// and ptxas spills nothing.
constexpr int PW_THREADS = 512;

// the chain's move codes: L, U, D, and the restart column (K7 column 0,
// K8 column L - 1)
enum : int { MV_L = 0, MV_U = 1, MV_D = 2, MV_R = 3 };

struct PwArgs {
  const int* seq;    // [B, Lp] '$'-prefixed read codes
  const int* L;      // [B] read lengths (K8 only)
  const int* table;  // [7, 7]
  const int* codes;  // [n]
  const int* grep;   // [n, Gd]
  const int* gpred;  // [n, Gd]
  const int* pslot;  // [n, P]
  const int* qsrc;   // [n, P] (K8 only)
  const int* gcount; // [n] the groups of each row
  int n, P, Lp, Gd;
  int restart;       // K7: not semiglobal (mode 4); K8: mode 8
  int cluster;       // blocks per read
  int smem_form;     // the per-read scratch in shared memory
  unsigned char* scratch;  // device scratch, `stride` bytes a block
  long long stride;
  int* A;            // [B, P, n, Lp]
};

__host__ __device__ inline int pw_lpa(int Lp) { return (Lp + 3) & ~3; }

__host__ __device__ inline int pw_meta_ints(int Gd, int nl) {
  return (1 + 2 * Gd + 2 * nl + 3) & ~3;
}

// The per-read scratch, in shared or device memory.
struct PwScratch {
  int* G;               // [LpA] gap prefix (K7) or suffix (K8) sums
  int* src;             // [Gd, LpA] replay source column, -1 for none
  int* add;             // [Gd, LpA] replay addend
  int* pred;            // [nl, LpA] each lane's source row, staged for the replay
  unsigned char* code;  // [LpA] read (K7) or reverse read (K8) codes
};

// Loads of A: through L2 (ld.global.cg) when another block of the
// cluster may have written the line, else through L1.
__device__ __forceinline__ int ld_a(const int* p, bool l2) { return l2 ? __ldcg(p) : *p; }

__device__ __forceinline__ int4 ld_a4(const int* p, bool l2) {
  const int4* p4 = reinterpret_cast<const int4*>(p);
  return l2 ? __ldcg(p4) : *p4;
}

// A barrier for the w warps of one chain group (named barrier 1 + g).
__device__ __forceinline__ void group_sync(int g, int w) {
  if (w == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(32 * w) : "memory");
  }
}

struct Nonl {
  int k, mv, G, sub;   // position (-1: none), move, G and sub at its column
};

constexpr Nonl NO_NONL{-1, MV_L, 0, 0};

// Lane `src`'s Nonl (three shuffles: the sub and the move share one).
__device__ __forceinline__ Nonl shfl_nonl(const Nonl& x, int src) {
  const int sm = __shfl_sync(FULL, x.sub * 4 + x.mv, src);
  return Nonl{__shfl_sync(FULL, x.k, src), sm & 3, __shfl_sync(FULL, x.G, src), sm >> 2};
}

// The chain's value x = A~ - G at column j (d and u: its D and U
// candidates), from the rep's row at the previous and this position.
template <bool REV>
__device__ __forceinline__ int chain_x(int prev, int cur, int sb, int gv, int j, int L, int gap,
                                       int rs, int& d, int& u) {
  d = prev + sb;
  u = cur + gap;
  const int a = j == (REV ? L - 1 : 0) ? (rs ? u : 0) : (REV && j >= L) ? NEG : max(d, u);
  return a - gv;
}

// One group's rep chain on w warps (wi: this warp's index among them),
// from the rep's row `Ar` (through L2 when `l2`): the group's (src, add)
// table.  Positions r = 0..Lp-1 are the columns j = r (K7) or
// j = Lp - 1 - r (K8) in chain order; they go in windows of 32 w CW
// positions, lane l of warp wi holding positions [(32 wi + l) CW, + CW)
// of a window in registers.  The (max,+) prefix and the nearest non-L
// position before each lane are warp scans, carried across the group's
// warps through s_xt / s_kt (one entry a warp of the block) and across
// windows in registers.
template <bool REV, int CW>
__device__ __forceinline__ void pw_chain(const PwScratch& s, int g, int w, int wi, const int* Ar,
                                         bool l2, int Lp, int LpA, int L, int gap,
                                         const int* sub_row, int rs, int* s_xt, Nonl* s_kt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, w0 = warp - wi;
  const int rcol = REV ? L - 1 : 0;   // the restart column
  int* xs = s.src + (size_t)g * LpA;
  int* ds = s.add + (size_t)g * LpA;
  int pc = INT_MIN;                   // the prefix max before the window
  Nonl kc = NO_NONL;                  // the nearest non-L position before it
  for (int base = 0; base < Lp; base += 32 * w * CW) {
    const int wbase = base + wi * 32 * CW;   // this warp's first position
    const int r0 = wbase + lane * CW;
    int rv[CW + 1], sb[CW], gv[CW];   // the rep's row (rv[c + 1] at r0 + c), sub, G
    rv[0] = r0 >= 1 && r0 <= Lp ? ld_a(Ar + (REV ? Lp - r0 : r0 - 1), l2) : NEG;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int r = r0 + c, j = REV ? Lp - 1 - r : r;
      const bool ok = r < Lp;
      rv[c + 1] = ok ? ld_a(Ar + j, l2) : 0;
      sb[c] = ok ? sub_row[s.code[j]] : 0;
      gv[c] = ok ? s.G[j] : 0;
    }

    // 1. the (max,+) prefix before each lane
    int m = INT_MIN;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int r = r0 + c, j = REV ? Lp - 1 - r : r;
      int d, u;
      const int x = chain_x<REV>(rv[c], rv[c + 1], sb[c], gv[c], j, L, gap, rs, d, u);
      if (r < Lp) m = max(m, x);
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, m, o);
      if (lane >= o) m = max(m, y);
    }
    int p = __shfl_up_sync(FULL, m, 1);
    if (lane == 0) p = INT_MIN;
    int wtot = __shfl_sync(FULL, m, 31);   // the window's total
    if (w > 1) {
      if (lane == 31) s_xt[warp] = m;
      group_sync(g, w);
      wtot = INT_MIN;
      for (int v = 0; v < w; ++v) {
        if (v < wi) p = max(p, s_xt[w0 + v]);
        wtot = max(wtot, s_xt[w0 + v]);
      }
    }
    p = max(p, pc);
    pc = max(pc, wtot);

    // 2. the moves (tie order D, U, else L; the restart column always
    //    restarts) and the lane's last non-L position
    int mvs = 0;
    Nonl kl = NO_NONL;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int r = r0 + c, j = REV ? Lp - 1 - r : r;
      int d, u;
      p = max(p, chain_x<REV>(rv[c], rv[c + 1], sb[c], gv[c], j, L, gap, rs, d, u));
      const int row = gv[c] + p;
      const int mv = j == rcol ? MV_R : row == d ? MV_D : row == u ? MV_U : MV_L;
      if (r < Lp && mv != MV_L) {
        mvs |= mv << (2 * c);
        kl = Nonl{r, mv, gv[c], sb[c]};
      }
    }
    // the nearest non-L position before each lane: a max scan of the
    // positions, the rest fetched from the lane that holds it
    int ki = kl.k;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, ki, o);
      if (lane >= o) ki = max(ki, y);
    }
    const int ke = __shfl_up_sync(FULL, ki, 1);
    const int kw = __shfl_sync(FULL, ki, 31);   // the warp's last
    Nonl k = shfl_nonl(kl, lane > 0 && ke >= 0 ? (ke - wbase) / CW : 0);
    if (lane == 0 || ke < 0) k = NO_NONL;
    Nonl wl = shfl_nonl(kl, kw >= 0 ? (kw - wbase) / CW : 0);
    if (kw < 0) wl = NO_NONL;
    if (w > 1) {
      if (lane == 31) s_kt[warp] = wl;
      group_sync(g, w);
      for (int v = wi - 1; v >= 0 && k.k < 0; --v) k = s_kt[w0 + v];
      wl = NO_NONL;
      for (int v = w - 1; v >= 0 && wl.k < 0; --v) wl = s_kt[w0 + v];
    }
    if (k.k < 0) k = kc;
    if (wl.k >= 0) kc = wl;

    // 3. the (src, add) table: 0 at K8's column 0 and past the read
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int r = r0 + c, j = REV ? Lp - 1 - r : r;
      const int mv = (mvs >> (2 * c)) & 3;
      if (mv != MV_L) k = Nonl{r, mv, gv[c], sb[c]};
      if (r < Lp) {
        int sv = -1, av = 0;
        if (k.k >= 0 && !(REV && (j == 0 || j >= L))) {
          const int kj = REV ? Lp - 1 - k.k : k.k;
          sv = k.mv == MV_R ? (rs ? kj : -1) : k.mv == MV_D ? (REV ? kj + 1 : kj - 1) : kj;
          av = (k.mv == MV_R ? (rs ? gap : 0) : k.mv == MV_D ? k.sub : gap) + gv[c] - k.G;
        }
        xs[j] = sv;
        ds[j] = av;
      }
    }
  }
}

// The per-row tables of the graph, staged one row ahead in shared
// memory: the node code and the row's group count (code | count << 8),
// grep[Gd], gpred[Gd], then pslot and (K8) qsrc of the block's lanes.
struct PwMeta {
  int* m;
  int Gd, nl;
  __device__ int code() const { return m[0] & 0xff; }
  __device__ int groups() const { return m[0] >> 8; }
  __device__ int rep(int g) const { return m[1 + g]; }
  __device__ int pred(int g) const { return m[1 + Gd + g]; }
  __device__ int slot(int ql) const { return m[1 + 2 * Gd + ql]; }
  __device__ int src(int ql) const { return m[1 + 2 * Gd + nl + ql]; }
};

// Entry t of row i's tables.
template <bool REV>
__device__ __forceinline__ int pw_meta_load(const PwArgs& a, int i, int q0, int nl, int t) {
  const int Gd = a.Gd;
  if (t == 0) return a.codes[i] | a.gcount[i] << 8;
  if (t <= Gd) return a.grep[(size_t)i * Gd + t - 1];
  if (t <= 2 * Gd) return a.gpred[(size_t)i * Gd + t - 1 - Gd];
  t -= 1 + 2 * Gd;
  if (t < nl) return a.pslot[(size_t)i * a.P + q0 + t];
  return REV ? a.qsrc[(size_t)i * a.P + q0 + t - nl] : 0;
}

template <int V>
struct Cells {
  int v[V];
};

template <int V>
__device__ __forceinline__ Cells<V> pw_load(const int* p, bool l2) {
  Cells<V> o;
  if constexpr (V == 4) {
    const int4 t = ld_a4(p, l2);
    o.v[0] = t.x; o.v[1] = t.y; o.v[2] = t.z; o.v[3] = t.w;
  } else {
#pragma unroll
    for (int t = 0; t < V; ++t) o.v[t] = ld_a(p + t, l2);
  }
  return o;
}

template <int V>
__device__ __forceinline__ void pw_store(int* out, const Cells<V>& o) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(out) = make_int4(o.v[0], o.v[1], o.v[2], o.v[3]);
  } else {
#pragma unroll
    for (int t = 0; t < V; ++t) out[t] = o.v[t];
  }
}

// A replay item: V columns from j0 of the block's lane ql (it = ql nq +
// j0 / V, nq = Lp / V items a lane); ql < 0 past the row's items.
struct PwItem {
  int ql, j0;
};

__device__ __forceinline__ PwItem pw_item(int it, int items, int nq, int V) {
  if (it >= items) return PwItem{-1, 0};
  const int ql = it / nq;
  return PwItem{ql, (it - ql * nq) * V};
}

// The row's source row of item `t` (its lane's plane at its group's pred
// row; K8: its source plane), or null off-path; `l2` if another block
// wrote it.
template <bool REV>
__device__ __forceinline__ const int* pw_source(const PwMeta& mt, const PwItem& t, int* Ab,
                                                size_t plane, int Lp, int q0, int cluster,
                                                bool& l2) {
  if (t.ql < 0) return nullptr;
  const int g = mt.slot(t.ql);
  if (g < 0) return nullptr;
  const int qs = REV ? mt.src(t.ql) : q0 + t.ql;
  l2 = cluster > 1 && (qs < q0 || qs >= q0 + mt.nl);
  return Ab + (size_t)qs * plane + (size_t)mt.pred(g) * Lp + t.j0;
}

// The cells of item t from the (src, add) tables and the staged source
// rows, stored into row i of A.
template <int V>
__device__ __forceinline__ void pw_replay_item(const PwScratch& s, const PwMeta& mt,
                                               const PwItem& t, int* Ab, size_t plane, int Lp,
                                               int LpA, int q0, int i) {
  const int g = mt.slot(t.ql);
  Cells<V> o;
  if (g < 0) {
#pragma unroll
    for (int c = 0; c < V; ++c) o.v[c] = 0;
  } else {
    const int* sg = s.src + (size_t)g * LpA + t.j0;
    const int* ag = s.add + (size_t)g * LpA + t.j0;
    const int* row = s.pred + (size_t)t.ql * LpA;
    int sv[V], av[V];
    if constexpr (V == 4) {
      const int4 s4 = *reinterpret_cast<const int4*>(sg);
      const int4 a4 = *reinterpret_cast<const int4*>(ag);
      sv[0] = s4.x; sv[1] = s4.y; sv[2] = s4.z; sv[3] = s4.w;
      av[0] = a4.x; av[1] = a4.y; av[2] = a4.z; av[3] = a4.w;
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        sv[c] = sg[c];
        av[c] = ag[c];
      }
    }
#pragma unroll
    for (int c = 0; c < V; ++c) o.v[c] = (sv[c] < 0 ? 0 : row[sv[c]]) + av[c];
  }
  pw_store<V>(Ab + (size_t)(q0 + t.ql) * plane + (size_t)i * Lp + t.j0, o);
}

// Copy V ints of A into shared memory without registers (cp.async;
// through L2 when `l2`).
template <int V>
__device__ __forceinline__ void cp_async(int* dst, const int* src, bool l2) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (V == 4) {
    if (l2) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
    }
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void pw_row_sync(int cluster) {
  if (cluster > 1) {
    cooperative_groups::this_cluster().sync();   // release/acquire at cluster scope
  } else {
    __syncthreads();
  }
}

// One row i.  The lanes' source rows are staged in s.pred: copied while
// the chains run, without registers (cp.async), when the scratch is in
// shared memory, else after the chains.  After a barrier the replay
// reads only the scratch.
template <bool REV, int V, int CW, bool SMEM>
__device__ __forceinline__ void pw_row(const PwArgs& a, const PwScratch& s, const PwMeta& mt,
                                       const PwItem& ta, const PwItem& tb, int* Ab,
                                       size_t plane, int q0, int i, int L, const int* s_table,
                                       int* s_xt, Nonl* s_kt) {
  const int Lp = a.Lp, LpA = pw_lpa(Lp), tid = threadIdx.x, T = blockDim.x;
  const int warp = tid >> 5, nwarps = T >> 5;
  const int nq = Lp / V, items = mt.nl * nq;
  // stage item t's source row (SMEM: asynchronously)
  auto stage = [&](const PwItem& t) {
    bool l2 = false;
    const int* p = pw_source<REV>(mt, t, Ab, plane, Lp, q0, a.cluster, l2);
    if (!p) return;
    int* dst = s.pred + (size_t)t.ql * LpA + t.j0;
    if constexpr (SMEM) {
      cp_async<V>(dst, p, l2);
    } else {
      pw_store<V>(dst, pw_load<V>(p, l2));
    }
  };
  auto stage_all = [&]() {
    stage(ta);
    stage(tb);
    for (int it = tid + 2 * T; it < items; it += T) stage(pw_item(it, items, nq, V));
  };
  if constexpr (SMEM) stage_all();

  // the row's groups: one warp each where a warp covers the read, else w
  // warps each (up to enough for one window)
  const int code = mt.code(), ng = mt.groups();
  const int gap = s_table[code * NCODE + GAP];
  const int* sub_row = s_table + code * NCODE;
  int w = 1;
  if (Lp > 32 * CW && ng > 0 && ng < 16)
    w = max(1, min(nwarps / ng, (Lp + 32 * CW - 1) / (32 * CW)));
  const int g0 = w == 1 ? warp : warp / w, wi = w == 1 ? 0 : warp % w;
  for (int g = g0; g < ng; g += w == 1 ? nwarps : nwarps / w) {
    const int rep = mt.rep(g);
    pw_chain<REV, CW>(s, g, w, wi, Ab + (size_t)rep * plane + (size_t)mt.pred(g) * Lp,
                      a.cluster > 1 && (rep < q0 || rep >= q0 + mt.nl), Lp, LpA, L, gap,
                      sub_row, a.restart, s_xt, s_kt);
  }
  if constexpr (SMEM) {
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    stage_all();
  }
  __syncthreads();

  if (ta.ql >= 0) pw_replay_item<V>(s, mt, ta, Ab, plane, Lp, LpA, q0, i);
  if (tb.ql >= 0) pw_replay_item<V>(s, mt, tb, Ab, plane, Lp, LpA, q0, i);
  for (int it = tid + 2 * T; it < items; it += T)
    pw_replay_item<V>(s, mt, pw_item(it, items, nq, V), Ab, plane, Lp, LpA, q0, i);
}

// K7 (REV = false) and K8 (REV = true), the scratch in shared memory
// (SMEM) or in device memory, the chain CW columns a lane.  Block x
// of the grid is block r = x % S of read x / S, which owns lanes
// [r P / S, (r + 1) P / S).  Dynamic shared memory: the row tables twice
// (pw_meta_ints), then, in the shared-memory form, the per-read scratch.
template <bool REV, bool SMEM, int CW>
__global__ void __launch_bounds__(PW_THREADS, 1)
pathwise_fill_kernel(const PwArgs a) {
  __shared__ int s_table[NCODE * NCODE];
  __shared__ int s_warp[32];
  __shared__ int s_xt[32];     // the chains' carries across warps
  __shared__ Nonl s_kt[32];
  extern __shared__ int4 s_dyn[];

  const int S = a.cluster;
  const int b = blockIdx.x / S, rank = blockIdx.x % S;
  const int P = a.P, Lp = a.Lp, Gd = a.Gd, n = a.n;
  const int q0 = rank * P / S, nl = (rank + 1) * P / S - q0;
  const int tid = threadIdx.x, T = blockDim.x;
  const int LpA = pw_lpa(Lp);
  const int MW = pw_meta_ints(Gd, nl), nmeta = 1 + 2 * Gd + 2 * nl;
  int* s_meta = reinterpret_cast<int*>(s_dyn);   // [2, MW]
  unsigned char* base = SMEM ? reinterpret_cast<unsigned char*>(s_meta + 2 * MW)
                             : a.scratch + (size_t)blockIdx.x * a.stride;
  PwScratch s;
  s.G = reinterpret_cast<int*>(base);
  s.src = s.G + LpA;
  s.add = s.src + (size_t)Gd * LpA;
  s.pred = s.add + (size_t)Gd * LpA;
  s.code = reinterpret_cast<unsigned char*>(s.pred + (size_t)nl * LpA);

  for (int t = tid; t < NCODE * NCODE; t += T) s_table[t] = a.table[t];
  const int* sb = a.seq + (size_t)b * Lp;
  const int L = REV ? a.L[b] : Lp;
  // the reverse read: seq shifted left by one (wrapping), the sentinel at L - 1
  for (int j = tid; j < Lp; j += T)
    s.code[j] = REV ? (j == L - 1 ? SENTINEL : sb[j + 1 < Lp ? j + 1 : 0]) : sb[j];
  for (int t = tid; t < nmeta; t += T)
    s_meta[t] = pw_meta_load<REV>(a, REV ? n - 2 : 1, q0, nl, t);
  __syncthreads();

  // G: prefix sums of sm(seq[j], '-') (K7); suffix sums of sm(rev[j],
  // '-') over the read, 0 past it (K8).  Thread tid of tile t owns
  // position t * T + tid.
  {
    int carry = 0;
    for (int t = 0; t < (Lp + T - 1) / T; ++t) {
      const int r = t * T + tid;
      const int j = REV ? Lp - 1 - r : r;
      const int g = (r < Lp && (!REV || j < L)) ? s_table[s.code[j] * NCODE + GAP] : 0;
      const int v = tile_prefix_sum(g, s_warp, carry);
      if (r < Lp) s.G[j] = v;
    }
  }
  __syncthreads();

  const size_t plane = (size_t)n * Lp;   // one path's [n, Lp] plane
  int* Ab = a.A + (size_t)b * P * plane;
  // K7: row 0 = G - G[0], row n-1 = 0; K8: row 0 = 0, row n-1 the suffix
  // gap chain on every plane while the rows above read it
  {
    const int g0 = s.G[0];
    for (int it = tid; it < nl * Lp; it += T) {
      const int ql = it / Lp, j = it - ql * Lp;
      int* r0 = Ab + (size_t)(q0 + ql) * plane;
      int* rl = r0 + (size_t)(n - 1) * Lp;
      const int v = REV ? (j > 0 && j < L ? s.G[j] : 0) : s.G[j] - g0;
      r0[j] = REV ? 0 : v;
      rl[j] = REV ? v : 0;
    }
  }
  pw_row_sync(S);

  // each thread's first two replay items, the same in every row
  const bool vec = (Lp & 3) == 0;
  const int V = vec ? 4 : 1, nq = Lp / V, items = nl * nq;
  const PwItem ta = pw_item(tid, items, nq, V), tb = pw_item(tid + T, items, nq, V);
  for (int step = 0; step < n - 2; ++step) {
    const int i = REV ? n - 2 - step : 1 + step;
    const PwMeta mt{s_meta + (step & 1) * MW, Gd, nl};
    int* next = s_meta + ((step + 1) & 1) * MW;
    // the next row's tables load while this row runs
    const bool more = step + 1 < n - 2;
    const int inext = REV ? i - 1 : i + 1;
    const int pre = more && tid < nmeta ? pw_meta_load<REV>(a, inext, q0, nl, tid) : 0;
    if (vec) {
      pw_row<REV, 4, CW, SMEM>(a, s, mt, ta, tb, Ab, plane, q0, i, L, s_table, s_xt, s_kt);
    } else {
      pw_row<REV, 1, CW, SMEM>(a, s, mt, ta, tb, Ab, plane, q0, i, L, s_table, s_xt, s_kt);
    }
    if (more) {
      if (tid < nmeta) next[tid] = pre;
      for (int t = tid + T; t < nmeta; t += T) next[t] = pw_meta_load<REV>(a, inext, q0, nl, t);
    }
    pw_row_sync(S);   // publishes the row
  }

  // K8, row n-1: only the alpha (path 0) plane keeps the chain
  if (REV) {
    for (int it = tid; it < nl * Lp; it += T) {
      const int ql = it / Lp, j = it - ql * Lp;
      if (q0 + ql > 0) Ab[(size_t)(q0 + ql) * plane + (size_t)(n - 1) * Lp + j] = 0;
    }
  }
}

// The kernel for a launch: direction, scratch form, chain columns a lane
// (5 or 8 with the scratch in shared memory, 8 in device memory; null for
// any other).
template <bool REV>
auto pathwise_kernel_for(int smem_form, int cw) {
  decltype(&pathwise_fill_kernel<REV, true, 8>) k = nullptr;
  if (smem_form) {
    k = cw == 5 ? pathwise_fill_kernel<REV, true, 5>
      : cw == 8 ? pathwise_fill_kernel<REV, true, 8> : nullptr;
  } else if (cw == 8) {
    k = pathwise_fill_kernel<REV, false, 8>;
  }
  return k;
}

// Launch K7 or K8: B reads, `a.cluster` blocks of `threads` a read, with
// `smem` bytes of dynamic shared memory, the chains `cw` columns a lane.
template <bool REV>
int pathwise_launch(const PwArgs& a, int B, int threads, int smem, int cw,
                    cudaStream_t stream) {
  auto kern = pathwise_kernel_for<REV>(a.smem_form, cw);
  if (B < 1 || a.n < 3 || a.P < 1 || a.Lp < 1 || a.Gd < 1 || a.cluster < 1 ||
      a.cluster > 8 || a.cluster > a.P || threads < 32 || threads > PW_THREADS ||
      threads % 32 || smem < 0 || (!a.smem_form && (a.stride < 1 || a.stride % 16)) || !kern)
    return (int)cudaErrorInvalidValue;
  if (smem > 40 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * a.cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Blocks of K7 (REV = false) or K8 that one SM holds at once.
template <bool REV>
int pathwise_per_sm(int threads, int smem, int smem_form, int cw) {
  auto kern = pathwise_kernel_for<REV>(smem_form, cw);
  if (!kern) return -(int)cudaErrorInvalidValue;
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
