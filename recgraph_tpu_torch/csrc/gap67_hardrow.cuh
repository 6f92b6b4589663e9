// The modes-6/7 hard-row column program (K12) as __device__ functions.
//
// Port of the TPU kernel recgraph_tpu/ops/pallas_gap67_hardrow.py:175
// hard_cols_lc, which runs the in-row L/x affine coupling of a hard row
// of the delta-form fill (pathwise_gap_engine.hard_row's column scan,
// recgraph_tpu/ops/pathwise_gap_engine.py:648-695, mirroring
// pathwise_alignment_gap.rs:150-539).  It carries x and d over the
// row's columns for the P lanes of one read; every other input was
// staged column-parallel by the caller, per lane (path q, column j):
//
//   V[q, j] = max(Dc, U) of the lane's owning block
//   W[q, j] = the owner's D source Dfd if Dc >= U, else the pre-fixup y
//
// so a lane's d is max(V, l) on its owner's tb lane and (V >= l ? W :
// x) elsewhere (pathwise_gap_engine.chain_inputs): the plain program's
// D/U/L choice with its tie order, and no per-block input in the chain.
//
// Lane coefficients (pathwise_gap_engine.chain_coefs, built once per
// graph): the hubs, the row alpha and the tb lanes of the owning and
// firing blocks, are the only lanes whose values other lanes read.
// Slots put them first; per slot, slots[4, P] holds its path, the slot
// of its owner's tb lane (-1 unowned), the slot whose pre-fixup value
// its fixup reads (-1 none) and its CF_* flags.  The multi-alpha fixup
// is then one correction per lane, t = v[fix] - v[alpha] - after * adj
// with adj = v[isa] - v[alpha] (fire tb lanes are distinct and fixup
// member sets disjoint; pathwise_gap_engine.gap_meta checks both).
//
// With at most 32 hubs, one warp runs slots 0-31 with x and d in
// registers: the previous column's tb and alpha values and the pre-fixup
// values the fixup reads come by __shfl_sync (ten a column in two
// rounds, no shared memory, no loop over blocks); V and W arrive as
// 16-byte vectors one group of four columns ahead; x and d leave as
// 16-byte vectors every four columns.  Slots 32 and up (P > 32, never
// hubs) follow once the chain is done (gap67_chain_rest), a warp a slot,
// 32 columns at a time as a scan over the lanes that reads the hubs'
// values from the output planes, coalesced.  (Run beside the chain,
// their shuffles and loads slowed the chain's own shuffles several fold.)
// More than 32 hubs (a row with 32 or more predecessor blocks) take
// gap67_chain_smem: one warp over every slot, state in shared memory.
#pragma once

#include "poa_common.cuh"

namespace rgt {

enum : int { CF_ND = 1, CF_HOT = 2, CF_HOTL = 4, CF_AFTER = 8 };
constexpr int CHAIN_WARP = 32;          // slots held in the chain warp's registers

// One hard row of one read.
struct HardRow {
  const int* V;      // per path: V[q * vs + j], columns 1..Lp-1
  const int* W;
  int vs;            // multiple of 4
  const int* slots;  // [4, P] chain_coefs
  const int* x0;     // [P] per path: column 0 of x and d
  int P, H, ai, isa; // paths, hubs, slot of the row alpha, isa slot (-1 none)
  int o, e;
  int* X;            // per path: X[q * Lp + j]; column 0 is written x0
  int* D;
  int Lp;            // columns, a multiple of 4
};

__device__ __forceinline__ int lane_of(const int4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// Slots 0-31 on one warp (H <= 32), called by all 32 threads of warp 0:
// per column one round of shuffles brings the previous column's tb and
// alpha values, a second the pre-fixup values the fixup reads.  Kept out
// of line: inlined into the fill, the column loop ran slower on the H100.
static __device__ __noinline__ void gap67_chain_warp(const HardRow& r) {
  const int lane = threadIdx.x & 31;
  const bool live = lane < r.P;
  int q = 0, tbs = -1, fxs = -1, fl = 0;
  if (live) {
    q = r.slots[lane];
    tbs = r.slots[r.P + lane];
    fxs = r.slots[2 * r.P + lane];
    fl = r.slots[3 * r.P + lane];
  }
  const bool owned = tbs >= 0, fix = fxs >= 0;
  const bool hot = fl & CF_HOT, hotl = fl & CF_HOTL;
  const int src_tb = owned ? tbs : lane, src_fx = fix ? fxs : lane;
  const int nd = (fl & CF_ND) ? 1 : 0, aft = (fl & CF_AFTER) ? 1 : 0;
  const int ai = r.ai, e = r.e, oe = r.o + r.e;
  const bool has_isa = r.isa >= 0;
  const int src_isa = has_isa ? r.isa : 0;
  int x = live ? r.x0[q] : 0, d = x;
  const int4* Vr = reinterpret_cast<const int4*>(r.V + (size_t)q * r.vs);
  const int4* Wr = reinterpret_cast<const int4*>(r.W + (size_t)q * r.vs);
  int4* Xr = reinterpret_cast<int4*>(r.X + (size_t)q * r.Lp);
  int4* Dr = reinterpret_cast<int4*>(r.D + (size_t)q * r.Lp);
  const int ng = r.Lp >> 2;
  int4 v = Vr[0], w = Wr[0];
  for (int m = 0; m < ng; ++m) {
    int4 vn = v, wn = w;
    if (m + 1 < ng) {
      vn = Vr[m + 1];
      wn = Wr[m + 1];
    }
    int bx[4], bd[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (m > 0 || k > 0) {   // column 0 keeps x0
        const int vv = lane_of(v, k), ww = lane_of(w, k);
        const int sx = __shfl_sync(FULL, x, src_tb), sd = __shfl_sync(FULL, d, src_tb);
        const int ax = __shfl_sync(FULL, x, ai), ad = __shfl_sync(FULL, d, ai);
        const int lx = sx + nd * ax + e, ld = sd + nd * ad + oe;
        const bool lsel = ld >= lx;
        const int l = lsel ? ld : lx;
        int xv = hot ? l : (lsel ? d - nd * sd : x - nd * sx);
        int dv = hot ? max(vv, l) : (vv >= l ? ww : xv);
        if (!owned) xv = dv = 0;
        // the multi-alpha fixup (gap.rs:521-537)
        const int xai = __shfl_sync(FULL, xv, ai), dai = __shfl_sync(FULL, dv, ai);
        int adj_x = 0, adj_d = 0;
        if (has_isa) {
          adj_x = __shfl_sync(FULL, xv, src_isa) - xai;
          adj_d = __shfl_sync(FULL, dv, src_isa) - dai;
        }
        const int tx = __shfl_sync(FULL, xv, src_fx) - xai - aft * adj_x;
        const int td = __shfl_sync(FULL, dv, src_fx) - dai - aft * adj_d;
        x = hotl ? tx : (fix ? xv + tx : xv);
        d = hotl ? td : (fix ? dv + td : dv);
      }
      bx[k] = x;
      bd[k] = d;
    }
    if (live) {
      Xr[m] = make_int4(bx[0], bx[1], bx[2], bx[3]);
      Dr[m] = make_int4(bd[0], bd[1], bd[2], bd[3]);
    }
    v = vn;
    w = wn;
  }
}

// A column of a lane past the hubs as a map of its previous (x, d):
// each output is x, d or 0 (sel 0, 1, 2) plus an offset.  Maps compose,
// so a warp scans a tile's columns at once.
struct ColMap {
  int sel;   // x's source | d's source << 2
  int ox, od;
};

// `g` after `f`.
__device__ __forceinline__ ColMap compose(const ColMap& f, const ColMap& g) {
  const int gx = g.sel & 3, gd = g.sel >> 2;
  const int fx = f.sel & 3, fd = f.sel >> 2;
  ColMap h;
  h.sel = (gx == 2 ? 2 : (gx == 0 ? fx : fd)) | (gd == 2 ? 2 : (gd == 0 ? fx : fd)) << 2;
  h.ox = g.ox + (gx == 2 ? 0 : (gx == 0 ? f.ox : f.od));
  h.od = g.od + (gd == 2 ? 0 : (gd == 0 ? f.ox : f.od));
  return h;
}

// Slots 32..P-1 (never hubs) after gap67_chain_warp, a warp a slot, 32
// columns at a time: each lane takes one column, builds its map from the
// hubs' x and d in the output planes (its owner's tb lane and the alpha
// the column before; its fix block's tb lane this column, whose
// post-fixup value its fixup adds) and V, W, and a scan over the lanes
// composes the 32 maps; applied to the lane's state before them they
// give its x and d, stored coalesced.  Called by every warp of the block.
__device__ __forceinline__ void gap67_chain_rest(const HardRow& r) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int ai = r.ai, e = r.e, oe = r.o + r.e;
  const int* Qs = r.slots;
  const int* Xa = r.X + (size_t)Qs[ai] * r.Lp;
  const int* Da = r.D + (size_t)Qs[ai] * r.Lp;
  for (int k = CHAIN_WARP + (threadIdx.x >> 5); k < r.P; k += nw) {
    const int q = Qs[k], tbs = Qs[r.P + k], fxs = Qs[2 * r.P + k];
    const int nd = (Qs[3 * r.P + k] & CF_ND) ? 1 : 0;
    const size_t qt = (size_t)Qs[tbs >= 0 ? tbs : 0] * r.Lp;
    const size_t qf = (size_t)Qs[fxs >= 0 ? fxs : 0] * r.Lp;
    const int *Xt = r.X + qt, *Dt = r.D + qt, *Xf = r.X + qf, *Df = r.D + qf;
    int* Xq = r.X + (size_t)q * r.Lp;
    int* Dq = r.D + (size_t)q * r.Lp;
    int cx = r.x0[q], cd = cx;   // the state before the 32 columns
    for (int j0 = 0; j0 < r.Lp; j0 += 32) {
      const int j = j0 + lane;
      ColMap mp{0 | 1 << 2, 0, 0};   // identity (column 0 is x0)
      if (j > 0 && j < r.Lp) {
        const int fa_x = fxs >= 0 ? Xf[j] : 0, fa_d = fxs >= 0 ? Df[j] : 0;
        if (tbs < 0) {
          mp = ColMap{2 | 2 << 2, fa_x, fa_d};
        } else {
          const int sx = Xt[j - 1], sd = Dt[j - 1], ax = Xa[j - 1], ad = Da[j - 1];
          const int v = r.V[(size_t)q * r.vs + j], w = r.W[(size_t)q * r.vs + j];
          const int lx = sx + nd * ax + e, ld = sd + nd * ad + oe;
          const bool lsel = ld >= lx;
          const int l = lsel ? ld : lx;
          const int src = lsel ? 1 : 0, off = lsel ? -nd * sd : -nd * sx;   // x before the fixup
          mp.sel = src | (v >= l ? 2 : src) << 2;
          mp.ox = off + fa_x;
          mp.od = (v >= l ? w : off) + fa_d;
        }
      }
#pragma unroll
      for (int dl = 1; dl < 32; dl <<= 1) {
        ColMap f;
        f.sel = __shfl_up_sync(FULL, mp.sel, dl);
        f.ox = __shfl_up_sync(FULL, mp.ox, dl);
        f.od = __shfl_up_sync(FULL, mp.od, dl);
        if (lane >= dl) mp = compose(f, mp);
      }
      const int sx_ = mp.sel & 3, sd_ = mp.sel >> 2;
      const int x = (sx_ == 0 ? cx : (sx_ == 1 ? cd : 0)) + mp.ox;
      const int d = (sd_ == 0 ? cx : (sd_ == 1 ? cd : 0)) + mp.od;
      if (j < r.Lp) {
        Xq[j] = x;
        Dq[j] = d;
      }
      cx = __shfl_sync(FULL, x, 31);   // past the row, lanes carry the identity
      cd = __shfl_sync(FULL, d, 31);
    }
  }
}

// Every slot on one warp with the state in shared memory (`st`, 4 P
// ints): any number of hubs.  Called by all 32 threads of warp 0.
__device__ __forceinline__ void gap67_chain_smem(const HardRow& r, int* st) {
  const int lane = threadIdx.x & 31, P = r.P;
  const int ai = r.ai, o = r.o, e = r.e;
  int* xc = st;            // per slot: the previous column
  int* dc = st + P;
  int* xn = st + 2 * P;    // this column before the fixup
  int* dn = st + 3 * P;
  for (int k = lane; k < P; k += 32) {
    const int q = r.slots[k], v = r.x0[q];
    xc[k] = dc[k] = v;
    r.X[(size_t)q * r.Lp] = v;
    r.D[(size_t)q * r.Lp] = v;
  }
  __syncwarp();
  for (int j = 1; j < r.Lp; ++j) {
    const int ax = xc[ai], ad = dc[ai];
    for (int k = lane; k < P; k += 32) {
      const int q = r.slots[k], tbs = r.slots[P + k], fl = r.slots[3 * P + k];
      int xv = 0, dv = 0;
      if (tbs >= 0) {
        const int nd = (fl & CF_ND) ? 1 : 0;
        const int sx = xc[tbs], sd = dc[tbs];
        const int lx = sx + nd * ax + e, ld = sd + nd * ad + o + e;
        const bool lsel = ld >= lx;
        const int l = lsel ? ld : lx;
        const int vv = r.V[(size_t)q * r.vs + j];
        if (fl & CF_HOT) {
          xv = l;
          dv = max(vv, l);
        } else {
          xv = lsel ? dc[k] - nd * sd : xc[k] - nd * sx;
          dv = vv >= l ? r.W[(size_t)q * r.vs + j] : xv;
        }
      }
      xn[k] = xv;
      dn[k] = dv;
    }
    __syncwarp();
    const int xai = xn[ai], dai = dn[ai];
    const int adj_x = r.isa >= 0 ? xn[r.isa] - xai : 0;
    const int adj_d = r.isa >= 0 ? dn[r.isa] - dai : 0;
    for (int k = lane; k < P; k += 32) {
      const int q = r.slots[k], fxs = r.slots[2 * P + k], fl = r.slots[3 * P + k];
      int x = xn[k], d = dn[k];
      if (fxs >= 0) {
        const int aft = (fl & CF_AFTER) ? 1 : 0;
        const int tx = xn[fxs] - xai - aft * adj_x, td = dn[fxs] - dai - aft * adj_d;
        x = (fl & CF_HOTL) ? tx : x + tx;
        d = (fl & CF_HOTL) ? td : d + td;
      }
      xc[k] = x;
      dc[k] = d;
      r.X[(size_t)q * r.Lp + j] = x;
      r.D[(size_t)q * r.Lp + j] = d;
    }
    __syncwarp();
  }
}

// The whole program for one row, called by every thread of the block:
// gap67_chain_warp on warp 0 while the other warps run side(): K11's y
// fixup (nothing for K12's entry); then, for P > 32, gap67_chain_rest on
// every warp.  Past 32 hubs, gap67_chain_smem instead.
template <class Side>
__device__ __forceinline__ void gap67_hard_row(const HardRow& r, int* st, Side side) {
  const bool regs = r.H <= CHAIN_WARP;
  if (threadIdx.x < 32) {
    if (regs) gap67_chain_warp(r);
    else gap67_chain_smem(r, st);
  } else {
    side();
  }
  if (regs && r.P > CHAIN_WARP) {
    __syncthreads();
    gap67_chain_rest(r);
  }
}

}  // namespace rgt
