// The modes-6/7 hard-row column program (K12) as a __device__ function.
//
// Port of the TPU kernel recgraph_tpu/ops/pallas_gap67_hardrow.py:175
// hard_cols_lc, which runs the in-row L/x affine coupling of a hard row
// of the delta-form fill (pathwise_gap_engine.hard_row's column scan,
// recgraph_tpu/ops/pathwise_gap_engine.py:648-695, mirroring
// pathwise_alignment_gap.rs:150-539).  It carries x and d over the
// row's columns for the P lanes of one read; every other input was
// staged column-parallel by the caller:
//
//   U, Dc      [MB, C]  each block's U and D candidates per column
//   Dfd, Ypre  [P, C]   per lane: the owning block's D source (pred
//                       column j-1, rebased) and the pre-fixup y
//   lanes      4 x [P]  own (owning block, -1 none), hot (the lane is its
//                       owner's tb lane), fix (the fire block whose fixup
//                       members hold the lane, -1 none), hotl (the lane
//                       is a firing block's tb lane)
//   blocks     5 x [MB] tb, nd (tb != row alpha), fire, isa, after
//
// Per column every block's scalar chain reads its tb lane and the row
// alpha of the previous column's state; each lane then takes its owning
// block's formula, and the multi-alpha fixup adds the one correction
// that closes the cascade (fire tb lanes are distinct and fixup member
// sets disjoint; pathwise_gap_engine.gap_meta checks both on the host).
//
// One warp runs the program, lanes striding over the paths; the state
// (x, d and their next values) lives in shared memory, so any P works
// and a column needs two __syncwarp() and no block barrier.  The
// caller's other warps wait at its next __syncthreads().
#pragma once

#include "poa_common.cuh"

namespace rgt {

struct HardBlocks {
  const int* tb;
  const int* nd;
  const int* fire;
  const int* isa;
  const int* after;
  int MB;
};

struct HardLanes {
  const int* own;
  const int* hot;
  const int* fix;
  const int* hotl;
};

// Run the program over columns c = 0..C-1 (element (s, c) of U/Dc at
// U[s * sstride + c], (q, c) of Dfd/Ypre at Dfd[q * qstride + c]) from
// the column state x0[P]; writes the post-fixup x and d of column c to
// xs[q * ostride + c] and ds[...].  Called by all 32 threads of one
// warp.  `st` is 4 * P ints of shared memory.
__device__ __forceinline__ void gap67_hard_cols(
    const int* __restrict__ U, const int* __restrict__ Dc, int sstride,
    const int* __restrict__ Dfd, const int* __restrict__ Ypre, int qstride, int C,
    const HardBlocks blk, const HardLanes ln, const int* x0, int P, int ai, int o, int e,
    int* __restrict__ xs, int* __restrict__ ds, int ostride, int* st) {
  const int lane = threadIdx.x & 31;
  int* xc = st;            // state of the previous column
  int* dc = st + P;
  int* xn = st + 2 * P;    // this column before the fixup
  int* dn = st + 3 * P;
  for (int q = lane; q < P; q += 32) {
    xc[q] = x0[q];
    dc[q] = x0[q];
  }
  __syncwarp();
  for (int c = 0; c < C; ++c) {
    const int x_ai = xc[ai], d_ai = dc[ai];
    for (int q = lane; q < P; q += 32) {
      const int s = ln.own[q];
      int xv = 0, dv = 0;
      if (s >= 0) {
        const int tb = blk.tb[s], nd = blk.nd[s];
        const int x_tb = xc[tb], d_tb = dc[tb];
        const int l_x = x_tb + nd * x_ai + e;
        const int l_dpm = d_tb + nd * d_ai + o + e;
        const bool lsel = l_dpm >= l_x;
        const int l = lsel ? l_dpm : l_x;
        const int u = U[s * sstride + c], dcand = Dc[s * sstride + c];
        const int mx = max(max(dcand, u), l);
        const bool is_d = mx == dcand;
        const bool is_u = !is_d && mx == u;
        if (ln.hot[q]) {
          xv = l;
          dv = mx;
        } else {
          xv = lsel ? dc[q] - nd * d_tb : xc[q] - nd * x_tb;
          dv = is_d ? Dfd[q * qstride + c] : (is_u ? Ypre[q * qstride + c] : xv);
        }
      }
      xn[q] = xv;
      dn[q] = dv;
    }
    __syncwarp();
    // the multi-alpha fixup (gap.rs:521-537) on d and x
    const int d_ai2 = dn[ai], x_ai2 = xn[ai];
    int adj_d = 0, adj_x = 0;
    for (int s = 0; s < blk.MB; ++s) {
      adj_d += blk.isa[s] * (dn[blk.tb[s]] - d_ai2);
      adj_x += blk.isa[s] * (xn[blk.tb[s]] - x_ai2);
    }
    for (int q = lane; q < P; q += 32) {
      int fd, fx;
      if (ln.hotl[q]) {
        fd = 0;
        fx = 0;
        for (int s = 0; s < blk.MB; ++s) {
          if (blk.tb[s] != q) continue;
          fd += (dn[q] - d_ai2 - blk.after[s] * adj_d) * blk.fire[s];
          fx += (xn[q] - x_ai2 - blk.after[s] * adj_x) * blk.fire[s];
        }
      } else {
        fd = dn[q];
        fx = xn[q];
        const int s = ln.fix[q];
        if (s >= 0) {
          const int t = blk.tb[s];
          fd += (dn[t] - d_ai2 - blk.after[s] * adj_d) * blk.fire[s];
          fx += (xn[t] - x_ai2 - blk.after[s] * adj_x) * blk.fire[s];
        }
      }
      xc[q] = fx;
      dc[q] = fd;
      xs[q * ostride + c] = fx;
      ds[q * ostride + c] = fd;
    }
    __syncwarp();
  }
}

}  // namespace rgt
