// Column summaries of the modes-8/9 split search (best_alignment,
// pathwise_alignment_recombination.rs:759-873) for Hopper.
//
// No TPU kernel: the JAX package computes this function in XLA,
// recgraph_tpu/ops/recombination_engine.py:478 _col_summary_fn; it is
// the port's own kernel (S1).  For one (read b, column j) pair it
// reduces the I x I candidate plane over the interior rows,
//
//     cand[i, k] = (f32(fmax[b, i, j]) + f32(rmax[b, k, j]))
//                  - (R + r * (|dfs_i - dfs_k| + |dfe_i - dfe_k|)),
//
// valid where the node ids differ, vf[b, i, j] and vr[b, k, j] hold and
// farg[b, i, j] != rarg[b, k, j], to what the take/tie chain reads:
// col_max, the smallest flat index i * I + k at the max, whether an
// onedge pair (fwe[i] and rve[k]) is at the max, and the smallest such
// flat index.  A column with no valid pair has col_max NEGF, flat_plain
// 0 and the edge flags of the whole plane (`edge0`, from the wrapper).
// Every f32 operation rounds as the XLA expression does: __fmul_rn and
// __fadd_rn keep nvcc from contracting r * d + R into an FMA, which
// would round differently (the GAF prints the f32 score to 17 digits).
//
// Design: one block per pair; the interior rows are tiles of S1_TILE,
// staged in shared memory with the pair's column of the six summaries
// (validity folded into the path index, -1 when not on the path) and
// the geometry; every thread keeps its own (max, first flat, first
// onedge flat) and one block reduction combines them.  The candidate
// plane never touches device memory.  What bounds it on this card: the
// f32/int32 operations of the I^2 candidates (about 10 a pair); rows
// whose forward summary is invalid are skipped whole.
//
// The kernel allocates nothing, does not synchronise with the host and
// runs on the stream it is given.

#include <cuda_runtime.h>

#include <climits>

namespace rgt {

constexpr int S1_THREADS = 256;
constexpr int S1_TILE = 1024;
constexpr float NEGF = -3.0e38f;   // recombination_engine.NEGF
constexpr int BIG = 1 << 30;

struct Best {
  float v;
  int flat, edge;   // smallest flat index at v; smallest onedge one (BIG: none)
};

__device__ __forceinline__ Best best_of(const Best& a, const Best& b) {
  if (a.v > b.v) return a;
  if (b.v > a.v) return b;
  return Best{a.v, min(a.flat, b.flat), min(a.edge, b.edge)};
}

__global__ void __launch_bounds__(S1_THREADS)
split_summary_kernel(const int* __restrict__ fmax, const int* __restrict__ farg,
                     const unsigned char* __restrict__ vf, const int* __restrict__ rmax,
                     const int* __restrict__ rarg, const unsigned char* __restrict__ vr,
                     const float* __restrict__ dfs, const float* __restrict__ dfe,
                     const int* __restrict__ ids, const unsigned char* __restrict__ fwe,
                     const unsigned char* __restrict__ rve, float R, float r,
                     const int* __restrict__ bidx, const int* __restrict__ cols, int I, int Lp,
                     int edge0, float* col_max, int* edge_any, int* flat_edge,
                     int* flat_plain) {
  __shared__ float si_v[S1_TILE], si_s[S1_TILE], si_e[S1_TILE];
  __shared__ int si_a[S1_TILE], si_id[S1_TILE];
  __shared__ float sk_v[S1_TILE], sk_s[S1_TILE], sk_e[S1_TILE];
  __shared__ int sk_a[S1_TILE], sk_id[S1_TILE];
  __shared__ Best s_warp[S1_THREADS / 32];

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = (size_t)bidx[p] * I * Lp + cols[p];   // (b, i, j) at base + i * Lp
  Best me{NEGF, BIG, BIG};

  for (int i0 = 0; i0 < I; i0 += S1_TILE) {
    const int ni = min(S1_TILE, I - i0);
    __syncthreads();   // the previous tiles are read
    for (int t = tid; t < ni; t += S1_THREADS) {
      const int i = i0 + t;
      const size_t c = base + (size_t)i * Lp;
      si_v[t] = (float)fmax[c];
      si_a[t] = vf[c] ? farg[c] : -1;
      si_s[t] = dfs[i];
      si_e[t] = dfe[i];
      si_id[t] = (ids[i] << 1) | (fwe[i] ? 1 : 0);
    }
    for (int k0 = 0; k0 < I; k0 += S1_TILE) {
      const int nk = min(S1_TILE, I - k0);
      if (k0 > 0) __syncthreads();
      for (int t = tid; t < nk; t += S1_THREADS) {
        const int k = k0 + t;
        const size_t c = base + (size_t)k * Lp;
        sk_v[t] = (float)rmax[c];
        sk_a[t] = vr[c] ? rarg[c] : -1;
        sk_s[t] = dfs[k];
        sk_e[t] = dfe[k];
        sk_id[t] = (ids[k] << 1) | (rve[k] ? 1 : 0);
      }
      __syncthreads();
      for (int ii = 0; ii < ni; ++ii) {
        const int fa = si_a[ii];
        if (fa < 0) continue;                 // the same for every thread
        const float fv = si_v[ii], ds = si_s[ii], de = si_e[ii];
        const int fid = si_id[ii];
        const int row = (i0 + ii) * I + k0;
        for (int kk = tid; kk < nk; kk += S1_THREADS) {
          const int ra = sk_a[kk];
          const int kid = sk_id[kk];
          if (ra < 0 || ra == fa || (kid >> 1) == (fid >> 1)) continue;
          const float disp = __fadd_rn(fabsf(__fsub_rn(ds, sk_s[kk])),
                                       fabsf(__fsub_rn(de, sk_e[kk])));
          const float pen = __fadd_rn(R, __fmul_rn(r, disp));
          const float c = __fsub_rn(__fadd_rn(fv, sk_v[kk]), pen);
          const int f = row + kk;
          const bool e = fid & kid & 1;
          if (c > me.v) {
            me = Best{c, f, e ? f : BIG};
          } else if (c == me.v) {
            me.flat = min(me.flat, f);
            if (e) me.edge = min(me.edge, f);
          }
        }
      }
    }
  }

  // block reduction of (max, first flat, first onedge flat)
  const int lane = tid & 31, wid = tid >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    Best o;
    o.v = __shfl_xor_sync(0xffffffffu, me.v, d);
    o.flat = __shfl_xor_sync(0xffffffffu, me.flat, d);
    o.edge = __shfl_xor_sync(0xffffffffu, me.edge, d);
    me = best_of(me, o);
  }
  if (lane == 0) s_warp[wid] = me;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < S1_THREADS / 32; ++w) me = best_of(me, s_warp[w]);
    if (me.v == NEGF) {   // no valid pair: every pair ties at NEGF
      col_max[p] = NEGF;
      flat_plain[p] = 0;
      edge_any[p] = edge0 >= 0;
      flat_edge[p] = edge0 >= 0 ? edge0 : 0;
    } else {
      col_max[p] = me.v;
      flat_plain[p] = me.flat;
      edge_any[p] = me.edge != BIG;
      flat_edge[p] = me.edge != BIG ? me.edge : 0;
    }
  }
}

}  // namespace rgt

extern "C" int rgt_split_summary(
    const int* fmax, const int* farg, const unsigned char* vf, const int* rmax,
    const int* rarg, const unsigned char* vr, const float* dfs, const float* dfe,
    const int* ids, const unsigned char* fwe, const unsigned char* rve, float R, float r,
    const int* bidx, const int* cols, int K, int I, int Lp, int edge0, float* col_max,
    int* edge_any, int* flat_edge, int* flat_plain, void* stream) {
  if (K < 1 || I < 1 || Lp < 1 || I > 46340) return (int)cudaErrorInvalidValue;
  rgt::split_summary_kernel<<<K, rgt::S1_THREADS, 0, (cudaStream_t)stream>>>(
      fmax, farg, vf, rmax, rarg, vr, dfs, dfe, ids, fwe, rve, R, r, bidx, cols, I, Lp, edge0,
      col_max, edge_any, flat_edge, flat_plain);
  return (int)cudaGetLastError();
}
