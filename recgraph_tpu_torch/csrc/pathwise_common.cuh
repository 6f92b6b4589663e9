// Shared pieces of the pathwise fill kernels (pathwise*.cu), on top of
// poa_common.cuh's block scans.
//
// Both kernels run one thread block per read and keep the whole score
// tensor A[B, P, n, W] in device memory: pathwise predecessor spans are
// unbounded (a haplotype path may skip any number of nodes), so A is the
// row history, as the TPU kernels' result buffer in HBM is
// (pallas_pathwise.py:20-25).  One read stays inside one block, and a
// __syncthreads() between rows publishes row i before row i + 1 reads it.
//
// Per row, each group of the row (the distinct (rep, pred) pairs of its
// on-path lanes, encode.group_table) is solved once: the rep's (max,+)
// chain gives its D/U/L moves, kept as a flag per column, and the last
// non-L column at or before each column.  Every lane of the group then
// replays those moves from its own plane with no scan at all:
//
//     row_q[j] = V_q[k] + G[j] - G[k],  k = the last non-L column <= j,
//
// with V_q[k] the D or U candidate of lane q at column k.  That is the
// exact replay of the XLA engine (``encode_chain=False``); the TPU's
// packed (column << 17 | value) chain is not ported.
#pragma once

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

}  // namespace rgt
