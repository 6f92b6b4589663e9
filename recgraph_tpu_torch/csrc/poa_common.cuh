// Shared pieces of the POA fill kernels (poa_*.cu).
//
// Every kernel runs one thread block per read.  A row's columns are
// processed in tiles of blockDim.x: thread t owns the columns
// j = t + k * blockDim.x, k = 0, 1, ..., so a read of any length fits
// one block.  blockDim.x is the stored row width rounded up to a warp
// multiple, at most 1024.  Threads past the row's width ("dead" lanes)
// take part in every barrier, scan and reduction with neutral values
// and never touch memory.
//
// The in-row dependencies are inclusive block scans over an associative
// operator (warp shuffles, then one warp over the warp totals), run once
// per tile; the state at the last column of a tile is carried into the
// next tile.  Integer (max,+) arithmetic is exact, so every order of
// composition gives the value the reference engine keeps.
#pragma once

#include <cuda_runtime.h>

#include <climits>

namespace rgt {

constexpr int NEG = -(1 << 28);  // poa_engine.NEG
constexpr int GAP = 5;           // scoring.GAP
constexpr int NCODE = 7;         // scoring table is int32[7, 7]
// The kernels declare __launch_bounds__(MAX_THREADS, 1): up to 64
// registers a thread.  Without the minimum block count ptxas gave K2 and
// K3 32 registers and spilled.
constexpr int MAX_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long KEY_SHIFT = 4294967296LL;  // 2^32

// direction codes (poa_engine.O, D, LOW_D, L_DIR, U_DIR, X_DIR, Y_DIR,
// M_DIR, LOW_U)
enum : int {
  DIR_O = 0, DIR_D = 1, DIR_LOW_D = 2, DIR_L = 3, DIR_U = 4,
  DIR_X = 5, DIR_Y = 6, DIR_M = 7, DIR_LOW_U = 8,
};

// Threads per block for rows of `width` stored columns.
inline int block_threads(int width) {
  const int t = (width + 31) / 32 * 32;
  return t < MAX_THREADS ? t : MAX_THREADS;
}

// The linear-gap chain m[j] = max(A[j], m[j-1] + g[j]) as a scan over
// (g, A) pairs: (s1, v1) then (s2, v2) = (s1 + s2, max(v1 + s2, v2)).
struct Chain {
  int s, v;
};

__device__ __forceinline__ Chain chain_op(const Chain& a, const Chain& b) {
  return Chain{a.s + b.s, max(a.v + b.s, b.v)};
}

// The affine-gap row map v[j] = M[j] (x) v[j-1] (+) b[j] over the
// (m, x) state, in the (max,+) semiring, clamped to NEG as
// poa_gap_engine._mp_combine does (b after a).
struct Affine {
  int m00, m01, m10, m11, b0, b1;
};

__device__ __forceinline__ int mp2(int a, int b, int c, int d) {
  return max(max(a + b, c + d), NEG);
}

__device__ __forceinline__ Affine affine_op(const Affine& a, const Affine& b) {
  Affine r;
  r.m00 = mp2(b.m00, a.m00, b.m01, a.m10);
  r.m01 = mp2(b.m00, a.m01, b.m01, a.m11);
  r.m10 = mp2(b.m10, a.m00, b.m11, a.m10);
  r.m11 = mp2(b.m10, a.m01, b.m11, a.m11);
  r.b0 = max(mp2(b.m00, a.b0, b.m01, a.b1), b.b0);
  r.b1 = max(mp2(b.m10, a.b0, b.m11, a.b1), b.b1);
  return r;
}

// The state after applying map `a` to state (v0, v1), clamped.
__device__ __forceinline__ void affine_apply(const Affine& a, int& v0, int& v1) {
  const int n0 = max(mp2(a.m00, v0, a.m01, v1), a.b0);
  const int n1 = max(mp2(a.m10, v0, a.m11, v1), a.b1);
  v0 = n0;
  v1 = n1;
}

template <class T>
__device__ __forceinline__ T shfl_up_t(const T& x, int d) {
  constexpr int N = sizeof(T) / sizeof(int);
  T r;
  const int* px = reinterpret_cast<const int*>(&x);
  int* pr = reinterpret_cast<int*>(&r);
#pragma unroll
  for (int k = 0; k < N; ++k) pr[k] = __shfl_up_sync(FULL, px[k], d);
  return r;
}

// Inclusive scan over the block in thread order with `op` (earlier
// element first); `total` receives the last thread's value.  `warp` is
// a shared array of 32 elements.  Every thread must call it.
template <class T, class Op>
__device__ __forceinline__ T block_scan(T x, T* warp, T& total, Op op) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = shfl_up_t(x, d);
    if (lane >= d) x = op(y, x);
  }
  if (lane == 31) warp[wid] = x;
  __syncthreads();
  if (wid == 0) {
    T w = warp[lane < nw ? lane : nw - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = shfl_up_t(w, d);
      if (lane >= d) w = op(y, w);
    }
    warp[lane] = w;
  }
  __syncthreads();
  if (wid > 0) x = op(warp[wid - 1], x);
  total = warp[nw - 1];
  __syncthreads();
  return x;
}

// Block-wide maximum of a 64-bit key (value in the high word, a column
// tie-break in the low word); every thread gets the result.
__device__ __forceinline__ long long block_max_key(long long k, long long* s_key) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const long long y = __shfl_xor_sync(FULL, k, d);
    k = y > k ? y : k;
  }
  if (lane == 0) s_key[wid] = k;
  __syncthreads();
  long long r = s_key[0];
  for (int w = 1; w < nw; ++w) r = s_key[w] > r ? s_key[w] : r;
  __syncthreads();
  return r;
}

__device__ __forceinline__ long long make_key(int value, unsigned tie) {
  return (long long)value * KEY_SHIFT + (long long)tie;
}

__device__ __forceinline__ int key_value(long long key) {
  return (int)(key >> 32);  // floor division: the tie word is in [0, 2^32)
}

__device__ __forceinline__ unsigned key_tie(long long key) {
  return (unsigned)(key & 0xffffffffLL);
}

// Exchange one value with the left neighbour column across tiles:
// returns the value of column j - 1 (`carry` at the tile's first
// thread) and leaves in `carry` the tile's last value for the next tile.
// `s` is a shared array of blockDim.x ints.  Every thread must call it.
__device__ __forceinline__ int left_neighbour(int v, int& carry, int* s) {
  s[threadIdx.x] = v;
  __syncthreads();
  const int r = threadIdx.x > 0 ? s[threadIdx.x - 1] : carry;
  carry = s[blockDim.x - 1];
  __syncthreads();
  return r;
}

}  // namespace rgt
