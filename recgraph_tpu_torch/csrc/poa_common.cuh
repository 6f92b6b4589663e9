// Shared pieces of the fill kernels.
//
// K1-K6 and K13-K17 hold a read's columns in registers across one or a
// few warps (poa_global.cu: K1, K3, K14; poa_local.cu: K2, K13, K15,
// K16, K17; poa_gap_global.cu: K4, K6; poa_gap_local.cu: K5) and use the
// chain, key and staging helpers below.  The block-wide helpers
// (block_scan, left_neighbour, block_threads) serve the pathwise and
// modes-6/7 kernels (pathwise_common.cuh, gap67_fill.cu,
// gap67_hardrow.cu): thread t of a block owns columns t + k blockDim.x,
// and every thread takes part in every barrier.  Integer (max,+)
// arithmetic is exact, so every order of composition gives the value the
// reference engine keeps.
#pragma once

#include <cuda_runtime.h>

#include <climits>

namespace rgt {

constexpr int NEG = -(1 << 28);  // poa_engine.NEG
constexpr int GAP = 5;           // scoring.GAP
constexpr int NCODE = 7;         // scoring table is int32[7, 7]
// Threads a block at most of the block-wide kernels (K12's entry declares
// __launch_bounds__(MAX_THREADS, 1)).
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

__device__ __forceinline__ long long make_key(int value, unsigned tie) {
  return (long long)value * KEY_SHIFT + (long long)tie;
}

__device__ __forceinline__ int key_value(long long key) {
  return (int)(key >> 32);  // floor division: the tie word is in [0, 2^32)
}

__device__ __forceinline__ unsigned key_tie(long long key) {
  return (unsigned)(key & 0xffffffffLL);
}

// The clamped in-row chain of the affine fills (K4, K5).  With
// g = max(o + e, e), x[j+1] = max(x[j] + g, b[j]): the map of a column is
// x -> max(x + g, b), and a run of maps composes to x -> max(x + A, B).
// The reference's 2x2 map scan clamps every composed value to NEG; so do
// these.  A run of s columns has A = s g, clamped (to -NEG above as well,
// where the reference's own sums would leave int32).
__device__ __forceinline__ int chain_steps(int s, int g) {
  const long long v = (long long)s * g;
  return v < NEG ? NEG : v > -NEG ? -NEG : (int)v;
}

// The map (A, B) after the state (or the earlier run's B) x, clamped.
__device__ __forceinline__ int chain_apply(int x, int A, int B) {
  return max(max(x + A, B), NEG);
}

// A stored row's m at a lane's columns j0 - 1 .. j0 + CW - 1 and its y
// at j0 .. j0 + CW - 1 (0 outside the read's width).
template <int CW>
__device__ __forceinline__ void load_row(const int* mp, const int* yp, int j0, int Lp,
                                         int (&vm)[CW + 1], int (&vy)[CW]) {
  vm[0] = j0 > 0 && j0 <= Lp ? mp[j0 - 1] : 0;
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    const bool live = j0 + c < Lp;
    vm[c + 1] = live ? mp[j0 + c] : 0;
    vy[c] = live ? yp[j0 + c] : 0;
  }
}

// Copy a warp's staged segment (`len` columns of `np` <= NP planes, SEG
// apart in `st`) to the rows dst[0 .. np) (column 0 of the segment):
// each lane's shared loads first, then its stores, as 16-byte items
// where VEC.
template <int SEG, bool VEC, int NP>
__device__ __forceinline__ void warp_flush(const int* st, int len, int np,
                                           int* const (&dst)[NP], int lane) {
  constexpr int U = VEC ? (SEG / 4 + 31) / 32 : (SEG + 31) / 32;   // items a lane a plane
#pragma unroll
  for (int pl = 0; pl < NP; ++pl) {
    if (pl >= np) break;
    int* d = dst[pl];
    if constexpr (VEC) {
      int4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = lane + 32 * u;
        if (4 * k < len) v[u] = reinterpret_cast<const int4*>(st + pl * SEG)[k];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = lane + 32 * u;
        if (4 * k < len) reinterpret_cast<int4*>(d)[k] = v[u];
      }
    } else {
      int v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = lane + 32 * u;
        if (k < len) v[u] = st[pl * SEG + k];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = lane + 32 * u;
        if (k < len) d[k] = v[u];
      }
    }
  }
}

// int32 cells lo, hi as two int16 in one word (lo at the lower address):
// each keeps its low 16 bits, as a cast to int16 does.
__device__ __forceinline__ int pack_i16(int lo, int hi) {
  return (lo & 0xffff) | (int)((unsigned)hi << 16);
}

// Copy a warp's staged int32 segment (`len` columns at `st`) to the int16
// row `d` (column 0 of the segment), VW cells a store: 8 (16-byte stores;
// `d` 16-byte aligned, len a multiple of 8), 2 (4-byte; `d` 4-byte
// aligned, len even) or 1.  Each lane's shared loads first, then its
// stores.
template <int SEG, int VW>
__device__ __forceinline__ void warp_flush_i16(const int* st, int len, short* d, int lane) {
  constexpr int U = (SEG / VW + 31) / 32;   // items a lane
  if constexpr (VW == 8) {
    int4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = lane + 32 * u;
      if (8 * k < len) {
        const int4 lo = reinterpret_cast<const int4*>(st)[2 * k];
        const int4 hi = reinterpret_cast<const int4*>(st)[2 * k + 1];
        v[u] = make_int4(pack_i16(lo.x, lo.y), pack_i16(lo.z, lo.w), pack_i16(hi.x, hi.y),
                         pack_i16(hi.z, hi.w));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = lane + 32 * u;
      if (8 * k < len) reinterpret_cast<int4*>(d)[k] = v[u];
    }
  } else if constexpr (VW == 2) {
    int v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = lane + 32 * u;
      if (2 * k < len) {
        const int2 p = reinterpret_cast<const int2*>(st)[k];
        v[u] = pack_i16(p.x, p.y);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = lane + 32 * u;
      if (2 * k < len) reinterpret_cast<int*>(d)[k] = v[u];
    }
  } else {
    short v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = lane + 32 * u;
      if (k < len) v[u] = (short)st[k];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = lane + 32 * u;
      if (k < len) d[k] = v[u];
    }
  }
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
