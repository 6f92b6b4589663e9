// Mode-3 affine-gap local POA fill (gap_local_poa.rs:8-129) for Hopper (K5).
//
// Replaces the TPU kernel recgraph_tpu/ops/pallas_gap_local.py:271
// fill_gap_local_v2 and computes what poa_gap_engine._fill_gap_local
// (recgraph_tpu/ops/poa_gap_engine.py:550-686) computes, bit for bit,
// for every sign of the penalties o, e: the transposed scoring table
// (sm(seq[j], lnz[i])), the zero floor, start rows whose first-best
// sweeps begin at 0 / index 0 (ties => Y), non-start rows from row i-1
// (ties => M), the in-row (M, X) recurrence as a 2-state (max,+) affine
// scan clamped to NEG, tie order D >= U >= L with all-negative cells as
// O, three packed planes, and the row-major running best that moves on
// a strictly greater row maximum (first column).
//
// Design: one thread block per read, the row's columns in tiles of
// blockDim.x (poa_common.cuh), so a read of any length fits; the affine
// scan is a block scan over 2x2 (max,+) maps carried across tiles, and
// each row's best is a block max over (value, first column) keys.  The
// m and y rows of the predecessors live in device-memory scratch.
//
// What bounds it on this card: one block is latency-bound on its
// per-row barriers (scan, neighbour exchange, row best); throughput
// comes from many reads per SM.  It writes 12 bytes per cell of planes
// plus 8 of m/y scratch.  Later levers: a shared-memory ring of
// predecessor rows, fewer barriers per row, the linear X chain when
// o, e <= 0.
//
// The kernel allocates nothing, does not synchronise with the host and
// runs on the stream it is given.

#include "poa_common.cuh"

namespace rgt {

__global__ void __launch_bounds__(MAX_THREADS, 1)
poa_gap_local_kernel(const int* __restrict__ seq, const int* __restrict__ L_,
                     const int* __restrict__ table, const int* __restrict__ codes,
                     const int* __restrict__ node_start,
                     const int* __restrict__ pred_idx, int n, int Pm, int Lp, int o,
                     int e, int* __restrict__ m, int* __restrict__ y,
                     int* __restrict__ best_val, int* __restrict__ best_i,
                     int* __restrict__ best_j, int* __restrict__ packed,
                     int* __restrict__ packed_x, int* __restrict__ packed_y) {
  __shared__ int s_table[NCODE * NCODE];
  __shared__ int s_m[MAX_THREADS];
  __shared__ int s_x[MAX_THREADS];
  __shared__ Affine s_aff[32];
  __shared__ long long s_key[32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int ntiles = (Lp + blockDim.x - 1) / blockDim.x;
  const int oe = o + e;
  for (int t = tid; t < NCODE * NCODE; t += blockDim.x) s_table[t] = table[t];
  __syncthreads();

  const int L = L_[b];
  const int* sb = seq + (size_t)b * Lp;
  const size_t plane = (size_t)b * n * Lp;
  int* mb = m + plane;
  int* yb = y + plane;
  int* pb = packed + plane;
  int* pxb = packed_x + plane;
  int* pyb = packed_y + plane;
  int bv = 0, bi = 0, bjj = 0;  // running best (thread 0)

  // row 0 is all zero and all 'O'; row n-1 (the sink) is never filled
  for (int k = tid; k < 2 * Lp; k += blockDim.x) {
    const size_t at = k < Lp ? k : (size_t)(n - 1) * Lp + (k - Lp);
    mb[at] = yb[at] = pb[at] = pxb[at] = pyb[at] = 0;
  }
  __syncthreads();

  for (int i = 1; i < n - 1; ++i) {
    const int code = codes[i];
    const bool is_start = node_start[i] != 0;
    const int* pi = pred_idx + (size_t)i * Pm;

    int c_m = NEG, c_x = NEG;      // scan state carried across tiles
    int nb_m = NEG, nb_x = NEG;    // left neighbours carried across tiles
    long long best = LLONG_MIN;
    for (int t = 0; t < ntiles; ++t) {
      const int j = tid + t * blockDim.x;
      const bool live = j < Lp;
      const bool valid = live && j < L;
      const bool border = j == 0 || !valid;
      const int sj = live ? sb[j] : GAP;
      const int sub = s_table[sj * NCODE + code];  // transposed: sm(seq[j], lnz[i])

      int d_val = NEG, yrow = NEG, d_idx = i - 1, u_idx = i - 1;
      bool py_is_y = false;
      if (live && is_start) {
        // first best over the predecessor slots in order; padding slots
        // count as NEG at index 0, as the reference engine's argmax sees them
        int d_pre = NEG, d_arg = 0, um = NEG, um_arg = 0, uy = NEG, uy_arg = 0;
        for (int q = 0; q < Pm; ++q) {
          const int p = pi[q];
          const int ps = p < 0 ? 0 : p;
          const size_t row_p = (size_t)ps * Lp;
          const int vd = (p >= 0 && j > 0) ? mb[row_p + j - 1] : NEG;
          const int vm = p >= 0 ? mb[row_p + j] : NEG;
          const int vy = p >= 0 ? yb[row_p + j] : NEG;
          if (q == 0 || vd > d_pre) { d_pre = vd; d_arg = ps; }
          if (q == 0 || vm > um) { um = vm; um_arg = ps; }
          if (q == 0 || vy > uy) { uy = vy; uy_arg = ps; }
        }
        const int um_pre = um + o;
        d_val = max(d_pre, 0) + sub;
        d_idx = d_pre > 0 ? d_arg : 0;
        const int um_s = max(um_pre, 0), uy_s = max(uy, 0);
        const bool from_m = um_s > uy_s;  // ties => Y (":166-171")
        yrow = max(um_s, uy_s) + e;
        u_idx = from_m ? (um_pre > 0 ? um_arg : 0) : (uy > 0 ? uy_arg : 0);
        py_is_y = !from_m;
      } else if (live) {
        // non-start rows (":56-73"): plain i-1; ties => M
        const size_t up = (size_t)(i - 1) * Lp;
        const int mu = mb[up + j], yu = yb[up + j];
        d_val = (j > 0 ? mb[up + j - 1] : NEG) + sub;
        py_is_y = yu > mu + o;  // strict => Y
        yrow = max(mu + o, yu) + e;
      }
      const int c = max(max(d_val, yrow), 0);

      // the in-row (M, X) affine scan; the band is the whole valid read
      Affine el;
      if (!valid) {
        el = Affine{0, NEG, NEG, 0, NEG, NEG};
      } else if (j == 0) {
        el = Affine{NEG, NEG, NEG, NEG, 0, 0};
      } else {
        el = Affine{oe, e, oe, e, c, NEG};
      }
      Affine tot;
      const Affine pre = block_scan(el, s_aff, tot, affine_op);
      int vm = pre.b0, vx = pre.b1;
      if (t > 0) {
        vm = c_m;
        vx = c_x;
        affine_apply(pre, vm, vx);
        affine_apply(tot, c_m, c_x);
      } else {
        c_m = tot.b0;
        c_x = tot.b1;
      }
      const int mrow = border ? 0 : vm;
      const int xrow = border ? 0 : vx;
      yrow = border ? 0 : yrow;

      // path_x (":40-54"): X iff x[j-1] > m[j-1] + o (ties => M)
      const int m_prev = left_neighbour(mrow, nb_m, s_m);
      const int x_prev = left_neighbour(xrow, nb_x, s_x);
      if (live) {
        int cell = 0, cell_x = 0, cell_y = 0;
        if (!border) {
          cell_x = i * 16 + (x_prev > m_prev + o ? DIR_X : DIR_M);
          cell_y = u_idx * 16 + (py_is_y ? DIR_Y : DIR_M);
          // M directions with zero floor (":96-110"); D >= U >= L
          if (!(d_val < 0 && yrow < 0 && xrow < 0)) {
            const bool d_ge_u = d_val >= yrow;
            if (d_ge_u && d_val >= xrow) {
              cell = d_idx * 16 + (sj == code ? DIR_D : DIR_LOW_D);
            } else if (!d_ge_u && yrow >= xrow) {
              cell = u_idx * 16 + DIR_U;
            } else {
              cell = i * 16 + DIR_L;
            }
          }
        }
        const size_t at = (size_t)i * Lp + j;
        mb[at] = mrow;
        yb[at] = yrow;
        pb[at] = cell;
        pxb[at] = cell_x;
        pyb[at] = cell_y;
        const long long key = make_key(valid ? mrow : NEG, 0x7fffffffu - (unsigned)j);
        best = key > best ? key : best;
      }
    }

    // row maximum, first column; the barriers inside also publish this
    // row's scratch before the next row
    best = block_max_key(best, s_key);
    if (tid == 0) {
      const int rmax = key_value(best);
      if (rmax > bv) {
        bv = rmax;
        bi = i;
        bjj = (int)(0x7fffffffu - key_tie(best));
      }
    }
  }

  if (tid == 0) {
    best_val[b] = bv;
    best_i[b] = bi;
    best_j[b] = bjj;
  }
}

}  // namespace rgt

extern "C" int rgt_poa_gap_local_fill(
    const int* seq, const int* L, const int* table, const int* codes,
    const int* node_start, const int* pred_idx, int B, int n, int Pm, int Lp,
    int o, int e, int* m, int* y, int* best_val, int* best_i, int* best_j,
    int* packed, int* packed_x, int* packed_y, void* stream) {
  if (B < 1 || n < 3 || Pm < 1 || Lp < 1) return (int)cudaErrorInvalidValue;
  rgt::poa_gap_local_kernel<<<B, rgt::block_threads(Lp), 0, (cudaStream_t)stream>>>(
      seq, L, table, codes, node_start, pred_idx, n, Pm, Lp, o, e, m, y, best_val,
      best_i, best_j, packed, packed_x, packed_y);
  return (int)cudaGetLastError();
}
