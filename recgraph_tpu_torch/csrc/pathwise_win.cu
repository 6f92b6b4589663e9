// Mode-4 windowed long-read pathwise fill for Hopper.
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
// Design (pathwise_common.cuh): one thread block per read, a row's W
// lanes in tiles of blockDim.x.  Per row: a block min/max over the
// on-lanes' predecessor best positions places the window; one block
// scan gives the window-local gap sums Gw; each group's rep chain is two
// block scans over the realigned predecessor window (NEG outside it);
// then every (path, lane) cell replays its group's moves independently,
// with the replayed value clamped to V - Gw >= -2^16 as the XLA engine's
// packed chain clamps it, and the replay restarting at the window's first
// lane.  The row's rightmost best lane is a block max over (value, lane)
// keys.  Predecessor rows, window starts and best positions live in
// device memory (the row history; unbounded predecessor spans).
//
// What bounds it on this card: the bytes of Aw it writes plus the two
// predecessor cells each cell reads; one block is latency-bound on its
// per-row barriers.
//
// The kernel allocates nothing, does not synchronise with the host and
// runs on the stream it is given.

#include "pathwise_common.cuh"

namespace rgt {

constexpr int WIN_OFF = 1 << 16;   // pathwise_window.OFF
constexpr int FAR = 1 << 28;       // the min over no on-lane

__global__ void __launch_bounds__(MAX_THREADS, 1)
pathwise_win_kernel(const int* __restrict__ seq, const int* __restrict__ L_,
                    const int* __restrict__ table, const int* __restrict__ codes,
                    const int* __restrict__ grep, const int* __restrict__ gpred,
                    const int* __restrict__ pslot, const int* __restrict__ rmin,
                    int n, int P, int Lp, int Gd, int W, int* gw_s, int* kidx_s,
                    int* flag_s, int* rowv_s, int* bsp_s, int* Aw, int* wss,
                    int* bound) {
  __shared__ int s_table[NCODE * NCODE];
  __shared__ int s_warp[32];
  __shared__ long long s_key[32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int ntiles = (W + T - 1) / T;
  for (int t = tid; t < NCODE * NCODE; t += T) s_table[t] = table[t];
  __syncthreads();
  int smax = 0;
  for (int t = 0; t < NCODE * NCODE; ++t) smax = max(smax, s_table[t]);

  const int L = L_[b];
  const int* sb = seq + (size_t)b * Lp;
  int* gw = gw_s + (size_t)b * W;
  int* kidx = kidx_s + (size_t)b * Gd * W;
  int* flag = flag_s + (size_t)b * Gd * W;
  int* rowv = rowv_s + (size_t)b * W;
  int* bsp = bsp_s + (size_t)b * n;
  int* ws_b = wss + (size_t)b * n;
  const size_t plane = (size_t)n * W;    // one path's [n, W] plane
  int* Ab = Aw + (size_t)b * P * plane;

  // row 0: window at 0, G0 = cumsum(sm(seq[j], '-')) over the first W
  // columns, every path at G0 - G0[0]; row n-1 stays 0
  int carry = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int k = t * T + tid;
    const int g = k < W ? s_table[sb[k] * NCODE + GAP] : 0;
    const int v = tile_prefix_sum(g, s_warp, carry);
    if (k < W) gw[k] = v;
  }
  __syncthreads();
  const int g0 = gw[0];
  for (int q = 0; q < P; ++q) {
    int* r0 = Ab + (size_t)q * plane;
    int* rl = r0 + (size_t)(n - 1) * W;
    for (int k = tid; k < W; k += T) {
      r0[k] = gw[k] - g0;
      rl[k] = 0;
    }
  }
  // row 0's right-edge cell can L-exit right
  int R = NEG;
  if (tid == 0) {
    if (W - 1 < L) R = gw[W - 1] - g0 - smax * (W - 1);
    ws_b[0] = bsp[0] = ws_b[n - 1] = bsp[n - 1] = 0;
  }
  __syncthreads();

  for (int i = 1; i < n - 1; ++i) {
    const int code = codes[i];
    const int gap_i = s_table[code * NCODE + GAP];
    const int* sub_row = s_table + code * NCODE;
    const int* gr = grep + (size_t)i * Gd;
    const int* gp = gpred + (size_t)i * Gd;
    const int* ps = pslot + (size_t)i * P;

    // the window: centred on the on-lanes' predecessor best positions,
    // covering column L - rmin[i] with W/8 to spare on the right
    int lmin = FAR, lmax = 0;
    for (int q = tid; q < P; q += T) {
      const int g = ps[q];
      if (g >= 0) {
        const int v = bsp[gp[g]];
        lmin = min(lmin, v);
        lmax = max(lmax, v);
      }
    }
    const int ms = -block_max_int(-lmin, s_warp);
    const int me = block_max_int(lmax, s_warp);
    const int center = (ms + me) / 2 + 1;
    const int right_target = max(me + 2, L - rmin[i] + 2) + W / 8;
    const int ws = max(max(center - W / 2, right_target - W), 0) / 8 * 8;

    // window-local gap sums Gw
    carry = 0;
    for (int t = 0; t < ntiles; ++t) {
      const int k = t * T + tid;
      const int g = k < W ? s_table[sb[min(ws + k, Lp - 1)] * NCODE + GAP] : 0;
      const int v = tile_prefix_sum(g, s_warp, carry);
      if (k < W) {
        gw[k] = v;
        rowv[k] = NEG;
      }
    }
    __syncthreads();

    // 1. each group's rep chain over its realigned predecessor window
    for (int g = 0; g < Gd; ++g) {
      const int r = gr[g];
      if (r < 0) break;                      // the same for every thread
      const int p = gp[g];
      const int shift = ws - ws_b[p];
      const int* Ar = Ab + (size_t)r * plane + (size_t)p * W;
      int* kg = kidx + (size_t)g * W;
      int* fg = flag + (size_t)g * W;
      int ccarry = INT_MIN, kcarry = -1;
      for (int t = 0; t < ntiles; ++t) {
        const int k = t * T + tid;
        const bool live = k < W;
        int d_r = 0, u_r = 0, Gk = 0, x = INT_MIN;
        bool at0 = false;
        if (live) {
          const int idx = shift + k;
          const int ar_al = (idx >= 0 && idx < W) ? Ar[idx] : NEG;
          const int ar_sh = (idx >= 1 && idx <= W) ? Ar[idx - 1] : NEG;
          at0 = ws + k == 0;
          d_r = ar_sh + sub_row[sb[min(ws + k, Lp - 1)]];
          u_r = ar_al + gap_i;
          const int ach = at0 ? ar_al + gap_i : max(d_r, u_r);
          Gk = gw[k];
          x = ach - Gk;
        }
        const int rep_row = Gk + tile_prefix_max(x, s_warp, ccarry);
        const bool dD = live && rep_row == d_r;
        const bool dU = live && !dD && rep_row == u_r;
        const bool nonL = dD || dU || at0 || k == 0;
        const int kl = tile_prefix_max(live && nonL ? k : -1, s_warp, kcarry);
        if (live) {
          kg[k] = kl;
          fg[k] = dD;
        }
      }
    }
    __syncthreads();

    // 2. every lane of the row: replay its group's moves; the stranded
    // predecessor cells of its lane feed the exit bound
    for (int q = 0; q < P; ++q) {
      const int g = ps[q];
      int* out = Ab + (size_t)q * plane + (size_t)i * W;
      if (g < 0) {
        for (int k = tid; k < W; k += T) out[k] = ws + k < L ? 0 : NEG;
        continue;
      }
      const int p = gp[g];
      const int wsp = ws_b[p];
      const int shift = ws - wsp;
      const int* Aq = Ab + (size_t)q * plane + (size_t)p * W;
      const int* kg = kidx + (size_t)g * W;
      const int* fg = flag + (size_t)g * W;
      for (int k = tid; k < W; k += T) {
        const int kk = kg[k];
        const int idx = shift + kk;
        int v;
        if (ws + kk != 0 && fg[kk]) {
          v = ((idx >= 1 && idx <= W) ? Aq[idx - 1] : NEG) +
              sub_row[sb[min(ws + kk, Lp - 1)]];
        } else {
          v = ((idx >= 0 && idx < W) ? Aq[idx] : NEG) + gap_i;
        }
        const int row = gw[k] + max(v - gw[kk], -WIN_OFF);
        const bool in_read = ws + k < L;
        out[k] = in_read ? row : NEG;
        if (in_read) rowv[k] = max(rowv[k], row);
        const int jp = wsp + k;
        if ((jp < ws || jp >= ws + W - 1) && jp < L) R = max(R, Aq[k] - smax * jp);
      }
    }

    // best-scoring position: the rightmost lane of the row's best
    // on-lane value; the right-edge lane can exit right by an L move
    long long key = LLONG_MIN;
    for (int k = tid; k < W; k += T) {
      const long long kv = make_key(rowv[k], (unsigned)k);
      key = kv > key ? kv : key;
      if (k == W - 1 && ws + k < L) R = max(R, rowv[k] - smax * (ws + k));
    }
    key = block_max_key(key, s_key);
    if (tid == 0) {
      ws_b[i] = ws;
      bsp[i] = ws + (int)key_tie(key);
    }
    // publishes row i, ws and bsp before row i + 1
    __syncthreads();
  }

  R = block_max_int(R, s_warp);
  if (tid == 0) bound[b] = R + smax * (L - 1);
}

}  // namespace rgt

extern "C" int rgt_pathwise_win_fill(
    const int* seq, const int* L, const int* table, const int* codes, const int* grep,
    const int* gpred, const int* pslot, const int* rmin, int B, int n, int P, int Lp,
    int Gd, int W, int* gw, int* kidx, int* flag, int* rowv, int* bsp, int* Aw, int* ws,
    int* bound, void* stream) {
  if (B < 1 || n < 3 || P < 1 || Gd < 1 || W < 8 || W > Lp) return (int)cudaErrorInvalidValue;
  rgt::pathwise_win_kernel<<<B, rgt::block_threads(W), 0, (cudaStream_t)stream>>>(
      seq, L, table, codes, grep, gpred, pslot, rmin, n, P, Lp, Gd, W, gw, kidx, flag,
      rowv, bsp, Aw, ws, bound);
  return (int)cudaGetLastError();
}
