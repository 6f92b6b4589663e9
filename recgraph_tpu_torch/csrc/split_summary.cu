// The modes-8/9 split search (best_alignment,
// pathwise_alignment_recombination.rs:759-873) for Hopper: kernel S1.
//
// No TPU kernel: the JAX package computes this function in XLA
// (recgraph_tpu/ops/recombination_engine.py:478 _col_summary_fn) and
// drives it from the host in rounds (:597 _run_split_guided).  S1 is the
// port's own kernel, with two entries.
//
// The column summary.  For one (read b, column j) pair it reduces the
// I x I candidate plane over the interior rows,
//
//     cand[i, k] = (f32(fmax[b, i, j]) + f32(rmax[b, k, j]))
//                  - (R + r * (|dfs_i - dfs_k| + |dfe_i - dfe_k|)),
//
// valid where the node ids differ, vf[b, i, j] and vr[b, k, j] hold and
// farg[b, i, j] != rarg[b, k, j], to what the take/tie chain reads:
// col_max, the smallest flat index i * I + k at the max, whether an
// onedge pair (fwe[i] and rve[k]) is at the max, and the smallest such
// flat index.  The kernel orders pairs by the key (i << 32) | k, which
// orders them as the flat index does (k < I), in 64 bits, so any I
// works; the per-pair entry writes the flat index as int64.  A column with no valid pair has col_max NEGF, flat_plain
// 0 and the edge flags of the whole plane (`edge0`, from the wrapper).
// Every f32 operation rounds as the XLA expression does: __fmul_rn and
// __fadd_rn keep nvcc from contracting r * d + R into an FMA, which
// would round differently (the GAF prints the f32 score to 17 digits).
//
// `rgt_split_bound` computes the column bound ub of the search (the
// bound entry, below); `rgt_split_summary` evaluates one pair per block
// (the per-pair entry); `rgt_split_guided` runs a chunk's whole
// bound-guided search in one launch (the guided entry), as
// `_run_split_guided` does in host rounds:
// each read's columns in falling upper bound ub (the wrapper's sort),
// claimed one at a time by the read's blocks through a cursor; a column
// is evaluated while ub + 0.5 >= max(M_b, init_best_b), M_b the read's
// largest col_max so far (an atomicMax on an order-preserving int key),
// and the first column that fails ends the read's search (the rest have
// no larger ub, and the threshold only grows).  The last of the read's
// blocks to finish replays the take/tie chain over the read's evaluated
// columns in ascending order and gathers the split's paths.  Which
// columns are evaluated depends on timing; the seven outputs do not (the
// argument is in recombination_engine._run_split_guided).
//
// What bounds it on this card: the f32/int32 operations of the valid
// candidates (about 10 a candidate), and on short reads the gather of a
// column, whose elements lie Lp apart (each a sector of its own).
// Design: a block first compacts each side's valid rows at column j into
// shared memory (a ballot and a prefix over the warps, two rows a thread
// a window, in row order, the row index kept for the flat index), so
// that invalid rows cost neither staging nor a loop trip; the reverse
// side whole while it fits (`capr`), the forward side in tiles (`capf`).
// Each warp then holds S1_FR forward rows in registers and its lanes
// walk consecutive reverse rows, every reverse row read once for S1_FR
// candidates; a thread keeps its own (max, first flat, first onedge
// flat), updated only where the warp's running max is reached (a
// warp-wide, rarely taken branch), and one block reduction combines
// them.  The guided entry gives each read C blocks (the wrapper fills
// the card several times over, from the occupancy API), so a chunk of
// few reads still occupies every SM and a read's next columns are
// evaluated at once; no host round separates the columns.  The
// candidate plane never touches device memory.
//
// The kernels allocate nothing, do not synchronise with the host and run
// on the stream they are given.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace rgt {

constexpr int S1_THREADS = 256;
constexpr int S1_WARPS = S1_THREADS / 32;
constexpr int S1_WINDOW = 2 * S1_THREADS;   // rows a block stages at once, two a thread
constexpr int S1_FR = 8;           // forward rows a warp holds in registers
constexpr float NEGF = -3.0e38f;   // recombination_engine.NEGF
constexpr long long BIG = LLONG_MAX;   // above every pair key (i << 32) | k
constexpr int ROW_BYTES = 24;      // one compacted row in shared memory
constexpr size_t SMEM_MAX = 226 * 1024;   // dynamic shared memory a block may take

struct Best {
  float v;
  long long flat, edge;   // smallest pair key at v; smallest onedge one (BIG: none)
};

// The pair key of rows (i, k) and the flat index i * I + k of a key.
__device__ __forceinline__ long long pair_key(int i, int k) {
  return (long long)i << 32 | (long long)k;
}

__device__ __forceinline__ long long key_flat(long long key, int I) {
  return (key >> 32) * (long long)I + (key & 0xffffffffLL);
}

__device__ __forceinline__ Best best_of(const Best& a, const Best& b) {
  if (a.v > b.v) return a;
  if (b.v > a.v) return b;
  return Best{a.v, min(a.flat, b.flat), min(a.edge, b.edge)};
}

// The order-preserving int key of an f32 (signed compare): non-negative
// floats keep their bits, negative ones flip all but the sign.  Its own
// inverse.  cuda_split_summary.f32_key is the same map.
__device__ __forceinline__ int f32_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}

__device__ __forceinline__ float key_f32(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

// The six summaries [B, I, Lp] and the geometry over the interior rows.
struct SplitIn {
  const int *fmax, *farg;
  const unsigned char* vf;
  const int *rmax, *rarg;
  const unsigned char* vr;
  const float *dfs, *dfe;
  const int* ids;
  const unsigned char *fwe, *rve;
  float R, r;
  int I, Lp;
  long long edge0;   // the pair key of the first onedge pair, -1: none
};

// One side's compacted rows in shared memory: (summary as f32, dfs, dfe,
// path bits) as one float4, the node id, and the row index with the
// onedge flag in bit 31.
struct Rows {
  float4* q;
  int* id;
  int* info;
};

__device__ __forceinline__ Rows carve(unsigned char* p, int cap) {
  Rows t;
  t.q = reinterpret_cast<float4*>(p);
  t.id = reinterpret_cast<int*>(p) + 4 * cap;
  t.info = reinterpret_cast<int*>(p) + 5 * cap;
  return t;
}

// Append the valid rows of windows [raw, raw + S1_WINDOW) of one side at
// the pair's column (element `base + i * Lp`) to `t`, in row order, while
// a whole window still fits in `cap`; each thread reads two rows of a
// window at once.  Returns the rows appended; `raw` advances past the
// windows read.  Ends with a barrier.
__device__ int fill_rows(const SplitIn& in, const int* mx, const int* arg,
                         const unsigned char* valid, const unsigned char* edge, size_t base,
                         int& raw, int cap, Rows t, int* s_cnt) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  int count = 0;
  while (raw < in.I && count + min(S1_WINDOW, in.I - raw) <= cap) {
    bool ok[2];
    unsigned m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = raw + h * S1_THREADS + tid;
      ok[h] = i < in.I && valid[base + (size_t)i * in.Lp] != 0;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = __ballot_sync(0xffffffffu, ok[h]);
      if (lane == 0) s_cnt[h * S1_WARPS + wid] = __popc(m[h]);
    }
    __syncthreads();
    int off[2] = {count, count}, total = 0;
#pragma unroll
    for (int w = 0; w < S1_WARPS; ++w) {
      const int c0 = s_cnt[w], c1 = s_cnt[S1_WARPS + w];
      off[0] += w < wid ? c0 : 0;
      off[1] += w < wid ? c1 : 0;
      total += c0;
    }
    off[1] += total;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (ok[h]) {
        const int i = raw + h * S1_THREADS + tid;
        const size_t c = base + (size_t)i * in.Lp;
        const int p = off[h] + __popc(m[h] & ((1u << lane) - 1u));
        t.q[p] = make_float4((float)mx[c], in.dfs[i], in.dfe[i], __int_as_float(arg[c]));
        t.id[p] = in.ids[i];
        t.info[p] = i | (edge[i] ? INT_MIN : 0);
      }
    }
#pragma unroll
    for (int w = 0; w < S1_WARPS; ++w) total += s_cnt[S1_WARPS + w];
    count += total;
    raw += S1_WINDOW;
    __syncthreads();   // s_cnt is rewritten by the next window
  }
  return count;
}

// The candidates of nf forward by nr reverse compacted rows into `me`:
// each warp S1_FR forward rows at a time in registers, its lanes on
// consecutive reverse rows.  The fast path keeps only each lane's
// largest valid candidate of a reverse row; a warp max of those
// (__reduce_max_sync on the int key) against the warp's running max
// `tkey` decides, for the whole warp at once, whether any lane takes
// the exact update, candidate by candidate in row order.  A candidate
// below `tkey` is below a candidate the warp has seen, so it is not the
// pair's max and cannot change the summary.
__device__ __forceinline__ void pair_rows(const SplitIn& in, const Rows& F, int nf,
                                          const Rows& Rv, int nr, Best& me, int& tkey) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int g = wid * S1_FR; g < nf; g += S1_WARPS * S1_FR) {
    float fv[S1_FR], fs[S1_FR], fe[S1_FR];
    int fa[S1_FR], fid[S1_FR];
#pragma unroll
    for (int q = 0; q < S1_FR; ++q) {
      const bool on = g + q < nf;   // padding rows: -inf never reaches NEGF
      const float4 x = on ? F.q[g + q] : make_float4(-INFINITY, 0.f, 0.f, __int_as_float(-1));
      fv[q] = x.x;
      fs[q] = x.y;
      fe[q] = x.z;
      fa[q] = __float_as_int(x.w);
      fid[q] = on ? F.id[g + q] : -1;
    }
    for (int k0 = 0; k0 < nr; k0 += 32) {   // uniform over the warp
      const int k = k0 + lane;
      const bool on = k < nr;
      const float4 y = on ? Rv.q[k] : make_float4(-INFINITY, 0.f, 0.f, __int_as_float(-1));
      const int ra = __float_as_int(y.w), rid = on ? Rv.id[k] : -1;
      float c[S1_FR];
      float top = -INFINITY;
#pragma unroll
      for (int q = 0; q < S1_FR; ++q) {
        const float disp = __fadd_rn(fabsf(__fsub_rn(fs[q], y.y)), fabsf(__fsub_rn(fe[q], y.z)));
        const float pen = __fadd_rn(in.R, __fmul_rn(in.r, disp));
        c[q] = __fsub_rn(__fadd_rn(fv[q], y.x), pen);
        if (ra != fa[q] && rid != fid[q]) top = fmaxf(top, c[q]);
      }
      const int wkey = __reduce_max_sync(0xffffffffu, f32_key(top));
      if (wkey >= tkey) {   // rare, and the same for the whole warp
        tkey = wkey;
        if (top >= me.v) {
          const int ki = Rv.info[k];
#pragma unroll
          for (int q = 0; q < S1_FR; ++q) {
            if (c[q] >= me.v && ra != fa[q] && rid != fid[q]) {
              const int fi = F.info[g + q];
              const long long f = pair_key(fi & INT_MAX, ki & INT_MAX);
              const bool e = (fi & ki) < 0;
              if (c[q] > me.v) {
                me = Best{c[q], f, e ? f : BIG};
              } else {
                me.flat = min(me.flat, f);
                if (e) me.edge = min(me.edge, f);
              }
            }
          }
        }
      }
    }
  }
}

// The summary of pair (b, j) over the block; thread 0 returns it.  `F`
// holds capf forward rows, `Rv` capr reverse rows.  Starts and ends with
// a barrier, so a block may call it again at once.
__device__ Best eval_pair(const SplitIn& in, int b, int j, const Rows& F, int capf,
                          const Rows& Rv, int capr, int* s_cnt, Best* s_warp) {
  const size_t base = (size_t)b * in.I * in.Lp + j;
  Best me{NEGF, BIG, BIG};
  int tkey = f32_key(NEGF);   // the warp's largest valid candidate so far
  __syncthreads();   // the previous pair's rows are read
  int rraw = 0;
  int nr = fill_rows(in, in.rmax, in.rarg, in.vr, in.rve, base, rraw, capr, Rv, s_cnt);
  const bool whole = rraw >= in.I;
  int fraw = (whole && nr == 0) ? in.I : 0;   // no valid reverse row: no valid pair
  while (fraw < in.I) {
    const int nf = fill_rows(in, in.fmax, in.farg, in.vf, in.fwe, base, fraw, capf, F, s_cnt);
    if (whole) {
      pair_rows(in, F, nf, Rv, nr, me, tkey);
    } else {   // the reverse rows in tiles, staged again for each forward tile
      for (int rr = 0; rr < in.I;) {
        __syncthreads();
        nr = fill_rows(in, in.rmax, in.rarg, in.vr, in.rve, base, rr, capr, Rv, s_cnt);
        pair_rows(in, F, nf, Rv, nr, me, tkey);
      }
    }
    __syncthreads();   // the forward tile is read
  }

  // block reduction of (max, first flat, first onedge flat)
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
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
  if (threadIdx.x == 0) {
    for (int w = 1; w < S1_WARPS; ++w) me = best_of(me, s_warp[w]);
    if (me.v == NEGF) {   // no valid pair: every pair ties at NEGF
      me.flat = 0;
      me.edge = in.edge0 >= 0 ? in.edge0 : BIG;
    }
  }
  __syncthreads();   // s_warp is read
  return me;
}

__global__ void __launch_bounds__(S1_THREADS)
split_summary_kernel(SplitIn in, const int* __restrict__ bidx, const int* __restrict__ cols,
                     int capf, int capr, float* col_max, int* edge_any, long long* flat_edge,
                     long long* flat_plain) {
  extern __shared__ __align__(16) unsigned char s_rows[];
  __shared__ int s_cnt[2 * S1_WARPS];
  __shared__ Best s_warp[S1_WARPS];
  const Rows Rv = carve(s_rows, capr);
  const Rows F = carve(s_rows + (size_t)ROW_BYTES * capr, capf);
  const int p = blockIdx.x;
  const Best me = eval_pair(in, bidx[p], cols[p], F, capf, Rv, capr, s_cnt, s_warp);
  if (threadIdx.x == 0) {
    col_max[p] = me.v;
    flat_plain[p] = key_flat(me.flat, in.I);
    edge_any[p] = me.edge != BIG;
    flat_edge[p] = me.edge != BIG ? key_flat(me.edge, in.I) : 0;
  }
}

// Per-read state of the guided entry: int32 [3, B] (the column cursor,
// the blocks finished, the key of M_b) and, per column, int32 [3, B, Lp]
// (col_max bits, edge_any, evaluated) and int64 [2, B, Lp] (the pair
// keys of flat_edge and flat_plain).
struct Guided {
  const float* ubs;      // [B, Lp] ub - R of the read's columns in falling order
  const int* order;      // [B, Lp] their column indices
  const int* ncand;      // [B] columns that are not masked
  const float* init;     // [B] init_best
  int B, C;
  int* cursor;
  int* finished;
  int* mkey;
  int *cm, *ea, *done;
  long long *fe, *fp;
  int* out;              // [7, B]: best bits, taken, fen, rsn, fp, rp, col
  unsigned long long* pairs;   // evaluated pairs (metrics.device_counter), or null
};

// The take/tie chain of best_alignment (:803-860) over read b's evaluated
// columns in ascending order, on one warp, and the split's paths.
__device__ void replay(const SplitIn& in, const Guided& g, int b) {
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)b * in.Lp;
  float best = g.init[b];
  bool edge = false, taken = false;
  int col = 0;
  long long flat = 0;
  for (int j0 = 0; j0 < in.Lp; j0 += 32) {   // 32 columns' summaries at once, one a lane
    const int j = j0 + lane;
    const bool d = j < in.Lp && __ldcg(g.done + row + j) != 0;
    unsigned m = __ballot_sync(0xffffffffu, d);
    if (m == 0) continue;
    int cmj = 0, eaj = 0;
    long long fej = 0, fpj = 0;
    if (d) {
      cmj = __ldcg(g.cm + row + j);
      eaj = __ldcg(g.ea + row + j);
      fej = __ldcg(g.fe + row + j);
      fpj = __ldcg(g.fp + row + j);
    }
    while (m) {   // the evaluated columns in ascending order
      const int l = __ffs(m) - 1;
      m &= m - 1;
      const float cv = __int_as_float(__shfl_sync(0xffffffffu, cmj, l));
      const bool ea = __shfl_sync(0xffffffffu, eaj, l) != 0;
      const long long fe = __shfl_sync(0xffffffffu, fej, l);
      const long long fp = __shfl_sync(0xffffffffu, fpj, l);
      const bool gt = cv > best;
      if (gt || (cv == best && !edge && ea)) {
        const bool use_edge = gt ? ea : true;
        flat = use_edge ? fe : fp;
        best = cv;
        edge = use_edge;
        taken = true;
        col = j0 + l;
      }
    }
  }
  if (lane == 0) {
    const int wi = (int)(flat >> 32), wk = (int)(flat & 0xffffffffLL);
    const size_t cell = (size_t)b * in.I * in.Lp + col;
    const int B = g.B;
    g.out[b] = __float_as_int(best);
    g.out[B + b] = taken;
    g.out[2 * B + b] = taken ? wi + 1 : 0;
    g.out[3 * B + b] = taken ? wk + 1 : 0;
    g.out[4 * B + b] = taken ? in.farg[cell + (size_t)wi * in.Lp] : 0;
    g.out[5 * B + b] = taken ? in.rarg[cell + (size_t)wk * in.Lp] : 0;
    g.out[6 * B + b] = taken ? col : 0;
  }
}

__global__ void __launch_bounds__(S1_THREADS)
split_guided_kernel(SplitIn in, Guided g, int capf, int capr) {
  extern __shared__ __align__(16) unsigned char s_rows[];
  __shared__ int s_cnt[2 * S1_WARPS];
  __shared__ Best s_warp[S1_WARPS];
  __shared__ int s_col, s_last;
  const Rows Rv = carve(s_rows, capr);
  const Rows F = carve(s_rows + (size_t)ROW_BYTES * capr, capf);
  const int b = blockIdx.x % g.B;   // the first B blocks take one read each
  const size_t row = (size_t)b * in.Lp;
  int evaluated = 0;
  for (;;) {
    if (threadIdx.x == 0) {
      int col = -1;
      const int c = atomicAdd(g.cursor + b, 1);
      if (c < g.ncand[b]) {
        const float m = key_f32(__ldcg(g.mkey + b));
        const float init = g.init[b];
        const float thresh = m > init ? m : init;   // numpy's maximum: a NaN init stays
        if (__fadd_rn(g.ubs[row + c], 0.5f) >= thresh) col = g.order[row + c];
      }
      s_col = col;
    }
    __syncthreads();
    const int j = s_col;   // read before eval_pair's first barrier
    if (j < 0) break;
    const Best me = eval_pair(in, b, j, F, capf, Rv, capr, s_cnt, s_warp);
    if (threadIdx.x == 0) {
      g.cm[row + j] = __float_as_int(me.v);
      g.ea[row + j] = me.edge != BIG;
      g.fe[row + j] = me.edge != BIG ? me.edge : 0;
      g.fp[row + j] = me.flat;
      g.done[row + j] = 1;
      atomicMax(g.mkey + b, f32_key(me.v));
    }
    ++evaluated;
  }
  if (threadIdx.x == 0) {
    if (g.pairs != nullptr && evaluated > 0) atomicAdd(g.pairs, (unsigned long long)evaluated);
    __threadfence();   // this block's columns before its count
    s_last = atomicAdd(g.finished + b, 1) == g.C - 1;
  }
  __syncthreads();
  if (s_last && threadIdx.x < 32) {
    __threadfence();
    replay(in, g, b);
  }
}

// The column bound of the guided search (``_column_ub``): per (read b,
// column j), the min over the four sign cases s of
//
//     max_i (fv[b, i, j] + wf[s, i]) + max_k (rv[b, k, j] + wr[s, k]),
//
// fv = f32(fmax) where vf holds, else NEGF (rv likewise), each add an
// f32 __fadd_rn as torch computes it.  One thread a column of a
// 32-column tile, the block's warps over the rows, so each warp reads a
// row's columns in one coalesced load; the summaries are read once, a
// value only where its flag holds.  Bound by the bytes it reads.
__global__ void __launch_bounds__(S1_THREADS)
split_bound_kernel(const int* __restrict__ fmax, const unsigned char* __restrict__ vf,
                   const int* __restrict__ rmax, const unsigned char* __restrict__ vr,
                   const float* __restrict__ wf, const float* __restrict__ wr, int I, int Lp,
                   float* __restrict__ ub) {
  __shared__ float s_max[S1_WARPS][8][32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int tiles = (Lp + 31) / 32;
  const int b = blockIdx.x / tiles, j = (blockIdx.x % tiles) * 32 + lane;
  float m[8];   // [s]: forward, [4 + s]: reverse
#pragma unroll
  for (int s = 0; s < 8; ++s) m[s] = -INFINITY;
  if (j < Lp) {
    for (int i = wid; i < I; i += S1_WARPS) {
      const size_t c = ((size_t)b * I + i) * Lp + j;
      const float fv = vf[c] ? (float)fmax[c] : NEGF;
      const float rv = vr[c] ? (float)rmax[c] : NEGF;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        m[s] = fmaxf(m[s], __fadd_rn(fv, wf[s * I + i]));
        m[4 + s] = fmaxf(m[4 + s], __fadd_rn(rv, wr[s * I + i]));
      }
    }
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) s_max[wid][s][lane] = m[s];
  __syncthreads();
  if (wid == 0 && j < Lp) {
    for (int w = 1; w < S1_WARPS; ++w) {
#pragma unroll
      for (int s = 0; s < 8; ++s) m[s] = fmaxf(m[s], s_max[w][s][lane]);
    }
    float u = __fadd_rn(m[0], m[4]);
#pragma unroll
    for (int s = 1; s < 4; ++s) u = fminf(u, __fadd_rn(m[s], m[4 + s]));
    ub[(size_t)b * Lp + j] = u;
  }
}

inline size_t smem_bytes(int capf, int capr) { return (size_t)ROW_BYTES * (capf + capr); }

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

inline bool bad_caps(int I, int capf, int capr) {
  return I < 1 || capf < S1_WINDOW || capr < S1_WINDOW ||
         smem_bytes(capf, capr) > SMEM_MAX;
}

}  // namespace rgt

extern "C" int rgt_split_summary(
    const int* fmax, const int* farg, const unsigned char* vf, const int* rmax,
    const int* rarg, const unsigned char* vr, const float* dfs, const float* dfe,
    const int* ids, const unsigned char* fwe, const unsigned char* rve, float R, float r,
    const int* bidx, const int* cols, int K, int I, int Lp, long long edge0, int capf,
    int capr, float* col_max, int* edge_any, long long* flat_edge, long long* flat_plain,
    void* stream) {
  if (K < 1 || Lp < 1 || rgt::bad_caps(I, capf, capr)) return (int)cudaErrorInvalidValue;
  const size_t smem = rgt::smem_bytes(capf, capr);
  cudaError_t err = rgt::allow_smem(rgt::split_summary_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const rgt::SplitIn in{fmax, farg, vf, rmax, rarg, vr, dfs, dfe, ids, fwe, rve, R, r,
                        I, Lp, edge0};
  rgt::split_summary_kernel<<<K, rgt::S1_THREADS, smem, (cudaStream_t)stream>>>(
      in, bidx, cols, capf, capr, col_max, edge_any, flat_edge, flat_plain);
  return (int)cudaGetLastError();
}

extern "C" int rgt_split_guided(
    const int* fmax, const int* farg, const unsigned char* vf, const int* rmax,
    const int* rarg, const unsigned char* vr, const float* dfs, const float* dfe,
    const int* ids, const unsigned char* fwe, const unsigned char* rve, float R, float r,
    const float* ubs, const int* order, const int* ncand, const float* init, int B, int I,
    int Lp, long long edge0, int C, int capf, int capr, int* state, int* cols,
    long long* flats, int* out, unsigned long long* pairs, void* stream) {
  if (B < 1 || Lp < 1 || C < 1 || (long long)B * C > INT_MAX ||
      rgt::bad_caps(I, capf, capr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = rgt::smem_bytes(capf, capr);
  cudaError_t err = rgt::allow_smem(rgt::split_guided_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const rgt::SplitIn in{fmax, farg, vf, rmax, rarg, vr, dfs, dfe, ids, fwe, rve, R, r,
                        I, Lp, edge0};
  const size_t plane = (size_t)B * Lp;
  const rgt::Guided g{ubs, order, ncand, init, B, C, state, state + B, state + 2 * B,
                      cols, cols + plane, cols + 2 * plane, flats, flats + plane, out, pairs};
  rgt::split_guided_kernel<<<B * C, rgt::S1_THREADS, smem, (cudaStream_t)stream>>>(
      in, g, capf, capr);
  return (int)cudaGetLastError();
}

extern "C" int rgt_split_bound(const int* fmax, const unsigned char* vf, const int* rmax,
                               const unsigned char* vr, const float* wf, const float* wr, int B,
                               int I, int Lp, float* ub, void* stream) {
  const long long blocks = (long long)B * ((Lp + 31) / 32);
  if (B < 1 || I < 1 || Lp < 1 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  rgt::split_bound_kernel<<<(int)blocks, rgt::S1_THREADS, 0, (cudaStream_t)stream>>>(
      fmax, vf, rmax, vr, wf, wr, I, Lp, ub);
  return (int)cudaGetLastError();
}

// Blocks of the guided kernel one SM holds at once with this shared
// memory, or -error.
extern "C" int rgt_split_guided_per_sm(int capf, int capr) {
  const size_t smem = rgt::smem_bytes(capf, capr);
  cudaError_t err = rgt::allow_smem(rgt::split_guided_kernel, smem);
  if (err != cudaSuccess) return -(int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rgt::split_guided_kernel,
                                                      rgt::S1_THREADS, smem);
  return err == cudaSuccess ? per_sm : -(int)err;
}
