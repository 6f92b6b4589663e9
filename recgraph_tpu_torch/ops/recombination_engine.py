"""Recombination modes 8/9: the reverse pathwise fill, the split search,
the two walks and the chunked batch loop.

Counterpart of ``recgraph_tpu/ops/recombination_engine.py``
(reference: src/pathwise_alignment_recombination.rs):

- ``fill_pathwise_rev_plain`` ports ``_fill_pathwise_rev`` (``:87-188``)
  with its exact replay (``encode_chain=False``) as a torch row loop;
  ``fill_pathwise_rev_best`` (``pathwise_engine.py:183-217``): a CUDA
  tensor launches the hand-written kernel (``cuda_pathwise_rev``, one
  kernel for every path count), a CPU tensor runs the plain version;
- ``_path_argmax`` (``:191-201``), ``_SplitGeometry`` (``:425-475``) and
  ``_column_ub`` (``:356-381``; on the card S1's bound entry computes
  it);
- ``col_summary_plain`` ports ``_col_summary_fn`` (``:478-594``) per
  (read, column) pair; ``col_summary_best`` launches S1's per-pair
  entry (``cuda_split_summary``) on the card;
- ``_run_split_guided`` (``:597-765``), evaluating each read at its own
  needed columns in host rounds; ``split_search_best``, the main path's
  search: on the card S1's guided entry runs a chunk's whole search in
  one launch, on the CPU ``_run_split_guided``;
- ``_baseline`` (``:804-823``) and the walk starts (``:1269-1291``),
  batched;
- ``walk_reverse`` ports ``_walk_reverse`` (``:984-1077``) as a
  host-driven loop of batched torch ops;
- ``_walk_pieces``, ``_gaf_rec_from_walks``, ``_records_from_rec_walks``
  (``:1080-1143, :1337-1387``) and ``run_batch_walks`` (``:1145-1334``);
- ``_run_split`` (``:768-801``), the dispatcher: with
  ``RECGRAPH_SPLIT_FULL`` set, or where Lp - 2 <= 8, the full column scan
  ``split_search_full`` (``_split_search_fn``, ``:204-337``, torch ops on
  either device, independent of S1) over ``_SplitGeometry.planes``
  (``:455-475``) with ``_get_split``'s chunk rule (``split_chunk``) and
  ``_candidate_columns`` (``:384-421``);
- the opt-in windowed mode-8 pair (``RECGRAPH_REC_WINDOW=1``):
  ``_run_batch_walks_win8`` (``:1414-1658``) with its gate, the exact
  acceptance rescore ``_rescore_walk_rev`` (``:1390-1411``) and
  ``walk_reverse(..., ws=)``; its fills are ``pathwise_window`` (K10) and
  ``recombination_window`` (S2).  The windowed walk reads the read at its
  own width, where the JAX engine clamps to the window's (ROADMAP F4).

Not ported: ``run_batch`` (``:855-983``, not reached by the CLI).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .. import metrics, scoring
from ..io.gaf import GafRecord
from ..metrics import phase
from ..oracle.recombination import _fmt_f32, get_node_offset, get_rec_path_len_start_end
from ..scoring import GAP, SENTINEL
from . import cuda_pathwise_rev, cuda_split_summary, pathwise_engine, traceback_engine
from .encode import encode_reads, path_device_graph, rev_device_graph
from .pathwise_engine import (
    WALK_BYTES, _cigar, _end_meta, _extract_plane, _final_column, _gaf_from_walk,
    _walk_and_fetch, _walk_meta, fetch_walk, fill_pathwise_best,
)
from .poa_engine import CHUNK_BYTES, D, L_DIR, LOW_D, NEG, U_DIR

_I32 = torch.int32
NEGF = -3.0e38
# the plain split search (``_run_split_guided``): the least columns
# evaluated per read and round; the pairs a round fills on the card by
# giving each read that still needs columns more of them (a round costs a
# host round trip); pairs per launch of S1's per-pair entry (the last
# launch of a round is padded to this count)
ROUND_COLS = 8
ROUND_PAIRS = {"cuda": 1024, "cpu": 0}
PAIRS_PER_LAUNCH = 256


# ---------------------------------------------------------------------------
# the reverse fill
# ---------------------------------------------------------------------------


def _shift_left(x):
    """x[..., j+1] at column j, NEG at the last column."""
    out = torch.roll(x, -1, dims=-1)
    out[..., -1] = NEG
    return out


def _suffix_cummax(x):
    return torch.cummax(x.flip(-1), dim=-1).values.flip(-1)


def fill_pathwise_rev_plain(dgr, table, seq, L, mode8):
    """Reverse pathwise fill over the reverse graph, as a torch row loop.

    ``seq`` is the forward '$'-prefixed read; the reverse read
    (get_rev_sequence: drop '$', append 'F') is rev[j] = seq[j + 1] with
    the sentinel at j = L - 1.  Rows n-2..1 read their successor rows
    (``dgr.pred_of``), columns chain right to left by (max,+) suffix
    scans.  Returns W int32[B, P, n, Lp]: 0 off-path, at column 0, past
    the read and on constant-0 lanes; row n-1 carries the suffix gap
    chain on path 0's plane only (the reference's delta quirk).
    """
    h = dgr.host()
    n, P = dgr.n, dgr.paths_number
    B, Lp = seq.shape
    dev = seq.device
    tab = table.to(dev, _I32)
    tab_h = tab.cpu().numpy()
    jcol = torch.arange(Lp, dtype=_I32, device=dev)
    L = L.to(dev).long()
    is_last = jcol[None, :] == (L - 1)[:, None]
    rev = torch.where(is_last, SENTINEL, torch.roll(seq, -1, dims=1)).long()
    in_read = jcol[None, :] < L[:, None]
    gseq = torch.where(in_read, tab[rev, GAP], 0)
    Gs = torch.cumsum(gseq.flip(1), 1, dtype=_I32).flip(1)   # suffix sums
    G3, last3, in3 = Gs[:, None, :], is_last[:, None, :], in_read[:, None, :]
    Lidx = (L - 1)[:, None, None].expand(B, P, 1)
    qsrc = dgr.qsrc_of if dgr.qsrc_of is not None else \
        torch.arange(P, dtype=_I32, device=dev).expand(n, P)
    keep = dgr.paths_on & (qsrc >= 0)
    qs = qsrc.long().clamp(min=0)
    pred = dgr.pred_of.long().clamp(min=0)
    rep = dgr.rep_of.long().clamp(min=0)

    A = torch.zeros((B, P, n, Lp), dtype=_I32, device=dev)
    A[:, :, n - 1, :] = torch.where((jcol > 0) & in_read, Gs, 0)[:, None, :]
    for i in range(n - 2, 0, -1):
        code = int(h["codes"][i])
        gap_i = int(tab_h[code, GAP])
        sub = tab[code][rev][:, None, :]                   # [B, 1, Lp]
        Aq = A[:, qs[i], pred[i]]                          # own source plane
        Ar = A[:, rep[i], pred[i]]

        # rep rows via the (max,+) suffix chain; the restart at j = L-1
        d_r = _shift_left(Ar) + sub
        u_r = Ar + gap_i
        last_r = Ar.gather(2, Lidx) + gap_i if mode8 else 0
        Achain = torch.where(last3, last_r, torch.maximum(d_r, u_r))
        Achain = torch.where(in3, Achain, NEG)
        rep_row = G3 + _suffix_cummax(Achain - G3)
        dirD = rep_row == d_r
        dirU = ~dirD & (rep_row == u_r)
        nonL = dirD | dirU | last3

        # every lane replays its rep's moves from the first non-L column
        # at or after j
        last_q = Aq.gather(2, Lidx) + gap_i if mode8 else 0
        V = torch.where(dirD, _shift_left(Aq) + sub, Aq + gap_i)
        V = torch.where(last3, last_q, V)
        kidx = (-_suffix_cummax(torch.where(nonL, -jcol, NEG))).clamp(0, Lp - 1).long()
        row = V.gather(2, kidx) + G3 - G3.expand(B, P, Lp).gather(2, kidx)
        row = torch.where(keep[i][None, :, None] & in3, row, 0)
        row[:, :, 0] = 0
        A[:, :, i, :] = row
    A[:, 1:, n - 1, :] = 0
    return A


def fill_pathwise_rev_best(dgr, table, seq, L, mode8):
    """Reverse pathwise fill: the CUDA kernel for CUDA tensors, the plain
    torch version for CPU tensors.  One kernel serves every path count:
    the TPU's path-tiled variant (``fill_pathwise_rev_bigp``) exists only
    for its VMEM limit."""
    if seq.is_cuda:
        return cuda_pathwise_rev.fill_pathwise_rev_cuda(dgr, table, seq, L, mode8)
    return fill_pathwise_rev_plain(dgr, table, seq, L, mode8)


# ---------------------------------------------------------------------------
# split search (best_alignment, :759-873)
# ---------------------------------------------------------------------------


def _path_argmax(A):
    """Per-cell best path over ALL P planes of A [B, P, rows, Lp]:
    (max, path) int32[B, rows, Lp]; the larger path id wins ties, as
    best_alignment's reversed argmax (:809-830)."""
    mx = A.amax(1)
    arg = torch.zeros(mx.shape, dtype=_I32, device=A.device)
    for p in range(A.shape[1]):
        arg.masked_fill_(A[:, p] == mx, p)
    return mx, arg


def split_inputs(Af, Ar, paths_on):
    """The split search's per-cell summaries over the interior rows:
    (fmax, farg, vf, rmax, rarg, vr), each [B, n-2, Lp], with vf/vr
    whether the best path covers the row (``paths_on`` bool[n, P])."""
    n = Af.shape[2]
    on_i = paths_on[1 : n - 1]
    iidx = torch.arange(n - 2, device=Af.device)[None, :, None]
    fmax, farg = _path_argmax(Af[:, :, 1 : n - 1])
    rmax, rarg = _path_argmax(Ar[:, :, 1 : n - 1])
    return fmax, farg, on_i[iidx, farg.long()], rmax, rarg, on_i[iidx, rarg.long()]


class _SplitGeometry:
    """O(n) split-search geometry: dfs/dfe distances, compacted node ids
    and the onedge edge flags over interior rows.  The candidate planes
    are computed from these vectors, never materialised."""

    def __init__(self, g, rg):
        n = g.n
        self.dfs = rg.distance_from_start_on_reverse()
        self.dfe = g.distance_from_end()
        ids = np.asarray(g.nodes_id_pos)
        interior = np.arange(1, n - 1)
        # equality-preserving compact ids (raw GFA ids may exceed int32)
        self.ids_i = np.unique(ids[interior], return_inverse=True)[1].astype(np.int32)
        self.fw_edge = ids[interior] != ids[interior + 1]
        self.rv_edge = ids[interior] != ids[interior - 1]
        self.dfs_i = self.dfs[interior]
        self.dfe_i = self.dfe[interior]
        self.paths = g.paths_number

    def displacement(self, i: int, k: int) -> int:
        """dms[i, k] for absolute positions (0 on the diagonal)."""
        if i == k:
            return 0
        return int(abs(int(self.dfs[i]) - int(self.dfs[k]))
                   + abs(int(self.dfe[i]) - int(self.dfe[k])))

    def planes(self, base_rec_cost, multi_rec_cost, device):
        """The dense interior planes of the full scan (``_SplitGeometry.planes``,
        :455-475): (penalty f32, diff_node, onedge) [I, I] on ``device``,
        built only on that route."""
        disp = (np.abs(self.dfs_i[:, None] - self.dfs_i[None, :])
                + np.abs(self.dfe_i[:, None] - self.dfe_i[None, :]))
        penalty = np.float32(base_rec_cost) + np.float32(multi_rec_cost) * disp.astype(np.float32)
        diff_node = self.ids_i[:, None] != self.ids_i[None, :]
        onedge = self.fw_edge[:, None] & self.rv_edge[None, :]
        return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                     for x in (penalty, diff_node, onedge))

    def tensors(self, device) -> dict:
        """The vectors on ``device`` (dfs/dfe as f32), ``edge0``, the flat
        index of the first onedge pair (-1: none), which a column with no
        valid pair reports, and the graph's path count ``paths`` (the
        kernel records it with its launch shape)."""
        I = len(self.ids_i)
        fi, rk = np.flatnonzero(self.fw_edge), np.flatnonzero(self.rv_edge)
        edge0 = int(fi[0]) * I + int(rk[0]) if len(fi) and len(rk) else -1
        t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)
        return dict(dfs=t(self.dfs_i.astype(np.float32), torch.float32),
                    dfe=t(self.dfe_i.astype(np.float32), torch.float32),
                    ids=t(self.ids_i, _I32), fwe=t(self.fw_edge, torch.bool),
                    rve=t(self.rv_edge, torch.bool), edge0=edge0, paths=self.paths)


def _sign_weights(geom, multi_rec_cost):
    """(wf, wr) f32[4, I]: -/+ r (s1 dfs + s2 dfe) per sign case."""
    r = np.float32(multi_rec_cost)
    signs = np.array([[1, 1], [1, -1], [-1, 1], [-1, -1]], np.float32)
    d = np.stack([geom.dfs_i, geom.dfe_i]).astype(np.float32)
    return -(r * signs @ d), r * signs @ d


def _column_ub(fmax, vf, rmax, vr, wf, wr):
    """f32[B, Lp] upper bound on each column's candidate-plane max: the
    4-sign separation of the displacement penalty (SURVEY §7.4.6), the
    min over the sign cases of the separated maxes.  wf/wr: f32[4, I]
    (R folded in by the caller).  O(n) per column."""
    fv = torch.where(vf, fmax.float(), NEGF)
    rv = torch.where(vr, rmax.float(), NEGF)
    ub = None
    for s in range(4):
        a = (fv + wf[s][None, :, None]).amax(1)
        b = (rv + wr[s][None, :, None]).amax(1)
        t = a + b
        ub = t if ub is None else torch.minimum(ub, t)
    return ub


def col_summary_plain(fmax, farg, vf, rmax, rarg, vr, geom, R, r, bidx, cols):
    """Per (read, column) pair ``(bidx[p], cols[p])``: the summary of the
    I x I candidate plane that best_alignment's take/tie chain reads,
    (col_max f32[K], edge_any bool[K], flat_edge int64[K], flat_plain
    int64[K]), as ``_col_summary_fn`` gives it (its flat indices are
    int32 and wrap past 46,340 interior rows; these do not).

    cand[i, k] = (f32(fmax[i]) + f32(rmax[k])) - (R + r (|Δdfs| + |Δdfe|)),
    valid where the node ids differ, both summaries are on their paths
    and the paths differ.  A column with no valid pair has col_max NEGF,
    flat_plain 0 and the edge flags of the whole plane.  Invalid rows and
    columns cannot hold the max otherwise, so each pair is evaluated on
    its valid sub-grid only.
    """
    I = fmax.shape[1]
    dev = fmax.device
    R32 = torch.tensor(R, dtype=torch.float32, device=dev)
    r32 = torch.tensor(r, dtype=torch.float32, device=dev)
    b64, c64 = bidx.long(), cols.long()
    fv, fa, vfk = (x[b64, :, c64] for x in (fmax, farg, vf))   # [K, I]
    rv, ra, vrk = (x[b64, :, c64] for x in (rmax, rarg, vr))
    dfs, dfe, ids, fwe, rve = (geom[k] for k in ("dfs", "dfe", "ids", "fwe", "rve"))
    edge0 = geom["edge0"]
    out = []
    for p in range(bidx.shape[0]):
        fi = vfk[p].nonzero()[:, 0]
        rk = vrk[p].nonzero()[:, 0]
        disp = ((dfs[fi][:, None] - dfs[rk][None, :]).abs()
                + (dfe[fi][:, None] - dfe[rk][None, :]).abs())
        cand = (fv[p, fi].float()[:, None] + rv[p, rk].float()[None, :]) - (R32 + r32 * disp)
        valid = ((ids[fi][:, None] != ids[rk][None, :])
                 & (fa[p, fi][:, None] != ra[p, rk][None, :]))
        if not bool(valid.any()):
            out.append((NEGF, edge0 >= 0, max(edge0, 0), 0))
            continue
        cv = torch.where(valid, cand, NEGF)
        cmax = cv.max()
        flat = fi[:, None] * I + rk[None, :]
        atm = cv == cmax
        ate = atm & fwe[fi][:, None] & rve[rk][None, :]
        eany = bool(ate.any())
        out.append((float(cmax), eany, int(flat[ate].min()) if eany else 0, int(flat[atm].min())))
    cm, ea, fe, fp = zip(*out) if out else ((), (), (), ())
    return (torch.tensor(cm, dtype=torch.float32, device=dev),
            torch.tensor(ea, dtype=torch.bool, device=dev),
            torch.tensor(fe, dtype=torch.int64, device=dev),
            torch.tensor(fp, dtype=torch.int64, device=dev))


def col_summary_best(inputs, geom, R, r, bidx, cols):
    """Column summaries: the S1 kernel for CUDA tensors, in launches of
    ``PAIRS_PER_LAUNCH`` pairs (the last padded with copies of its first
    pair), the plain version for CPU tensors."""
    if not inputs[0].is_cuda:
        return col_summary_plain(*inputs, geom, R, r, bidx, cols)
    K = bidx.shape[0]
    parts = []
    for p0 in range(0, K, PAIRS_PER_LAUNCH):
        b, c = bidx[p0 : p0 + PAIRS_PER_LAUNCH], cols[p0 : p0 + PAIRS_PER_LAUNCH]
        k = b.shape[0]
        if k < PAIRS_PER_LAUNCH:
            b = torch.cat([b, b[:1].expand(PAIRS_PER_LAUNCH - k)])
            c = torch.cat([c, c[:1].expand(PAIRS_PER_LAUNCH - k)])
        got = cuda_split_summary.col_summary_cuda(*inputs, geom, R, r, b.contiguous(),
                                                  c.contiguous())
        parts.append(tuple(x[:k] for x in got))
    return tuple(torch.cat(x) for x in zip(*parts))


def _run_split_guided(inputs, geom, geom_t, active_np, init_best, base_rec_cost,
                      multi_rec_cost, round_cols=ROUND_COLS, round_pairs=0, sub_batch=None):
    """Bound-guided EXACT split search (``_run_split_guided``, :597-765),
    each read at its own columns.

    1. ub[b, j] for every column, O(I) per column (``_split_ub``);
    2. in rounds, evaluate for every read up to max(``round_cols``,
       ``round_pairs`` / the reads with columns left) of its columns
       with ub + 0.5 >= max(M_b, baseline_b), M_b its largest col_max
       so far, until no read has such a column left.  A skipped
       column has col_max <= ub < max(M_b, baseline_b) <= B*_b, the
       read's final best, so every column with col_max == B*_b is
       evaluated;
    3. replay best_alignment's take/tie chain (:803-860) over each read's
       evaluated columns in ascending order.  Its final state depends
       only on the columns with col_max == B*_b (the first always
       takes, later ones only by the onedge == rule), so it equals the
       full scan's, f32 == comparisons included.  The JAX engine
       evaluates the union of a sub-batch's columns; by the same
       argument the extra columns change nothing.

    Reads are searched ``sub_batch`` at a time (default: all).  Returns
    numpy (best f32, taken, fen, rsn, fp, rp, col), each [B].  The plain
    version of S1's guided entry (``cuda_split_summary.split_guided_cuda``).
    """
    ub, cols, done = _search_columns(inputs, geom, geom_t, active_np, init_best, base_rec_cost,
                                     multi_rec_cost, round_cols, round_pairs, sub_batch)
    return _replay(inputs, cols, done, active_np, init_best)


def _search_columns(inputs, geom, geom_t, active_np, init_best, base_rec_cost, multi_rec_cost,
                    round_cols=ROUND_COLS, round_pairs=0, sub_batch=None):
    """Steps 1-2 of :func:`_run_split_guided`: the masked ub f32[B, Lp],
    the evaluated columns' summaries (col_max f32, edge_any bool,
    flat_edge int64, flat_plain int64, each [B, Lp]) and which columns
    were evaluated, bool[B, Lp] (numpy)."""
    fmax, farg, vf, rmax, rarg, vr = inputs
    B, I, Lp = fmax.shape
    dev = fmax.device
    ub = _split_ub(inputs, geom, multi_rec_cost).cpu().numpy() - np.float32(base_rec_cost)
    ub = np.where(active_np, ub, -np.inf)
    ub[:, :1] = -np.inf
    ub[:, Lp - 1 :] = -np.inf

    cm_all = np.full((B, Lp), -np.inf, np.float32)
    ea_all = np.zeros((B, Lp), bool)
    fe_all = np.zeros((B, Lp), np.int64)
    fp_all = np.zeros((B, Lp), np.int64)
    done = np.zeros((B, Lp), bool)
    sb = B if sub_batch is None else sub_batch
    for b0 in range(0, B, sb):
        rows = slice(b0, b0 + sb)
        M = np.full(min(sb, B - b0), -np.inf, np.float32)
        while True:
            thresh = np.maximum(M, init_best[rows])
            needed = (ub[rows] + 0.5 >= thresh[:, None]) & ~done[rows]
            if not needed.any():
                break
            prio = np.where(needed, ub[rows] - thresh[:, None], -np.inf)
            width = max(round_cols, round_pairs // int(needed.any(axis=1).sum()))
            order = np.argsort(-prio, axis=1, kind="stable")[:, :width]
            sel = np.take_along_axis(needed, order, 1)
            bb, kk = np.nonzero(sel)
            bb_abs, cc = bb + b0, order[bb, kk]
            got = col_summary_best(inputs, geom_t, base_rec_cost, multi_rec_cost,
                                   torch.from_numpy(bb_abs.astype(np.int32)).to(dev),
                                   torch.from_numpy(cc.astype(np.int32)).to(dev))
            cm, ea, fe, fp = (x.cpu().numpy() for x in got)
            metrics.EVENTS["split_rounds"] += 1
            metrics.EVENTS["split_pairs"] += len(bb)
            cm_all[bb_abs, cc], ea_all[bb_abs, cc] = cm, ea
            fe_all[bb_abs, cc], fp_all[bb_abs, cc] = fe, fp
            done[bb_abs, cc] = True
            np.maximum.at(M, bb, cm)
    return ub, (cm_all, ea_all, fe_all, fp_all), done


def _replay(inputs, cols, done, active_np, init_best):
    """Step 3 of :func:`_run_split_guided`: the take/tie chain over each
    read's evaluated columns and the split's paths."""
    farg, rarg = inputs[1], inputs[4]
    B, I, _ = farg.shape
    dev = farg.device
    cm_all, ea_all, fe_all, fp_all = cols
    best = init_best.astype(np.float32).copy()
    edge_state = np.zeros(B, bool)
    taken = np.zeros(B, bool)
    win_i, win_k, col = (np.zeros(B, np.int32) for _ in range(3))
    for j in np.flatnonzero(done.any(axis=0)):
        cm, ea = cm_all[:, j], ea_all[:, j]
        gt = cm > best
        eq = cm == best
        take = done[:, j] & active_np[:, j] & (gt | (eq & ~edge_state & ea))
        if not take.any():
            continue
        use_edge = np.where(gt, ea, True)
        flat = np.where(use_edge, fe_all[:, j], fp_all[:, j])
        best = np.where(take, cm, best)
        edge_state = np.where(take, use_edge, edge_state)
        taken |= take
        col = np.where(take, j, col).astype(np.int32)
        win_i = np.where(take, flat // I, win_i).astype(np.int32)
        win_k = np.where(take, flat % I, win_k).astype(np.int32)
    fpo = np.zeros(B, np.int32)
    rpo = np.zeros(B, np.int32)
    if taken.any():
        bi = torch.arange(B, device=dev)
        ci = torch.from_numpy(col).to(dev).long()
        fpo = farg[bi, torch.from_numpy(win_i).to(dev).long(), ci].cpu().numpy()
        rpo = rarg[bi, torch.from_numpy(win_k).to(dev).long(), ci].cpu().numpy()
        fpo = np.where(taken, fpo, 0).astype(np.int32)
        rpo = np.where(taken, rpo, 0).astype(np.int32)
    fen = np.where(taken, win_i + 1, 0).astype(np.int32)
    rsn = np.where(taken, win_k + 1, 0).astype(np.int32)
    return best, taken, fen, rsn, fpo, rpo, col


def _split_ub(inputs, geom, multi_rec_cost):
    """The column bound of the summaries, f32[B, Lp] on their device (R
    not yet taken off): S1's bound entry for CUDA tensors,
    ``_column_ub`` for CPU tensors."""
    fmax, _, vf, rmax, _, vr = inputs
    wf, wr = (torch.from_numpy(w).to(fmax.device) for w in _sign_weights(geom, multi_rec_cost))
    if fmax.is_cuda:
        return cuda_split_summary.column_ub_cuda(fmax, vf, rmax, vr, wf, wr, geom.paths)
    return _column_ub(fmax, vf, rmax, vr, wf, wr)


def split_unevaluated(ub, done, col_max, init_best):
    """The guided search's invariant, as a count of the columns that
    break it: int[B], the columns with ub + 0.5 >= the read's final
    threshold max(M_b, init_best_b) (M_b the largest col_max over the
    evaluated columns) that were not evaluated.  ``ub`` is the masked ub
    (-inf where a column is never a candidate); numpy arrays [B, Lp] and
    [B]."""
    M = np.where(done, col_max, np.float32(-np.inf)).max(axis=1).astype(np.float32)
    thresh = np.maximum(M, init_best.astype(np.float32))
    return ((ub.astype(np.float32) + 0.5 >= thresh[:, None]) & ~done).sum(axis=1)


def unpack_split(out):
    """S1's guided rows int32[7, B] (numpy) as ``_run_split_guided``'s
    (best f32, taken, fen, rsn, fp, rp, col)."""
    return (out[0].view(np.float32).copy(), out[1] != 0, *(out[k].copy() for k in range(2, 7)))


def split_search_best(inputs, geom, geom_t, active_np, init_best, base_rec_cost,
                      multi_rec_cost):
    """The split search of a chunk: S1's bound and guided entries for
    CUDA tensors (two launches, one copy of the seven rows to the host;
    the pairs it evaluates go to the device counter ``split_pairs``), the
    plain search for CPU tensors.  Returns numpy (best f32, taken, fen, rsn,
    fp, rp, col), each [B]."""
    dev = inputs[0].device
    if dev.type == "cpu":
        return _run_split_guided(inputs, geom, geom_t, active_np, init_best, base_rec_cost,
                                 multi_rec_cost, round_pairs=ROUND_PAIRS["cpu"])
    if dev.type != "cuda":
        raise ValueError(f"split search: no kernel for {dev.type} tensors")
    ub = _split_ub(inputs, geom, multi_rec_cost)
    out = cuda_split_summary.split_guided_cuda(
        inputs, geom_t, ub, torch.from_numpy(np.ascontiguousarray(active_np)).to(dev),
        torch.from_numpy(init_best.astype(np.float32)).to(dev), base_rec_cost, multi_rec_cost)
    metrics.EVENTS["split_rounds"] += 1
    return unpack_split(out.cpu().numpy())


# the full scan's candidate plane a chunk at most (``_get_split``, :340-354)
SPLIT_PLANE_BYTES = 1 << 28


def split_chunk(I: int, B: int) -> int:
    """The reverse rows Tc a chunk of the full scan's candidate plane holds
    (``_get_split``): all I while B x I x I f32 fit ``SPLIT_PLANE_BYTES``,
    else a multiple of 128, at least 128."""
    if 4 * B * I * I <= SPLIT_PLANE_BYTES:
        return I
    return max(128, (SPLIT_PLANE_BYTES // (4 * B * I)) // 128 * 128)


def _candidate_columns(inputs, geom, base_rec_cost, multi_rec_cost, active_np, init_best, Lp):
    """The ascending columns that can still affect the full scan
    (``_candidate_columns``, :384-421): those where some read's column
    bound (``_split_ub``: S1's bound entry on the card) minus R, plus 0.5,
    reaches its baseline, padded with 0 (never active) to a power of two
    of at least 4; None (scan every interior column) when Lp - 2 <= 8 or
    when they are half the columns or more.  A column below every read's
    baseline can never be taken, so dropping it leaves the scan's state,
    tie decisions included, unchanged."""
    cols_full = np.arange(1, Lp - 1, dtype=np.int32)
    if Lp - 2 <= 8:
        return None
    ub = _split_ub(inputs, geom, multi_rec_cost).cpu().numpy() - np.float32(base_rec_cost)
    keep = (ub + 0.5 >= init_best[:, None]) & active_np
    cols = np.flatnonzero(keep.any(axis=0)).astype(np.int32)
    if len(cols) * 2 >= len(cols_full):
        return None
    C = 1 << max(int(np.ceil(np.log2(max(len(cols), 1)))), 2)
    out = np.zeros(C, dtype=np.int32)
    out[: len(cols)] = cols
    return out


def split_search_full(cols, inputs, planes, active_np, init_best, Tc=None):
    """The full column scan of best_alignment (``_split_search_fn``,
    :204-337) as torch ops on the summaries' device: for each column of
    ``cols`` in order, the I x I candidate plane

        cand[i, k] = (f32(fmax[i]) + f32(rmax[k])) - penalty[i, k],

    valid where the node ids differ, the paths differ and both summaries
    are on their paths, evaluated ``Tc`` reverse rows at a time, its max,
    first flat index at the max and first onedge flat index at the max
    combined across chunks, then the reference's take/tie rule (a strict
    improvement, or an equal score displaced only by the first onedge
    candidate).  Flat indices are int64 (the JAX scan's int32 wrap past
    46,340 interior rows).  Columns where no read is active are skipped:
    nothing is taken there.  ``planes``: ``_SplitGeometry.planes``.
    Returns numpy (best f32, taken, fen, rsn, fp, rp, col), each [B]."""
    fmax, farg, vf, rmax, rarg, vr = inputs
    B, I, Lp = fmax.shape
    penalty, diff_node, onedge = planes
    Tc = I if Tc is None else Tc
    dev = fmax.device
    big = 1 << 62
    best = torch.from_numpy(init_best.astype(np.float32)).to(dev)
    edge_state = torch.zeros(B, dtype=torch.bool, device=dev)
    taken = torch.zeros(B, dtype=torch.bool, device=dev)
    fen, rsn, fp, rp, col = (torch.zeros(B, dtype=torch.int64, device=dev) for _ in range(5))
    act = torch.from_numpy(np.ascontiguousarray(active_np)).to(dev)
    bi = torch.arange(B, device=dev)
    # each chunk's flat indices i I + k, increasing along the chunk's
    # row-major layout: the first position at a max has the least index
    chunks = [(k0, min(k0 + Tc, I)) for k0 in range(0, I, Tc)]
    rows = torch.arange(I, device=dev)[:, None] * I
    flats = [(rows + torch.arange(k0, k1, device=dev)).reshape(-1) for k0, k1 in chunks]
    edges = [onedge[:, k0:k1].reshape(1, -1) for k0, k1 in chunks]
    for j in (int(c) for c in cols):
        if not active_np[:, j].any():
            continue
        fv, fa, vfj = fmax[:, :, j].float(), farg[:, :, j], vf[:, :, j]
        rv, ra, vrj = rmax[:, :, j].float(), rarg[:, :, j], vr[:, :, j]
        bestv = torch.full((B,), NEGF, dtype=torch.float32, device=dev)
        bflat = torch.full((B,), big, dtype=torch.int64, device=dev)
        beflat = bflat.clone()
        beany = torch.zeros(B, dtype=torch.bool, device=dev)
        for (k0, k1), flat, edge in zip(chunks, flats, edges):
            cv = (fv[:, :, None] + rv[:, None, k0:k1]) - penalty[None, :, k0:k1]
            valid = (diff_node[None, :, k0:k1] & (fa[:, :, None] != ra[:, None, k0:k1])
                     & vfj[:, :, None] & vrj[:, None, k0:k1])
            cv = cv.masked_fill_(~valid, NEGF).reshape(B, -1)
            cmax = cv.amax(1)
            atm = cv == cmax[:, None]
            fmin = flat[atm.byte().argmax(1)]   # argmax: the first maximal position
            ate = atm & edge
            eany = ate.any(1)
            femin = torch.where(eany, flat[ate.byte().argmax(1)], big)
            gtc = cmax > bestv
            eqc = cmax == bestv
            bflat = torch.where(gtc, fmin, torch.where(eqc, torch.minimum(bflat, fmin), bflat))
            beflat = torch.where(gtc, femin, torch.where(eqc, torch.minimum(beflat, femin), beflat))
            beany = torch.where(gtc, eany, beany | (eqc & eany))
            bestv = torch.maximum(bestv, cmax)
        flat_edge = torch.where(beany, beflat, 0)
        flat_plain = torch.clamp(bflat, max=I * I - 1)
        gt = bestv > best
        take = act[:, j] & (gt | ((bestv == best) & ~edge_state & beany))
        use_edge = torch.where(gt, beany, True)
        flat = torch.where(use_edge, flat_edge, flat_plain)
        ii, kk = flat // I, flat % I
        best = torch.where(take, bestv, best)
        edge_state = torch.where(take, use_edge, edge_state)
        taken |= take
        fen = torch.where(take, ii + 1, fen)
        rsn = torch.where(take, kk + 1, rsn)
        fp = torch.where(take, farg[bi, ii, j].long(), fp)
        rp = torch.where(take, rarg[bi, kk, j].long(), rp)
        col = torch.where(take, j, col)
    return (best.cpu().numpy(), taken.cpu().numpy(),
            *(x.to(_I32).cpu().numpy() for x in (fen, rsn, fp, rp, col)))


def _run_split(inputs, geom, geom_t, active_np, init_best, base_rec_cost, multi_rec_cost, n,
               Lp):
    """The split search dispatcher (``_run_split``, :768-801): the bound-
    guided search (``split_search_best``: S1 on the card) unless
    ``RECGRAPH_SPLIT_FULL`` is set or Lp - 2 <= 8, where the full column
    scan runs over the dense planes (``split_search_full`` on the columns
    of ``_candidate_columns``), kept as a cross-check independent of S1.
    Returns numpy (best f32, taken, fen, rsn, fp, rp, col), each [B]."""
    if Lp - 2 > 8 and not os.environ.get("RECGRAPH_SPLIT_FULL"):
        return split_search_best(inputs, geom, geom_t, active_np, init_best, base_rec_cost,
                                 multi_rec_cost)
    planes = geom.planes(base_rec_cost, multi_rec_cost, inputs[0].device)
    cols = _candidate_columns(inputs, geom, base_rec_cost, multi_rec_cost, active_np,
                              init_best, Lp)
    if cols is None:
        cols = np.arange(1, Lp - 1, dtype=np.int32)
    return split_search_full(cols, inputs, planes, active_np, init_best,
                             split_chunk(n - 2, active_np.shape[0]))


def _baseline(mode, finalcol, g):
    """No-recombination best score and path for a batch (:777-800):
    finalcol int [B, P, n] -> (f32[B], int32[B]).  First-max tie order:
    mode 8 over the sink's (pred, path) pairs in ``preds_and_paths``
    order, mode 9 over (row, path) for rows 0..n-2 on the path."""
    B, P, n = finalcol.shape
    if mode == 8:
        pairs = [(int(pred), int(p)) for pred, paths in g.preds_and_paths(n - 1)
                 for p in np.flatnonzero(paths)]
        if not pairs:   # no path reaches the sink: the reference's None
            return np.full(B, np.nan, np.float32), np.zeros(B, np.int32)
        preds, paths = (np.array(x, np.int64) for x in zip(*pairs))
        vals = finalcol[:, paths, preds]                   # [B, pairs]
        k = vals.argmax(axis=1)
        return vals[np.arange(B), k].astype(np.float32), paths[k].astype(np.int32)
    on = g.paths_nodes[: n - 1]                            # [n-1, P]
    vals = np.where(on[None], finalcol[:, :, : n - 1].transpose(0, 2, 1).astype(np.int64),
                    np.iinfo(np.int64).min).reshape(B, -1)
    k = vals.argmax(axis=1)
    return vals[np.arange(B), k].astype(np.float32), (k % P).astype(np.int32)


def _walk_starts(mode, g, finalcol, taken, fen, rec_col, fp_final, L):
    """Forward walk start (row, column) per read (:1269-1291): the split
    point when a split was taken, else the mode's no-recombination
    ending at the last column."""
    B, _, n = finalcol.shape
    if mode == 8:
        end = _end_meta(g, "cpu")[0].numpy()[fp_final]   # each path's sink predecessor
    else:
        vals = finalcol[np.arange(B), fp_final, 1 : n - 1].astype(np.int64)
        covered = g.paths_nodes[1 : n - 1].T[fp_final]
        end = 1 + np.where(covered, vals, np.iinfo(np.int64).min).argmax(axis=1)
    start_i = np.where(taken, fen, end).astype(np.int32)
    start_j = np.where(taken, rec_col, L - 1).astype(np.int32)
    return start_i, start_j


# ---------------------------------------------------------------------------
# walks (recombination_output.rs)
# ---------------------------------------------------------------------------


def walk_reverse(plane, seq, L, table, node_start_rev, codes, succ_of_rp, start_i, start_j,
                 global_mode, max_steps, ws=None):
    """Batched traceback over reverse best-path planes (recombination_
    output.rs:39-98, 389-449): from the split point towards the sinks,
    i -> its successor on the chosen path (``succ_of_rp``, -1 off-path)
    and j -> j + 1, with rev_seq[j] == seq[j + 1].  One step per
    iteration; lanes are tested for the end every ``CHECK_EVERY``
    iterations.  Returns (dirs int32[B, max_steps + 8] with -1 past each
    walk, rows, steps int32[B], rev_ending_node int32[B]: the row of the
    last main-loop cell, :481).

    ws (optional, int32[B, n]): per-row window starts of windowed planes
    [B, n, W] (``recombination_window``): column j of row i reads
    plane[b, i, j - ws[b, i]], NEG outside the window.  The read is
    indexed at its own width, seq[min(j + 1, Lp - 1)], also on windowed
    planes (the JAX engine clamps j + 1 to the plane's width there,
    ROADMAP F4)."""
    B, n, W = plane.shape
    dev = plane.device
    pf = plane.reshape(B, n * W)
    s64 = seq.long()
    tab = table.to(dev, _I32)
    ws64 = None if ws is None else ws.long()

    def at(i, j):
        if ws64 is None:
            return pf.gather(1, (i * W + j).clamp(0, n * W - 1)[:, None])[:, 0]
        i = i.clamp(max=n - 1)   # row n (past the sink) is read only by finished lanes
        rel = j - ws64.gather(1, i[:, None])[:, 0]
        v = pf.gather(1, (i * W + rel.clamp(0, W - 1))[:, None])[:, 0]
        return torch.where((rel >= 0) & (rel < W), v, NEG)

    i = start_i.long()
    j = start_j.long()
    last = L.long() - 1
    rev_end = i.clone()
    k = torch.zeros(B, dtype=_I32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    dirs = torch.full((B, max_steps + 8), -1, dtype=_I32, device=dev)
    rows = torch.zeros((B, max_steps + 8), dtype=_I32, device=dev)
    it = 0
    while it < max_steps:
        if it % traceback_engine.CHECK_EVERY == 0 and bool(done.all()):
            break
        main = (i > 0) & (i < n - 1) & (j < last) & ~done
        ltail = (j < last) & ~main & ~done
        if global_mode:
            utail = (i < n - 1) & (j >= last) & ~main & ~ltail & ~done
        else:
            utail = torch.zeros_like(done)
        emit = main | ltail | utail

        is_end = node_start_rev[i]
        succ_e = succ_of_rp.gather(1, i[:, None])[:, 0].long()
        covered = succ_e >= 0
        succ = torch.where(is_end & covered, succ_e, i + 1)
        srow = torch.where(is_end, succ_e.clamp(min=0), i + 1)
        code_i = codes[i].long()
        rseq_j = s64.gather(1, (j + 1).clamp(max=s64.shape[1] - 1)[:, None])[:, 0]
        zero_case = is_end & ~covered
        d = torch.where(zero_case, 0, at(srow, j + 1) + tab[code_i, rseq_j])
        u = torch.where(zero_case, 0, at(srow, j) + tab[code_i, GAP])
        l_ = torch.where(zero_case, 0, at(i, j + 1) + tab[GAP, rseq_j])
        mx = torch.maximum(torch.maximum(d, u), l_)
        is_d = mx == d
        is_u = ~is_d & (mx == u)
        code = torch.where(is_d, torch.where(rseq_j == code_i, D, LOW_D),
                           torch.where(is_u, U_DIR, L_DIR))
        code = torch.where(ltail, L_DIR, code)
        code = torch.where(utail, U_DIR, code)
        rev_end = torch.where(main, i, rev_end)
        dirs[:, it] = torch.where(emit, code, -1)
        rows[:, it] = torch.where(emit, i, 0)

        i = torch.where((main & (is_d | is_u)) | utail, succ, i)
        j = torch.where((main & ~is_u) | ltail, j + 1, j)
        k += emit.to(_I32)
        done = done | ~emit
        it += 1
    return dirs, rows, k, rev_end.to(_I32)


_DIRCH = np.array(["?", "D", "d", "L", "U"])


def _walk_pieces(dirs, rows, n_steps, ids, lnz):
    """(direction codes, handles, path bases, path_length) of one walk,
    in walk order."""
    d = np.asarray(dirs[:n_steps])
    r = np.asarray(rows[:n_steps])[(d == 1) | (d == 2) | (d == 4)]
    return d, ids[r], lnz[r], len(r)


def _gaf_rec_from_walks(fw, rv, g, fp, rp, fen, rsn, rev_ending_node, best_score, seq_len):
    """Stitch the forward and reverse walks into the recombination GAF
    record (recombination_output.rs:12-237, 363-631)."""
    ids = g.nodes_id_pos
    fw_d, fw_h, fw_ps, fw_len, stop_i = fw
    rv_d, rv_h, rv_ps, rv_len = rv
    rec_edge = len(fw_ps) - 1
    handles = np.concatenate((fw_h[::-1], rv_h))
    keep = np.ones(len(handles), bool)
    keep[1:] = handles[1:] != handles[:-1]
    pseq = np.concatenate((fw_ps[::-1], rv_ps)).tobytes().decode("latin1")
    start = stop_i if stop_i == 0 else stop_i + 1
    path_len, path_start, path_end = get_rec_path_len_start_end(
        ids, fen, rsn, start, rev_ending_node, fw_len, rv_len)
    recombination = (
        f"recombination path {fp} {rp}, "
        f"nodes {ids[fen]}[{get_node_offset(ids, fen)}] {ids[rsn]}[{get_node_offset(ids, rsn)}], "
        f"score: {_fmt_f32(best_score[0])}, displacement: {best_score[1]}"
        f"\t{pseq}\t{rec_edge}"
    )
    return GafRecord(
        query_name="Temp",
        query_length=seq_len - 1,
        query_start=0,
        query_end=seq_len - 2,
        strand="+",
        path=[int(h) for h in handles[keep]],
        path_length=path_len,
        path_start=path_start,
        path_end=path_end,
        residue_matches_number=0,
        alignment_block_length="*",
        mapping_quality="*",
        comments=f"{_cigar(np.concatenate((fw_d[::-1], rv_d)))}, {recombination}",
    )


def _records_from_rec_walks(seqs, g, geom, fp_final, rp_final, start_i, score, best, fen,
                            rsn, fwalk, rwalk):
    """Per-read GafRecords from the fetched walks: the pathwise record
    when no split was taken (fp == rp), else the recombination record."""
    ids, lnz = _walk_meta(g)
    fdirs, frows, fsteps, fstop = fwalk
    rdirs, rrows, rsteps, rev_end = rwalk
    out = []
    for b, s in enumerate(seqs):
        fp, rp = int(fp_final[b]), int(rp_final[b])
        if fp == rp:
            out.append(_gaf_from_walk(fdirs[b], frows[b], int(fsteps[b]), int(fstop[b]), g,
                                      fp, int(start_i[b]), int(score[b]), s))
            continue
        fw = _walk_pieces(fdirs[b], frows[b], int(fsteps[b]), ids, lnz) + (int(fstop[b]),)
        rv = _walk_pieces(rdirs[b], rrows[b], int(rsteps[b]), ids, lnz)
        out.append(_gaf_rec_from_walks(
            fw, rv, g, fp, rp, int(fen[b]), int(rsn[b]), int(rev_end[b]),
            (float(best[b]), geom.displacement(int(fen[b]), int(rsn[b]))), len(s)))
    return out


# ---------------------------------------------------------------------------
# the chunked batch loop
# ---------------------------------------------------------------------------


def run_batch_walks(mode, sequences, g, rg, sm, base_rec_cost, multi_rec_cost, rbw, device,
                    chunk_bytes=None, no_window=False) -> list[GafRecord]:
    """Modes 8/9 with on-device traceback.

    Per fill chunk (``chunk_bytes``, default ``CHUNK_BYTES[device]``, of
    the forward and reverse planes together): encode; the forward fill
    (mode-4 recurrence for 8, mode-5 for 9) and the reverse fill; the
    final column and the baseline; the per-cell best paths; the split
    search (``_run_split``); the two best-path planes, after which the
    full planes are freed.  The planes wait for one forward and one
    reverse walk loop over every chunk that fits ``WALK_BYTES``.

    Mode 8 with ``RECGRAPH_REC_WINDOW=1`` on reads of at least
    ``pathwise_engine.LONG_READ_LP`` columns, where the packed chain fits
    (``pathwise_engine._fits``), takes the windowed pair instead
    (``_run_batch_walks_win8``; ``no_window`` refuses it).  It is opt-in:
    the split search reads every plane cell, and windowed follower cells
    can over- and under-estimate; the exit guard and the exact acceptance
    rescores keep every record a valid alignment with its true score, but
    an underestimate can hide the optimum and emit a lower-scoring one.
    Mode 9 never windows (its endings make the exit bound vacuous).
    """
    if mode not in (8, 9):
        raise ValueError(f"recombination modes are 8 and 9, got {mode}")
    device = torch.device(device)
    if chunk_bytes is None:
        chunk_bytes = CHUNK_BYTES[device.type]
    dg = path_device_graph(g, device)
    dgr = rev_device_graph(rg, device)
    table = torch.as_tensor(sm.table, dtype=_I32).to(device)
    n, P = dg.n, dg.paths_number
    geom = _SplitGeometry(g, rg)
    geom_t = geom.tensors(device)
    Lp_all = max(len(s) for s in sequences)
    if (mode == 8 and not no_window and os.environ.get("RECGRAPH_REC_WINDOW") == "1"
            and pathwise_engine._fits(Lp_all, sm.table)
            and Lp_all >= pathwise_engine.LONG_READ_LP):
        return _run_batch_walks_win8(sequences, g, rg, sm, base_rec_cost, multi_rec_cost, rbw,
                                     device, dg, dgr, table, geom, geom_t, chunk_bytes)
    Lp = (Lp_all + 7) // 8 * 8
    chunk = max(1, chunk_bytes // (P * n * Lp * 4 * 2))
    walk_batch = max(1, WALK_BYTES[device.type] // (2 * n * Lp * 4))
    max_steps = n + Lp + 4
    records: list[GafRecord] = []
    pend: list = []

    def flush():
        if not pend:
            return
        seqs_h = [s for t in pend for s in t[0]]
        seq, L, fplane, rplane, fp, rp, si, sj, rs, rc = (
            torch.cat([t[k] for t in pend]) for k in range(1, 11))
        host = [np.concatenate([t[11][k] for t in pend]) for k in range(4)]
        pend.clear()
        fwalk = _walk_and_fetch(fplane, seq, L, table, dg, fp, si, mode == 8, max_steps,
                                start_j=sj)
        with phase("walk"):
            rwalk = walk_reverse(rplane, seq, L, table, dgr.node_start, dg.codes,
                                 dgr.pred_of.t()[rp.long()], rs, rc, mode == 8, max_steps)
        rwalk = fetch_walk(*rwalk, max_steps)
        del fplane, rplane
        score, best, fen, rsn = host
        fpn, rpn, sin = (t.cpu().numpy() for t in (fp, rp, si))
        with phase("emit"):
            records.extend(_records_from_rec_walks(seqs_h, g, geom, fpn, rpn, sin, score,
                                                   best, fen, rsn, fwalk, rwalk))

    pend_reads = 0
    for c0 in range(0, len(sequences), chunk):
        chunk_seqs = sequences[c0 : c0 + chunk]
        B = len(chunk_seqs)
        with phase("encode"):
            seq, L = encode_reads(chunk_seqs, pad_to=Lp_all, device=device)
        with phase("fill"):
            Af = fill_pathwise_best(dg, table, seq, mode == 9)
            Ar = fill_pathwise_rev_best(dgr, table, seq, L, mode == 8)
        with phase("dispatch"):
            fc = _final_column(Af, L)
            inputs = split_inputs(Af, Ar, dg.paths_on)
        with phase("device_wait"):
            finalcol = fc.cpu().numpy()
        Lnp = L.cpu().numpy()
        init_best, base_paths = _baseline(mode, finalcol, g)
        oob = np.maximum((Lnp * (1.0 - rbw) / 2.0).astype(np.int64), 1)
        jcol = np.arange(seq.shape[1])
        active = (jcol[None, :] >= oob[:, None]) & (jcol[None, :] < (Lnp - oob)[:, None])
        with phase("split"):
            best, taken, fen, rsn, fp, rp, rec_col = _run_split(
                inputs, geom, geom_t, active, init_best, base_rec_cost, multi_rec_cost, n,
                seq.shape[1])
        del inputs
        fp_final = np.where(taken, fp, base_paths).astype(np.int32)
        rp_final = np.where(taken, rp, base_paths).astype(np.int32)
        start_i, start_j = _walk_starts(mode, g, finalcol, taken, fen, rec_col, fp_final, Lnp)
        score = finalcol[np.arange(B), fp_final, start_i]
        # reads without a split need no reverse walk: start them where it ends
        rs = np.where(taken, rsn, n - 1).astype(np.int32)
        rc = np.where(taken, rec_col, Lnp - 1).astype(np.int32)
        with phase("dispatch"):
            fp_t, rp_t, si, sj, rs_t, rc_t = (torch.from_numpy(x).to(device) for x in (
                fp_final, rp_final, start_i, start_j, rs, rc))
            fplane = _extract_plane(Af, fp_t)
            rplane = _extract_plane(Ar, rp_t)
        del Af, Ar, fc
        pend.append((chunk_seqs, seq, L, fplane, rplane, fp_t, rp_t, si, sj, rs_t, rc_t,
                     (score, best, fen, rsn)))
        pend_reads += B
        if pend_reads + chunk > walk_batch:
            flush()
            pend_reads = 0
    flush()
    return records


# ---------------------------------------------------------------------------
# the opt-in windowed mode-8 pair (RECGRAPH_REC_WINDOW=1)
# ---------------------------------------------------------------------------


def _rescore_walk_rev(dirs_b, rows_b, ns, j0, codes, seqc, Lr, table, nstart_r, covered_r,
                      n) -> int:
    """Exact, plane-independent score of an emitted reverse walk (JAX
    ``:1390-1411``, the mirror of ``pathwise_engine._rescore_walk``:
    rev[j] = seq[j + 1], the sentinel at j = L - 1, moves go right).
    Host numpy."""
    s = 0
    j = int(j0)
    for k in range(int(ns)):
        i = int(rows_b[k])
        c = int(dirs_b[k])
        if 0 < i < n - 1 and j < Lr - 1 and nstart_r[i] and not covered_r[i]:
            return s
        rs = int(seqc[j + 1]) if j + 1 < Lr else SENTINEL
        if c in (1, 2):
            s += int(table[codes[i], rs])
            j += 1
        elif c == 4:
            s += int(table[codes[i], GAP])
        else:
            s += int(table[GAP, rs])
            j += 1
    return s


def _win_summaries(Aw, ws, paths_on, Lp):
    """The split search's summaries of windowed planes over the interior
    rows, at full width: (max, path, valid) [B, n-2, Lp], NEG / 0 / False
    outside the windows (``full_from_win`` of the per-cell best paths)."""
    from .recombination_window import full_from_win

    n = Aw.shape[2]
    mx_w, arg_w = _path_argmax(Aw[:, :, 1 : n - 1])
    wsi = ws[:, 1 : n - 1]
    mx = full_from_win(mx_w, wsi, NEG, Lp)
    arg = full_from_win(arg_w, wsi, 0, Lp)
    iidx = torch.arange(n - 2, device=Aw.device)[None, :, None]
    return mx, arg, paths_on[1 : n - 1][iidx, arg.long()] & (mx > NEG // 2)


def _run_batch_walks_win8(sequences, g, rg, sm, base_rec_cost, multi_rec_cost, rbw, device,
                          dg, dgr, table, geom, geom_t, chunk_bytes) -> list[GafRecord]:
    """Mode-8 long reads: the windowed O(W)-lane fill pair with a W ladder
    (``_run_batch_walks_win8``, JAX :1414-1658).

    Per pass at width W: the forward windowed fill (K10 on the card,
    ``pathwise_window.fill_pathwise_win_best``) and the reverse one (S2,
    ``recombination_window.fill_pathwise_rev_win_best``); the split
    search runs unchanged (``_run_split``) on the full-width per-cell
    summaries of the windowed planes; a read is accepted when its best
    strictly beats the composite exit bound (``composite_bound``, at least
    the forward bound) and its two walks over the windowed planes rescore
    exactly to the cells they start from (``_rescore_walk`` /
    ``_rescore_walk_rev``; a mismatch counts in
    ``metrics.EVENTS["rec_win_rescore"]``).  The rest double W, re-chunked
    at every rung (2 P n W 4 + 18 n Lp bytes a read against
    ``chunk_bytes``); reads still failing at W >= Lp rerun through the
    full-width engine (``run_batch_walks(..., no_window=True)``), counted
    in ``metrics.EVENTS["rec_win_fullwidth"]`` with a line on stderr.
    Each pass walks its own reads.  The width at which a whole chunk
    passed seeds the next ladder on the graph (``_pw_w_hint``, keyed
    apart from mode 4's)."""
    from . import pathwise_window
    from . import recombination_window as rw

    n, P = dg.n, dg.paths_number
    rmin = pathwise_window.rmin_tensor(dg)
    Lp_all = max(len(s) for s in sequences)
    Lp = (Lp_all + 7) // 8 * 8
    tab = np.asarray(sm.table)
    smax = max(int(tab.max()), 0)
    hint_key = pathwise_engine._graph_hint_key(g, dg) + ("rec8",)
    W0 = pathwise_engine._pw_w_hint.get(hint_key, 256)
    if W0 >= Lp_all:   # a hint from a longer-read batch
        W0 = 256
    max_steps = n + Lp_all + 4
    # host metadata of the exact acceptance rescores
    pred_f, pred_r = dg.host()["pred_of"], dgr.host()["pred_of"]
    nstart, nstart_r = np.asarray(g.node_start), np.asarray(rg.node_start)
    codes = np.asarray(g.codes)
    out: dict[int, GafRecord] = {}

    def win_pass(idxs, W):
        """One fill + guard + walk pass at width W: stores the accepted
        reads' records and returns the idxs that failed."""
        sub = [sequences[i] for i in idxs]
        B = len(sub)
        with phase("encode"):
            seq, L = encode_reads(sub, pad_to=Lp_all, device=device)
        with phase("fill"):
            Awf, wsf, bound_f = pathwise_window.fill_pathwise_win_best(dg, table, seq, L, W, rmin)
            Awr, wsr, Rr = rw.fill_pathwise_rev_win_best(dgr, table, seq, L, W)
        with phase("dispatch"):
            fmax, farg, vf = _win_summaries(Awf, wsf, dg.paths_on, Lp)
            rmax, rarg, vr = _win_summaries(Awr, wsr, dg.paths_on, Lp)
            Rf = bound_f - smax * (L - 1)
            gbound = torch.maximum(rw.composite_bound(fmax.amax(1), rmax.amax(1), Rf, Rr, L, smax),
                                   bound_f.float())
            fcw = pathwise_window._final_column_win(Awf, wsf, L)
        with phase("device_wait"):
            finalcol, gb = fcw.cpu().numpy(), gbound.cpu().numpy()
        Lnp = L.cpu().numpy()
        init_best, base_paths = _baseline(8, finalcol, g)
        oob = np.maximum((Lnp * (1.0 - rbw) / 2.0).astype(np.int64), 1)
        jcol = np.arange(Lp)
        active = (jcol[None, :] >= oob[:, None]) & (jcol[None, :] < (Lnp - oob)[:, None])
        inputs = (fmax, farg, vf, rmax, rarg, vr)
        with phase("split"):
            best, taken, fen, rsn, fp, rp, rec_col = _run_split(
                inputs, geom, geom_t, active, init_best, base_rec_cost, multi_rec_cost, n, Lp)
        passed = best > gb
        if not passed.any():
            return list(idxs)
        fp_final = np.where(taken, fp, base_paths).astype(np.int32)
        rp_final = np.where(taken, rp, base_paths).astype(np.int32)
        start_i, start_j = _walk_starts(8, g, finalcol, taken, fen, rec_col, fp_final, Lnp)
        score = finalcol[np.arange(B), fp_final, start_i]
        # reads without a split need no reverse walk: start them where it ends
        rs = np.where(taken, rsn, n - 1).astype(np.int32)
        rc = np.where(taken, rec_col, Lnp - 1).astype(np.int32)
        with phase("dispatch"):
            fp_t, rp_t, si, sj, rs_t, rc_t = (torch.from_numpy(x).to(device) for x in (
                fp_final, rp_final, start_i, start_j, rs, rc))
            fplane = _extract_plane(Awf, fp_t)
            rplane = _extract_plane(Awr, rp_t)
            bi = torch.arange(B, device=device)
            cj = torch.from_numpy(rec_col.astype(np.int64)).to(device)
            fsel_d = fmax[bi, torch.from_numpy((fen.astype(np.int64) - 1).clip(0)).to(device), cj]
            rsel_d = rmax[bi, torch.from_numpy((rsn.astype(np.int64) - 1).clip(0)).to(device), cj]
        del Awf, Awr, inputs, fmax, farg, vf, rmax, rarg, vr
        fwalk = _walk_and_fetch(fplane, seq, L, table, dg, fp_t, si, True, max_steps, ws=wsf,
                                start_j=sj)
        with phase("walk"):
            rwalk = walk_reverse(rplane, seq, L, table, dgr.node_start, dg.codes,
                                 dgr.pred_of.t()[rp_t.long()], rs_t, rc_t, True, max_steps,
                                 ws=wsr)
        rwalk = fetch_walk(*rwalk, max_steps)
        fsel, rsel = fsel_d.cpu().numpy(), rsel_d.cpu().numpy()
        fdirs, frows, fsteps, _ = fwalk
        rdirs, rrows, rsteps, _ = rwalk
        # exact acceptance rescores: a replayed follower cell can
        # overestimate, which a guard pass alone cannot rule out
        for b in np.flatnonzero(passed):
            seqc = scoring.encode(sub[b])
            claim = int(fsel[b]) if taken[b] else int(score[b])
            ok = pathwise_engine._rescore_walk(
                fdirs[b], frows[b], int(fsteps[b]), int(start_j[b]), codes, seqc, tab, nstart,
                pred_f[:, fp_final[b]] >= 0) == claim
            if ok and taken[b]:
                ok = _rescore_walk_rev(
                    rdirs[b], rrows[b], int(rsteps[b]), int(rec_col[b]), codes, seqc,
                    len(sub[b]), tab, nstart_r, pred_r[:, rp_final[b]] >= 0, n) == int(rsel[b])
            if not ok:
                passed[b] = False
                metrics.EVENTS["rec_win_rescore"] += 1
        with phase("emit"):
            recs = _records_from_rec_walks(sub, g, geom, fp_final, rp_final, start_i, score,
                                           best, fen, rsn, fwalk, rwalk)
        for b, i in enumerate(idxs):
            if passed[b]:
                out[i] = recs[b]
        return [i for b, i in enumerate(idxs) if not passed[b]]

    fullwidth_idx: list[int] = []
    # chunk on the expected ladder width, re-chunk at every rung
    per_read0 = 2 * P * n * min(2 * W0, Lp_all) * 4 + 18 * n * Lp_all
    chunk = max(1, chunk_bytes // per_read0)
    for c0 in range(0, len(sequences), chunk):
        idxs = list(range(c0, min(c0 + chunk, len(sequences))))
        W = W0
        while idxs and W < Lp_all:
            rung = max(1, chunk_bytes // (2 * P * n * W * 4 + 18 * n * Lp_all))
            failed: list[int] = []
            for s0 in range(0, len(idxs), rung):
                failed.extend(win_pass(idxs[s0 : s0 + rung], W))
            idxs = failed
            if not idxs:
                pathwise_engine._pw_w_hint[hint_key] = W
            W *= 2
        fullwidth_idx.extend(idxs)
    if fullwidth_idx:
        metrics.EVENTS["rec_win_fullwidth"] += len(fullwidth_idx)
        print(
            f"recgraph: {len(fullwidth_idx)} long read(s) exceeded the "
            "windowed mode-8 exit bound at every W; running full-width",
            file=sys.stderr,
        )
        sub = [sequences[i] for i in fullwidth_idx]
        recs = run_batch_walks(8, sub, g, rg, sm, base_rec_cost, multi_rec_cost, rbw, device,
                               chunk_bytes=chunk_bytes, no_window=True)
        for i, rec in zip(fullwidth_idx, recs):
            out[i] = rec
    return [out[i] for i in range(len(sequences))]
