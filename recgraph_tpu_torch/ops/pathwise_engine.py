"""Pathwise modes 4/5: the dense per-path fill, its dispatcher, the device
endings, the walk and the batch driver.

Counterpart of ``recgraph_tpu/ops/pathwise_engine.py``:

- ``fill_pathwise_plain`` ports ``_fill_pathwise`` (``:43-140``) as a
  torch row loop; it is what the CPU path runs and what the CUDA kernel
  is held against on the card;
- ``fill_pathwise_best`` (``:143-180``): a CUDA tensor launches the
  hand-written kernel (``cuda_pathwise``, one kernel for every path
  count), a CPU tensor runs the plain version;
- ``_final_column``, ``_extract_plane``, ``_end_meta`` and the two
  device endings (``:229-305``);
- ``walk_pathwise`` ports ``_walk_pathwise`` (``:364-462``) as a
  host-driven loop of batched torch ops;
- ``_record_from_walk`` / ``_gaf_from_walk`` (``:483-525, 738-756``);
- ``_rescore_walk`` (``:532-563``), the exact rescore the windowed
  mode-8 route of ``recombination_engine`` accepts a forward walk by;
- ``run_batch_walks``, ``_run_batch_walks_full`` and
  ``_run_batch_walks_win`` (``:574-918``): chunking, the walk batched
  across fill chunks, and the mode-4 long-read W ladder with its
  full-width rerun.

Semantics (pathwise_alignment.rs:16-304): at every cell each haplotype
path moves in the direction chosen by its group representative, tie
order mx == d, mx == u, else l.  The fill keeps dense per-path absolute
scores A int32[B, P, n, Lp]: the rep rows are solved by the (max,+)
prefix chain, the other paths replay the rep's moves from the value at
the last non-L column, ``V[k] + G[j] - G[k]``.  That exact replay is the
XLA engine's ``encode_chain=False``; its packed (column << 17 | value)
chain is a TPU workaround that equals it wherever the JAX engine uses it.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import metrics
from ..io.gaf import GafRecord
from ..metrics import phase
from ..oracle.pathwise import get_path_len_start_end
from ..scoring import GAP
from . import cuda_pathwise, pathwise_window, traceback_engine
from .encode import encode_reads, path_device_graph
from .poa_engine import CHUNK_BYTES, D, L_DIR, LOW_D, NEG, U_DIR, _shift_right

_I32 = torch.int32
LONG_READ_LP = 1024   # mode-4 reads at least this long use windowed rows
# extracted best-path planes held for one walk loop: a walk costs the
# same per step at any batch, so the card walks a whole stretch corpus
# (1.4 MB a read) at once; the JAX package's 256 MB elsewhere
WALK_BYTES = {"cuda": 16 << 30, "cpu": 1 << 28}


# ---------------------------------------------------------------------------
# the fill
# ---------------------------------------------------------------------------


def fill_pathwise_plain(dg, table, seq, semiglobal):
    """Dense absolute pathwise fill for a read batch, as a torch row loop.

    seq: int32[B, Lp] ('$'-prefixed, N-padded).  Returns A int32[B, P,
    n, Lp] of per-path absolute scores (0 where a path does not cover a
    node — the reference's untouched cells, pathwise_alignment.rs:16).
    """
    h = dg.host()
    n, P = dg.n, dg.paths_number
    B, Lp = seq.shape
    dev = seq.device
    tab = table.to(dev, _I32)
    tab_h = tab.cpu().numpy()
    s64 = seq.long()
    jcol = torch.arange(Lp, dtype=_I32, device=dev)
    G = torch.cumsum(tab[s64, GAP], 1, dtype=_I32)
    G3 = G[:, None, :]
    qdiag = torch.arange(P, device=dev)
    pred = dg.pred_of.long().clamp(min=0)
    rep = dg.rep_of.long().clamp(min=0)

    A = torch.zeros((B, P, n, Lp), dtype=_I32, device=dev)
    # row 0: every path advances with sm(seq[j], '-') gaps
    # (pathwise_alignment.rs:46-49)
    A[:, :, 0, :] = (G - G[:, :1])[:, None, :]
    for i in range(1, n - 1):
        code = int(h["codes"][i])
        gap_i = int(tab_h[code, GAP])
        sub = tab[code][s64][:, None, :]                   # [B, 1, Lp]
        Aq = A[:, qdiag, pred[i]]                          # [B, P, Lp]
        Ar = A[:, rep[i], pred[i]]

        # rep rows via the (max,+) chain
        d_r = _shift_right(Ar) + sub
        u_r = Ar + gap_i
        Achain = torch.maximum(d_r, u_r)
        Achain[:, :, 0] = 0 if semiglobal else Ar[:, :, 0] + gap_i
        rep_row = G3 + torch.cummax(Achain - G3, dim=2).values

        # directions from the rep values (tie order mx == d, mx == u, else L)
        dirD = rep_row == d_r
        dirU = ~dirD & (rep_row == u_r)
        nonL = dirD | dirU | (jcol == 0)

        # every lane replays its rep's moves from the last non-L column
        V = torch.where(dirD, _shift_right(Aq) + sub, Aq + gap_i)
        V[:, :, 0] = 0 if semiglobal else Aq[:, :, 0] + gap_i
        kidx = torch.cummax(torch.where(nonL, jcol, -1), dim=2).values.long()
        row = V.gather(2, kidx) + G3 - G3.expand(B, P, Lp).gather(2, kidx)
        A[:, :, i, :] = torch.where(dg.paths_on[i][None, :, None], row, 0)
    return A


def replay_table_plain(Ar, G, subc, gap, restart, L=None):
    """The per-group table the chain warps of K7 and K8 build
    (``csrc/pathwise_common.cuh``), from the group's rep row ``Ar``
    int32[B, Lp] at the group's pred row: (src, add) int32[B, Lp] such
    that every lane q of the group fills

        row_q[j] = (0 if src[j] < 0 else Aq[src[j]]) + add[j]

    with Aq its own plane (K8: its source plane) at that pred row.
    ``G`` is the read's gap prefix sums (K7) or suffix sums (K8), ``subc``
    sm(code_i, read code at j) (K8: of the reverse read), ``gap`` the
    node's gap, ``restart`` mode 4 (K7) or mode 8 (K8): whether the
    restart column (K7 column 0, K8 column L - 1) reads the pred's value
    there plus the gap, else it restarts at 0.  K8 passes the read
    lengths ``L`` int[B]: its chain runs right to left and its column 0
    and columns past the read are 0 (src -1, add 0)."""
    B, Lp = Ar.shape
    dev = Ar.device
    j = torch.arange(Lp, device=dev).expand(B, Lp)
    u = Ar + gap
    if L is None:                                   # K7: from the left
        d = _shift_right(Ar) + subc
        rcol = torch.zeros((B, 1), dtype=torch.long, device=dev)
        ach = torch.maximum(d, u)
    else:                                           # K8: from the right
        d = torch.roll(Ar, -1, dims=1)
        d[:, -1] = NEG
        d = d + subc
        rcol = (L.to(dev).long() - 1)[:, None]
        ach = torch.where(j < rcol + 1, torch.maximum(d, u), NEG)
    is_r = j == rcol
    ach = torch.where(is_r, u if restart else torch.zeros_like(u), ach)
    x = ach - G
    if L is None:
        row = G + torch.cummax(x, dim=1).values
    else:
        row = G + torch.cummax(x.flip(1), dim=1).values.flip(1)
    isD = ~is_r & (row == d)
    nonL = is_r | isD | (row == u)
    if L is None:                                   # the last non-L column <= j
        k = torch.cummax(torch.where(nonL, j, -1), dim=1).values
    else:                                           # the first non-L column >= j
        k = -torch.cummax(torch.where(nonL, -j, -Lp).flip(1), dim=1).values.flip(1)
    kc = k.clamp(0, Lp - 1)
    kD, kR = isD.gather(1, kc), is_r.gather(1, kc)
    base = G - G.gather(1, kc)
    src = torch.where(kD, kc + (1 if L is not None else -1), kc)
    add = torch.where(kD, subc.gather(1, kc), torch.full_like(Ar, gap)) + base
    src = torch.where(kR, kc if restart else torch.full_like(kc, -1), src)
    add = torch.where(kR, base + (gap if restart else 0), add)
    if L is not None:
        zero = (j == 0) | (j > rcol) | (k >= Lp)
        src = torch.where(zero, -1, src)
        add = torch.where(zero, 0, add)
    return src.to(_I32), add.to(_I32)


def fill_pathwise_best(dg, table, seq, semiglobal):
    """Pathwise fill: the CUDA kernel for CUDA tensors, the plain torch
    version for CPU tensors.  One kernel serves every path count: the
    TPU's path-tiled variant (``pallas_pathwise_bigp``) exists only for
    its VMEM limit."""
    if seq.is_cuda:
        return cuda_pathwise.fill_pathwise_cuda(dg, table, seq, semiglobal)
    return fill_pathwise_plain(dg, table, seq, semiglobal)


# ---------------------------------------------------------------------------
# endings (pathwise_alignment.rs:305-325, ..._semiglobal.rs:244-277)
# ---------------------------------------------------------------------------


def _final_column(A, L):
    """A[:, :, :, L-1] per read -> int32[B, P, n]."""
    B, P, n, _ = A.shape
    idx = (L.long() - 1)[:, None, None, None].expand(B, P, n, 1)
    return A.gather(3, idx)[..., 0]


def _extract_plane(A, best_path):
    """A[b, best_path[b], :, :] -> int32[B, n, W]."""
    return A[torch.arange(A.shape[0], device=A.device), best_path.long()]


def _end_meta(g, device):
    """Per-path sink predecessor and its assigned mask, mirroring the
    final_results_global loop, cached on the graph per device."""
    cache = g.__dict__.setdefault("_torch_end_meta", {})
    meta = cache.get(str(device))
    if meta is None:
        P = g.paths_number
        end_pred = np.zeros(P, dtype=np.int64)
        assigned = np.zeros(P, dtype=bool)
        for pred, paths in g.preds_and_paths(g.n - 1):
            for p in np.flatnonzero(paths):
                end_pred[p] = pred
                assigned[p] = True
        meta = cache[str(device)] = (torch.from_numpy(end_pred).to(device),
                                     torch.from_numpy(assigned).to(device))
    return meta


def _endings_global_dev(finalcol, end_pred, assigned):
    """Mode-4 endings for a batch: (best_path, node, score) int32[B].

    Ties on the per-path result pick the HIGHEST path index (the
    oracle's max over (results[p], p)); unassigned paths keep the
    oracle's literal 0.
    """
    B, P, _ = finalcol.shape
    vals = finalcol.gather(2, end_pred[None, :, None].expand(B, P, 1))[..., 0]
    vals = torch.where(assigned[None, :], vals, 0)
    score = vals.max(1, keepdim=True).values
    pidx = torch.arange(P, device=vals.device)
    best = torch.where(vals == score, pidx, -1).max(1).values
    return best.to(_I32), end_pred[best].to(_I32), score[:, 0].to(_I32)


def _endings_semiglobal_dev(finalcol, on):
    """Mode-5 endings for a batch; ``on`` is bool[P, n].  First-max tie
    order throughout, like the oracle's argmax calls."""
    B, P, n = finalcol.shape
    vals = torch.where(on[None], finalcol, torch.iinfo(_I32).min)
    pnb = vals.max(1).values                               # [B, n]
    pidx = torch.arange(P, device=vals.device)[None, :, None]
    pnp = torch.where(vals == pnb[:, None, :], pidx, P).min(1).values
    inner = pnb[:, 1 : n - 1]
    nidx = torch.arange(1, n - 1, device=vals.device)
    node = torch.where(inner == inner.max(1, keepdim=True).values, nidx, n).min(1).values
    bp = pnp.gather(1, node[:, None])[:, 0]
    score = pnb.gather(1, node[:, None])[:, 0]
    return bp.to(_I32), node.to(_I32), score.to(_I32)


# ---------------------------------------------------------------------------
# on-device traceback (mirrors oracle/pathwise.build_alignment)
# ---------------------------------------------------------------------------


def walk_pathwise(plane, seq, L, table, node_start, codes, pred_of_bp,
                  ending_node, global_mode, max_steps, ws=None, start_j=None):
    """Batched traceback over dense best-path planes.

    plane: int32[B, n, W] absolute scores on the chosen path (W = Lp at
    full width); pred_of_bp: int32[B, n] predecessor row of the chosen
    path per node (-1 where the path does not cover the node — the
    reference's predecessor=None fallback,
    pathwise_alignment_output.rs:31-47).  One step per iteration: the
    main d/u/l recompute walk, then the trailing-L and (global)
    leading-U tails.  Lanes are tested for the end every
    ``CHECK_EVERY`` iterations (a device sync).

    ws (optional, int32[B, n]): per-row window starts of windowed planes
    — column j of row i reads plane[b, i, j - ws[b, i]], NEG outside the
    window.  ``start_j`` (optional, int32[B]): the walk's first column,
    L - 1 by default (the recombination forward walk starts at the split
    column).

    Returns (dirs int32[B, max_steps + 8] with -1 past each walk, rows,
    steps int32[B], stop row int32[B]).
    """
    B, n, W = plane.shape
    dev = plane.device
    pf = plane.reshape(B, n * W)
    s64 = seq.long()
    tab = table.to(dev, _I32)
    ws64 = None if ws is None else ws.long()

    def at(i, j):
        if ws64 is None:
            return pf.gather(1, (i * W + j).clamp(0, n * W - 1)[:, None])[:, 0]
        rel = j - ws64.gather(1, i[:, None])[:, 0]
        v = pf.gather(1, (i * W + rel.clamp(0, W - 1))[:, None])[:, 0]
        return torch.where((rel >= 0) & (rel < W), v, NEG)

    i = ending_node.long()
    j = L.long() - 1 if start_j is None else start_j.long()
    k = torch.zeros(B, dtype=_I32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    dirs = torch.full((B, max_steps + 8), -1, dtype=_I32, device=dev)
    rows = torch.zeros((B, max_steps + 8), dtype=_I32, device=dev)
    it = 0
    while it < max_steps:
        if it % traceback_engine.CHECK_EVERY == 0 and bool(done.all()):
            break
        main = (i > 0) & (j > 0) & ~done
        ltail = (i == 0) & (j > 0) & ~done
        utail = (i > 0) & (j == 0) & ~done if global_mode else torch.zeros_like(done)
        emit = main | ltail | utail

        is_start = node_start[i]
        pred_e = pred_of_bp.gather(1, i[:, None])[:, 0].long()
        covered = pred_e >= 0
        pred = torch.where(is_start & covered, pred_e, i - 1)
        prow = torch.where(is_start, pred_e, i - 1).clamp(min=0)
        code_i = codes[i].long()
        seq_j = s64.gather(1, j[:, None])[:, 0]
        zero_case = is_start & ~covered
        d = torch.where(zero_case, 0, at(prow, j - 1) + tab[code_i, seq_j])
        u = torch.where(zero_case, 0, at(prow, j) + tab[code_i, GAP])
        l_ = torch.where(zero_case, 0, at(i, j - 1) + tab[GAP, seq_j])
        mx = torch.maximum(torch.maximum(d, u), l_)
        is_d = mx == d
        is_u = ~is_d & (mx == u)
        code = torch.where(is_d, torch.where(seq_j == code_i, D, LOW_D),
                           torch.where(is_u, U_DIR, L_DIR))
        code = torch.where(ltail, L_DIR, code)
        code = torch.where(utail, U_DIR, code)
        dirs[:, it] = torch.where(emit, code, -1)
        rows[:, it] = torch.where(emit, i, 0)

        i = torch.where((main & (is_d | is_u)) | utail, pred, i)
        j = torch.where((main & ~is_u) | ltail, j - 1, j)
        k += emit.to(_I32)
        done = done | ~emit
        it += 1
    return dirs, rows, k, i.to(_I32)


# build_cigar's per-char flushing means at most one run counter is ever
# nonzero, so it reduces to run-length encoding over the mapped classes
# (D->M, d->X, L->D, U->I)
_CIG_CLASS = np.array(["?", "M", "X", "D", "I"])


def _walk_meta(g):
    meta = g.__dict__.get("_walk_meta")
    if meta is None:
        ids = np.asarray(g.nodes_id_pos, dtype=np.int64)
        lnz = np.frombuffer(g.lnz.encode("latin1"), dtype=np.uint8)
        meta = g.__dict__["_walk_meta"] = (ids, lnz)
    return meta


def _cigar(d_f):
    """build_cigar of the direction codes ``d_f`` in forward order."""
    if not len(d_f):
        return ""
    cls = _CIG_CLASS[d_f]
    bnd = np.flatnonzero(cls[1:] != cls[:-1])
    starts = np.concatenate(([0], bnd + 1))
    ends = np.concatenate((bnd + 1, [len(d_f)]))
    return "".join(f"{e - s}{cls[s]}" for s, e in zip(starts, ends))


def _record_from_walk(dirs, rows, n_steps, stop_i, g, bp, ending_node, score):
    """The GAF fields build_alignment would give for this walk
    (oracle/pathwise.py, vectorised, byte-identical output): (path,
    path_length, path_start, path_end, comments)."""
    ids, lnz = _walk_meta(g)
    # forward order = reversed walk
    d_f = np.asarray(dirs[:n_steps])[::-1]
    r_f = np.asarray(rows[:n_steps])[::-1]
    cigar_str = _cigar(d_f)
    on_node = (d_f == 1) | (d_f == 2) | (d_f == 4)
    sel = r_f[on_node]                                     # path order
    path_length = int(on_node.sum())
    h = ids[sel]
    if len(h):
        keep = np.empty(len(h), dtype=bool)
        keep[-1] = True
        # dedup is over the WALK order (reverse of path order)
        keep[:-1] = h[1:] != h[:-1]
        handle_dedup = [int(x) for x in h[keep]]
    else:
        handle_dedup = []
    path_seq = lnz[sel].tobytes().decode("latin1")
    path_len, path_start, path_end = get_path_len_start_end(
        ids, stop_i if stop_i == 0 else stop_i + 1, ending_node, path_length
    )
    comments = f"{cigar_str}, best path: {bp}, score: {score}\t{path_seq}"
    return handle_dedup, path_len, path_start, path_end, comments


def _gaf_from_walk(dirs_b, rows_b, steps_b, stop_b, g, bp, node, score, s):
    handle_dedup, path_len, path_start, path_end, comments = _record_from_walk(
        dirs_b, rows_b, steps_b, stop_b, g, bp, node, score
    )
    return GafRecord(
        query_name="Temp",
        query_length=len(s) - 1,
        query_start=0,
        query_end=len(s) - 2,
        strand="+",
        path=handle_dedup,
        path_length=path_len,
        path_start=path_start,
        path_end=path_end,
        residue_matches_number=0,
        alignment_block_length="*",
        mapping_quality="*",
        comments=comments,
    )


def _walk_and_fetch(planes, seq, L, table, dg, bp, node, global_mode, max_steps, ws=None,
                    start_j=None):
    """One walk loop over a batch of best-path planes, fetched to the
    host: (dirs, rows int32[B, k] numpy, steps, stop rows)."""
    pred_of_bp = dg.pred_of.t()[bp.long()]                 # [B, n]
    with phase("walk"):
        walk = walk_pathwise(planes, seq, L, table, dg.node_start, dg.codes, pred_of_bp,
                             node, global_mode, max_steps, ws=ws, start_j=start_j)
    return fetch_walk(*walk, max_steps)


def fetch_walk(dirs, rows, steps, stop_i, max_steps):
    """A walk's outputs to the host, packed: (dirs, rows int32[B, k]
    numpy, steps, stop rows)."""
    with phase("device_wait"):
        kmax = min(max_steps, (int(steps.max()) + 63) // 64 * 64)
    with phase("fetch"):
        pk = traceback_engine.pack_walk32(dirs[:, :kmax], rows[:, :kmax]).cpu().numpy()
        steps, stop_i = steps.cpu().numpy(), stop_i.cpu().numpy()
    dirs, rows = traceback_engine.unpack_walk(pk)
    return dirs, rows, steps, stop_i


def _rescore_walk(dirs_b, rows_b, ns, j0, codes, seqc, table, nstart, covered) -> int:
    """Exact, plane-independent score of an emitted forward walk
    (``_rescore_walk``, JAX ``pathwise_engine.py:532-563``): the sum of
    its per-step increments down to the first zero-case restart cell (a
    node start whose chosen path has no covered predecessor) or its end.
    On rep lanes it equals the plane value the walk started from; on
    follower lanes the replayed values need not telescope along the
    recomputed walk, so the windowed mode-8 route uses a mismatch only
    as a conservative refusal (the read goes up the W ladder), never as
    proof of a wrong record.  Host numpy."""
    s = 0
    j = int(j0)
    for k in range(int(ns)):
        i = int(rows_b[k])
        c = int(dirs_b[k])
        if i > 0 and j > 0 and nstart[i] and not covered[i]:
            return s
        if c in (1, 2):
            s += int(table[codes[i], seqc[j]])
            j -= 1
        elif c == 4:
            s += int(table[codes[i], GAP])
        else:
            s += int(table[GAP, seqc[j]])
            j -= 1
    return s


# ---------------------------------------------------------------------------
# batch driver
# ---------------------------------------------------------------------------


# the window width at which every read of the last ladder passed, per
# graph (_graph_hint_key): the next ladder on that graph starts there
_pw_w_hint: dict[tuple, int] = {}


def _graph_hint_key(g, dg) -> tuple:
    """Settled-window-hint key: the graph's identity (rows, paths and
    its bases), independent of scoring."""
    return (dg.n, dg.paths_number, hash(np.asarray(g.codes).tobytes()))


def _fits(Lp_all: int, table) -> bool:
    """The JAX package's packed-chain gate (2 * Lp * max|score| < 2^16),
    kept as its routing rule for the windowed engine."""
    return 2 * Lp_all * int(np.abs(np.asarray(table)).max()) < (1 << 16)


def run_batch_walks(mode, sequences, g, sm, device, chunk_bytes=None) -> list[GafRecord]:
    """Modes 4/5 with on-device traceback (planes never leave the device).

    Mode-4 batches with long reads route through the windowed O(W)-lane
    fill (``pathwise_window``); mode 5 has no windowed variant (a
    semiglobal alignment may start at column 0 of any row, which makes
    the exit bound vacuous).  Fill chunks hold ``chunk_bytes`` (default
    ``CHUNK_BYTES[device]``) of score planes; the last chunk holds what
    is left, unpadded.
    """
    if mode not in (4, 5):
        raise ValueError(f"pathwise modes are 4 and 5, got {mode}")
    device = torch.device(device)
    if chunk_bytes is None:
        chunk_bytes = CHUNK_BYTES[device.type]
    dg = path_device_graph(g, device)
    table = torch.as_tensor(sm.table, dtype=_I32).to(device)
    semiglobal = mode == 5
    Lp_all = max(len(s) for s in sequences)
    if not semiglobal and Lp_all >= LONG_READ_LP and _fits(Lp_all, sm.table):
        return _run_batch_walks_win(sequences, g, dg, table, device, chunk_bytes)
    return _run_batch_walks_full(sequences, g, dg, table, semiglobal, device, chunk_bytes)


def _run_batch_walks_full(sequences, g, dg, table, semiglobal, device,
                          chunk_bytes) -> list[GafRecord]:
    """Full-width fill per chunk; endings and the best path's plane stay
    on the device, and one walk loop serves every chunk that fits the
    walk budget (``WALK_BYTES``)."""
    n, P = dg.n, dg.paths_number
    Lp_all = max(len(s) for s in sequences)
    Lp = (Lp_all + 7) // 8 * 8
    chunk = max(1, chunk_bytes // (P * n * Lp * 4))
    walk_batch = max(1, WALK_BYTES[device.type] // (n * Lp * 4))
    max_steps = n + Lp + 4
    records: list[GafRecord] = []
    pend: list = []   # (chunk seqs, seq, L, planes, bp, node, score)

    def flush():
        if not pend:
            return
        seqs_h = [s for t in pend for s in t[0]]
        seq, L, planes, bp, node, score = (
            torch.cat([t[k] for t in pend]) if len(pend) > 1 else pend[0][k]
            for k in range(1, 7)
        )
        pend.clear()
        dirs, rows, steps, stop_i = _walk_and_fetch(
            planes, seq, L, table, dg, bp, node, not semiglobal, max_steps)
        del planes
        bps, nodes, scores = (t.cpu().numpy() for t in (bp, node, score))
        with phase("emit"):
            for b, s in enumerate(seqs_h):
                records.append(_gaf_from_walk(
                    dirs[b], rows[b], int(steps[b]), int(stop_i[b]), g,
                    int(bps[b]), int(nodes[b]), int(scores[b]), s))

    pend_reads = 0
    for c0 in range(0, len(sequences), chunk):
        chunk_seqs = sequences[c0 : c0 + chunk]
        with phase("encode"):
            seq, L = encode_reads(chunk_seqs, pad_to=Lp_all, device=device)
        with phase("fill"):
            A = fill_pathwise_best(dg, table, seq, semiglobal)
        with phase("dispatch"):
            fc = _final_column(A, L)
            if semiglobal:
                bp, node, score = _endings_semiglobal_dev(fc, dg.paths_on.t())
            else:
                bp, node, score = _endings_global_dev(fc, *_end_meta(g, device))
            planes = _extract_plane(A, bp)
        del A, fc
        pend.append((chunk_seqs, seq, L, planes, bp, node, score))
        pend_reads += len(chunk_seqs)
        if pend_reads + chunk > walk_batch:
            flush()
            pend_reads = 0
    flush()
    return records


def _run_batch_walks_win(sequences, g, dg, table, device, chunk_bytes) -> list[GafRecord]:
    """Mode-4 long reads: windowed O(W)-lane fill with a W ladder.

    Per chunk, fills at width W (starting from the last width that
    worked for this graph), accepts every read whose windowed best
    final STRICTLY beats the exit bound (the guard of
    ``pathwise_window.fill_pathwise_win_plain``: every cell an optimal
    traceback can visit or tie into is then exact), and doubles W for
    the rest, re-chunked at every rung.  The passing reads' best-path
    planes wait, per W, for one walk loop over every chunk that fits
    ``WALK_BYTES`` (the JAX engine walks each pass on its own; a loop
    costs about n + L host-driven steps at any batch).  Reads still
    failing at W >= Lp rerun through the exact full-width fill, which is
    the algorithm's own path: a stderr line says so and
    ``metrics.EVENTS["pathwise_win_fullwidth"]`` counts the reads.
    """
    n, P = dg.n, dg.paths_number
    rmin = pathwise_window.rmin_tensor(dg)
    end_meta = _end_meta(g, device)
    Lp_all = max(len(s) for s in sequences)
    hint_key = _graph_hint_key(g, dg)
    W0 = _pw_w_hint.get(hint_key, 256)
    if W0 >= Lp_all:   # a hint from a longer-read batch
        W0 = 256
    max_steps = n + Lp_all + 4
    out: dict[int, GafRecord] = {}
    pend: dict[int, list] = {}   # W -> [(idxs, seq, L, planes, ws, bp, node, score)]

    def flush(W):
        items = pend.pop(W, [])
        if not items:
            return
        idxs = [i for t in items for i in t[0]]
        seq, L, planes, ws, bp, node, score = (
            torch.cat([t[k] for t in items]) for k in range(1, 8))
        dirs, rows, steps, stop_i = _walk_and_fetch(
            planes, seq, L, table, dg, bp, node, True, max_steps, ws=ws)
        del planes
        bps, nodes, scores = (t.cpu().numpy() for t in (bp, node, score))
        with phase("emit"):
            for b, i in enumerate(idxs):
                out[i] = _gaf_from_walk(dirs[b], rows[b], int(steps[b]), int(stop_i[b]), g,
                                        int(bps[b]), int(nodes[b]), int(scores[b]),
                                        sequences[i])

    def win_pass(idxs, W):
        """One fill + guard pass at width W; queues the passing reads for
        the walk and returns the failed idxs."""
        with phase("encode"):
            seq, L = encode_reads([sequences[i] for i in idxs], pad_to=Lp_all, device=device)
        with phase("fill"):
            Aw, ws, bound = pathwise_window.fill_pathwise_win_best(dg, table, seq, L, W, rmin)
        with phase("dispatch"):
            fcw = pathwise_window._final_column_win(Aw, ws, L)
            bp, node, score = _endings_global_dev(fcw, *end_meta)
        with phase("device_wait"):
            passed = (score > bound).cpu().numpy()
        ok = np.flatnonzero(passed)
        if len(ok):
            with phase("dispatch"):
                sel = torch.from_numpy(ok).to(device)
                item = ([idxs[b] for b in ok], seq[sel], L[sel], Aw[sel, bp[sel].long()],
                        ws[sel], bp[sel], node[sel], score[sel])
            del Aw
            pend.setdefault(W, []).append(item)
            if sum(len(t[0]) for t in pend[W]) * n * W * 4 >= WALK_BYTES[device.type]:
                flush(W)
        return [i for b, i in enumerate(idxs) if not passed[b]]

    fullwidth_idx: list[int] = []
    # chunk on the expected ladder width, re-chunk at every rung: W can
    # double to ~Lp/2, where a chunk sized for W0 would pass the budget
    chunk = max(1, chunk_bytes // (P * n * min(2 * W0, Lp_all) * 4))
    for c0 in range(0, len(sequences), chunk):
        idxs = list(range(c0, min(c0 + chunk, len(sequences))))
        W = W0
        while idxs and W < Lp_all:
            rung = max(1, chunk_bytes // (P * n * W * 4))
            failed: list[int] = []
            for s0 in range(0, len(idxs), rung):
                failed.extend(win_pass(idxs[s0 : s0 + rung], W))
            idxs = failed
            if not idxs:
                _pw_w_hint[hint_key] = W
            W *= 2
        fullwidth_idx.extend(idxs)
    for W in sorted(pend):
        flush(W)
    if fullwidth_idx:
        metrics.EVENTS["pathwise_win_fullwidth"] += len(fullwidth_idx)
        print(
            f"recgraph: {len(fullwidth_idx)} long read(s) exceeded the "
            "windowed exit bound at every W; running full-width",
            file=sys.stderr,
        )
        sub = [sequences[i] for i in fullwidth_idx]
        recs = _run_batch_walks_full(sub, g, dg, table, False, device, chunk_bytes)
        for i, rec in zip(fullwidth_idx, recs):
            out[i] = rec
    return [out[i] for i in range(len(sequences))]
