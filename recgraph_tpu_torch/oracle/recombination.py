"""Oracle for recombination modes 8 (global) and 9 (semiglobal).

Copy of ``recgraph_tpu/oracle/recombination.py``.  It backs the
pipeline's ``engine="oracle"`` for modes 8/9 and supplies the record
helpers of the batched engine (``get_node_offset``,
``get_rec_path_len_start_end``, ``_fmt_f32``).  Literal ports of the
reference's src/pathwise_alignment_recombination.rs and
src/recombination_output.rs:

- forward DP  = the mode-4/5 pathwise fill (align, :436-745)
- reverse DP  = the same recurrences on the reverse graph, filled from
  (n-1, L-1) towards (1, 1) with a shifted sequence (rev_align,
  :129-435; get_rev_sequence :875-883)
- both matrices converted to absolute scores (:747-757) — with the
  preserved quirk that row n-1 of the *reverse* matrix stays in delta
  form (absolute_scores stops at len-1).
- best_alignment (:759-873): baseline no-recombination score, then a
  displacement-penalised split search over (forward node, reverse node)
  pairs within the recombination column band, with the `onedge`
  tie-preference for splits at node boundaries.
"""

from __future__ import annotations

import numpy as np

from ..graph.pathgraph import PathGraph
from ..io.gaf import GafRecord
from ..scoring import ScoreMatrix
from . import pathwise
from .gaf_emit import build_cigar
from .pathwise import get_path_len_start_end


def get_rev_sequence(seq: str) -> str:
    """Mirrors get_rev_sequence (:875-883): drop '$', append 'F'."""
    return seq[1:] + "F"


def get_node_offset(nodes_handles: np.ndarray, curr_node: int) -> int:
    """Mirrors get_node_offset (:9-22)."""
    handle = nodes_handles[curr_node]
    if handle == 0:
        return 0
    counter = curr_node
    offset = 0
    while nodes_handles[counter - 1] == handle:
        counter -= 1
        offset += 1
    return offset


def align(aln_mode: int, seq: str, g: PathGraph, sm: ScoreMatrix) -> np.ndarray:
    """Forward DP -> absolute matrix; mirrors align (:436-745)."""
    dpm = pathwise.fill(seq, g, sm, semiglobal=(aln_mode == 9))
    return pathwise.absolute(dpm, g)


def rev_align(
    aln_mode: int, rev_seq: str, rg: PathGraph, sm: ScoreMatrix
) -> np.ndarray:
    """Reverse DP -> absolute matrix; mirrors rev_align (:129-435).

    ``rg`` is the reverse graph (successor hash); cells are filled from
    bottom-right to top-left; column 0 is never written.
    """
    lnz = rg.lnz
    n = rg.n
    L = len(rev_seq)
    P = rg.paths_number
    alphas = rg.alphas
    pn = rg.paths_nodes
    dpm = np.zeros((n, L, P), dtype=np.int64)

    for i in range(n - 1, 0, -1):
        gap_i = sm.get(lnz[i], "-") if i < n - 1 else 0
        for j in range(L - 1, 0, -1):
            if i == n - 1 and j == L - 1:
                continue
            if i == n - 1:
                ai = alphas[i]
                dpm[i, j, ai] = dpm[i, j + 1, ai] + sm.get(rev_seq[j], "-")
                dpm[i, j, ai + 1 :] = dpm[i, j + 1, ai + 1 :]
            elif j == L - 1:
                if aln_mode == 9:
                    continue
                _rev_fill_last_col(dpm, rg, i, gap_i)
            else:
                sub = sm.get(lnz[i], rev_seq[j])
                gap_j = sm.get(rev_seq[j], "-")
                if not rg.node_start[i]:
                    common = pn[i] & pn[i + 1]
                    ai, ap = alphas[i], alphas[i + 1]
                    if common[ap]:
                        u = dpm[i + 1, j, ap] + gap_i
                        d = dpm[i + 1, j + 1, ap] + sub
                        l = dpm[i, j + 1, ai] + gap_j
                        mx = max(d, u, l)
                        dpm[i, j, ai] = mx
                        mask = common.copy()
                        mask[ai] = False
                        if mx == d:
                            dpm[i, j, mask] = dpm[i + 1, j + 1, mask]
                        elif mx == u:
                            dpm[i, j, mask] = dpm[i + 1, j, mask]
                        else:
                            dpm[i, j, mask] = dpm[i, j + 1, mask]
                    else:
                        u = dpm[i + 1, j, ap] + dpm[i + 1, j, ai] + gap_i
                        d = dpm[i + 1, j + 1, ap] + dpm[i + 1, j + 1, ai] + sub
                        l = dpm[i, j + 1, ai] + gap_j
                        mx = max(d, u, l)
                        dpm[i, j, ai] = mx
                        mask = common.copy()
                        mask[ai] = False
                        if mx == d:
                            dpm[i, j, mask] = (
                                dpm[i + 1, j + 1, mask] - dpm[i + 1, j + 1, ai]
                            )
                        elif mx == u:
                            dpm[i, j, mask] = dpm[i + 1, j, mask] - dpm[i + 1, j, ai]
                        else:
                            dpm[i, j, mask] = dpm[i, j + 1, mask]
                else:
                    _rev_fill_node_start(dpm, rg, i, j, sub, gap_i, gap_j)
    return _absolute_rev(dpm, rg)


def _rev_fill_last_col(dpm: np.ndarray, rg: PathGraph, i: int, gap_i: int) -> None:
    """j == L-1 column, mode 8 (rev_align :156-255)."""
    alphas, pn = rg.alphas, rg.paths_nodes
    ai = alphas[i]
    j = dpm.shape[1] - 1
    if not rg.node_start[i]:
        common = pn[i] & pn[i + 1]
        ap = alphas[i + 1]
        if common[ap]:
            mask = common.copy()
            mask[ai] = False
            dpm[i, j, ai] = dpm[i + 1, j, ai] + gap_i
            dpm[i, j, mask] = dpm[i + 1, j, mask]
        else:
            dpm[i, j, ai] = dpm[i + 1, j, ai] + dpm[i + 1, j, ap] + gap_i
            mask = common.copy()
            mask[ai] = False
            dpm[i, j, mask] = dpm[i + 1, j, mask] - dpm[i + 1, j, ai]
    else:
        alphas_deltas: dict[int, np.ndarray] = {}
        for p, p_paths in rg.preds_and_paths(i):
            common = pn[i] & p_paths
            if not common.any():
                raise RuntimeError("empty common-paths set")
            ap = alphas[p]
            if ap < rg.paths_number and common[ap]:
                alphas_deltas[ap] = common
                dpm[i, j, ap] = dpm[p, j, ap] + gap_i
                mask = common.copy()
                mask[ap] = False
                dpm[i, j, mask] = dpm[p, j, mask]
            else:
                ta = ai if common[ai] else int(np.flatnonzero(common)[0])
                alphas_deltas[ta] = common
                dpm[i, j, ta] = dpm[p, j, ap] + dpm[p, j, ta] + gap_i
                mask = common.copy()
                mask[ta] = False
                dpm[i, j, mask] = dpm[p, j, mask] - dpm[p, j, ta]
        pathwise._remove_multiple_alphas(dpm, i, j, ai, alphas_deltas)


def _rev_fill_node_start(
    dpm: np.ndarray, rg: PathGraph, i: int, j: int, sub: int, gap_i: int, gap_j: int
) -> None:
    """Interior nwp branch of rev_align (:311-428)."""
    alphas, pn = rg.alphas, rg.paths_nodes
    ai = alphas[i]
    alphas_deltas: dict[int, np.ndarray] = {}
    for p, p_paths in rg.preds_and_paths(i):
        common = pn[i] & p_paths
        if not common.any():
            raise RuntimeError("empty common-paths set")
        ap = alphas[p]
        if ap < rg.paths_number and common[ap]:
            alphas_deltas[ap] = common
            u = dpm[p, j, ap] + gap_i
            d = dpm[p, j + 1, ap] + sub
            if ai == ap:
                l = dpm[i, j + 1, ap] + gap_j
            else:
                l = dpm[i, j + 1, ap] + dpm[i, j + 1, ai] + gap_j
            mx = max(d, u, l)
            dpm[i, j, ap] = mx
            mask = common.copy()
            mask[ap] = False
            if mx == d:
                dpm[i, j, mask] = dpm[p, j + 1, mask]
            elif mx == u:
                dpm[i, j, mask] = dpm[p, j, mask]
            else:
                if ap == ai:
                    dpm[i, j, mask] = dpm[i, j + 1, mask]
                else:
                    dpm[i, j, mask] = dpm[i, j + 1, mask] - dpm[i, j + 1, ap]
        else:
            ta = ai if common[ai] else int(np.flatnonzero(common)[0])
            alphas_deltas[ta] = common
            u = dpm[p, j, ap] + dpm[p, j, ta] + gap_i
            d = dpm[p, j + 1, ap] + dpm[p, j + 1, ta] + sub
            if ai == ta:
                l = dpm[i, j + 1, ta] + gap_j
            else:
                l = dpm[i, j + 1, ta] + dpm[i, j + 1, ai] + gap_j
            mx = max(d, u, l)
            dpm[i, j, ta] = mx
            mask = common.copy()
            mask[ta] = False
            if mx == d:
                dpm[i, j, mask] = dpm[p, j + 1, mask] - dpm[p, j + 1, ta]
            elif mx == u:
                dpm[i, j, mask] = dpm[p, j, mask] - dpm[p, j, ta]
            else:
                if ta == ai:
                    dpm[i, j, mask] = dpm[i, j + 1, mask]
                else:
                    dpm[i, j, mask] = dpm[i, j + 1, mask] - dpm[i, j + 1, ta]
    pathwise._remove_multiple_alphas(dpm, i, j, ai, alphas_deltas)


def _absolute_rev(dpm: np.ndarray, rg: PathGraph) -> np.ndarray:
    """absolute_scores over rows 0..n-2 — row n-1 stays delta (quirk)."""
    return pathwise.absolute(dpm, rg)


# -- split search -------------------------------------------------------------


def best_alignment(
    m: np.ndarray,
    w: np.ndarray,
    dms: np.ndarray,
    brc: int,
    mrc: float,
    aln_mode: int,
    g: PathGraph,
    rbw: float,
) -> tuple[int, int, int, int, int, tuple[float, int]]:
    """Mirrors best_alignment (:759-873), vectorised per column.

    Sequential-scan semantics preserved: the winner is the candidate
    with maximum (f32) score; among equal-score candidates, the first
    *onedge* one in (j, i, rev_i) scan order if any exists after a
    non-onedge leader, else the first in scan order.
    """
    n, L, P = m.shape
    nodes_path = g.paths_nodes
    nodes_id_pos = g.nodes_id_pos

    # baseline: best no-recombination score (:777-800)
    if aln_mode == 8:
        mx = None
        best_path = None
        for pred, paths in g.preds_and_paths(n - 1):
            for path in np.flatnonzero(paths):
                v = m[pred, L - 1, path]
                if mx is None or mx < v:
                    mx = v
                    best_path = int(path)
    else:
        mx = None
        best_path = None
        for i in range(n - 1):
            for path in range(P):
                if nodes_path[i, path]:
                    v = m[i, L - 1, path]
                    if mx is None or mx < v:
                        mx = v
                        best_path = int(path)
    curr_best = np.float32(mx)
    fen = rsn = rec_col = 0
    fp = rp = best_path
    onedge_state = False
    rec_penalty = 0

    out_of_band = max(int(L * (1.0 - rbw) / 2.0), 1)
    ids = nodes_id_pos
    interior = np.arange(1, n - 1)
    # onedge components (":845-852"): forward split at node end,
    # reverse split at node start
    fw_edge = ids[interior] != ids[interior + 1]
    rv_edge = ids[interior] != ids[interior - 1]
    onedge_mat = fw_edge[:, None] & rv_edge[None, :]
    diff_node = ids[interior][:, None] != ids[interior][None, :]
    penalty_base = np.float32(brc) + (
        np.float32(mrc) * dms[1 : n - 1, 1 : n - 1].astype(np.float32)
    )

    for j in range(out_of_band, L - out_of_band):
        # per-node argmax path over ALL P entries; tuple max -> larger
        # path id wins ties (:809-830)
        forw_paths = (P - 1) - np.argmax(m[:, j, ::-1], axis=-1)
        rev_paths = (P - 1) - np.argmax(w[:, j, ::-1], axis=-1)
        fpj = forw_paths[interior]
        rpj = rev_paths[interior]
        valid_f = nodes_path[interior, fpj]
        valid_r = nodes_path[interior, rpj]
        mvals = m[interior, j, fpj].astype(np.float32)
        wvals = w[interior, j, rpj].astype(np.float32)
        cand = mvals[:, None] + wvals[None, :] - penalty_base
        valid = (
            diff_node
            & (fpj[:, None] != rpj[None, :])
            & valid_f[:, None]
            & valid_r[None, :]
        )
        if not valid.any():
            continue
        neg = np.float32(-np.inf)
        cand_v = np.where(valid, cand, neg)
        col_max = cand_v.max()
        if col_max < curr_best:
            continue
        at_max = (cand_v == col_max)
        at_max_edge = at_max & onedge_mat
        if col_max > curr_best:
            take = True
            if at_max_edge.any():
                flat = int(np.argmax(at_max_edge))
                is_edge = True
            else:
                flat = int(np.argmax(at_max))
                is_edge = False
        else:  # equal: only a first onedge candidate can displace (:844-848)
            if onedge_state or not at_max_edge.any():
                continue
            take = True
            flat = int(np.argmax(at_max_edge))
            is_edge = True
        if take:
            ii, kk = divmod(flat, n - 2)
            i_pos = int(interior[ii])
            k_pos = int(interior[kk])
            curr_best = np.float32(cand_v[ii, kk])
            onedge_state = is_edge
            fen, rsn = i_pos, k_pos
            fp, rp = int(fpj[ii]), int(rpj[kk])
            rec_col = j
            rec_penalty = int(dms[i_pos, k_pos])
    return fen, rsn, fp, rp, rec_col, (float(curr_best), rec_penalty)


def ending_node(dpm: np.ndarray, best_path: int, g: PathGraph) -> int:
    """Mirrors ending_node (:885-897): first max over covered nodes."""
    best_score = None
    best_node = 0
    last = dpm.shape[1] - 1
    for i in range(1, g.n - 1):
        if g.paths_nodes[i, best_path]:
            if best_score is None or dpm[i, last, best_path] > best_score:
                best_score = dpm[i, last, best_path]
                best_node = i
    return best_node


# -- traceback emitters --------------------------------------------------------


def _trace_forward(
    dpm: np.ndarray,
    g: PathGraph,
    seq: str,
    sm: ScoreMatrix,
    best_path: int,
    start_i: int,
    start_j: int,
):
    """Forward traceback from (start_i, start_j) down to row/col 0.

    Shared body of the four emitters (recombination_output.rs:108-163,
    :259-315, :480-536, :659-715); dpm is absolute so no alpha terms.
    ``dpm`` may be the full [n, L, P] absolute matrix or a 2-D [n, L]
    plane already sliced at ``best_path`` (device path).
    """
    if dpm.ndim == 3:
        dpm = dpm[:, :, best_path]
    lnz = g.lnz
    nwp = g.node_start
    ids = g.nodes_id_pos
    i, j = start_i, start_j
    cigar: list[str] = []
    handles: list[int] = []
    path_seq: list[str] = []
    path_length = 0
    while i > 0 and j > 0:
        predecessor = None
        if not nwp[i]:
            d = int(dpm[i - 1, j - 1]) + sm.get(lnz[i], seq[j])
            u = int(dpm[i - 1, j]) + sm.get(lnz[i], "-")
            l = int(dpm[i, j - 1]) + sm.get("-", seq[j])
        else:
            d = u = l = 0
            for pred, paths in g.preds_and_paths(i):
                if paths[best_path]:
                    predecessor = pred
                    d = int(dpm[pred, j - 1]) + sm.get(lnz[i], seq[j])
                    u = int(dpm[pred, j]) + sm.get(lnz[i], "-")
                    l = int(dpm[i, j - 1]) + sm.get("-", seq[j])
        mx = max(d, u, l)
        if mx == d:
            cigar.append("D" if lnz[i] == seq[j] else "d")
            handles.append(int(ids[i]))
            path_seq.append(lnz[i])
            i = (i - 1) if predecessor is None else predecessor
            j -= 1
            path_length += 1
        elif mx == u:
            cigar.append("U")
            handles.append(int(ids[i]))
            path_seq.append(lnz[i])
            i = (i - 1) if predecessor is None else predecessor
            path_length += 1
        else:
            cigar.append("L")
            j -= 1
    while j > 0:
        cigar.append("L")
        j -= 1
    return i, cigar, handles, path_seq, path_length


def _trace_forward_global_tail(
    g: PathGraph, best_path: int, i: int, cigar, handles, path_seq, path_length
):
    """Leading-U tail to the source (recombination_output.rs:538-557,717-736)."""
    ids = g.nodes_id_pos
    while i > 0:
        cigar.append("U")
        handles.append(int(ids[i]))
        path_seq.append(g.lnz[i])
        predecessor = None
        if g.node_start[i]:
            for pred, paths in g.preds_and_paths(i):
                if paths[best_path]:
                    predecessor = pred
        i = (i - 1) if predecessor is None else predecessor
        path_length += 1
    return i, path_length


def _trace_reverse(
    rev_dpm: np.ndarray,
    g: PathGraph,
    rg: PathGraph,
    seq: str,
    sm: ScoreMatrix,
    rev_best_path: int,
    start_i: int,
    start_j: int,
):
    """Reverse-matrix traceback from the split point towards the sinks.

    Mirrors recombination_output.rs:39-98 / :389-449.  ``rev_dpm`` may
    be 3-D absolute or a 2-D plane sliced at ``rev_best_path``.
    """
    if rev_dpm.ndim == 3:
        rev_dpm = rev_dpm[:, :, rev_best_path]
    lnz = g.lnz
    ids = g.nodes_id_pos
    n, L = rev_dpm.shape[0], rev_dpm.shape[1]
    r_seq = get_rev_sequence(seq)
    i, j = start_i, start_j
    cigar: list[str] = []
    handles: list[int] = []
    path_seq: list[str] = []
    rev_path_length = 0
    rev_ending_node = i
    while 0 < i < n - 1 and j < L - 1:
        predecessor = None
        if not rg.node_start[i]:
            d = int(rev_dpm[i + 1, j + 1]) + sm.get(lnz[i], r_seq[j])
            u = int(rev_dpm[i + 1, j]) + sm.get(lnz[i], "-")
            l = int(rev_dpm[i, j + 1]) + sm.get("-", r_seq[j])
        else:
            d = u = l = 0
            for pred, paths in rg.preds_and_paths(i):
                if paths[rev_best_path]:
                    predecessor = pred
                    d = int(rev_dpm[pred, j + 1]) + sm.get(lnz[i], r_seq[j])
                    u = int(rev_dpm[pred, j]) + sm.get(lnz[i], "-")
                    l = int(rev_dpm[i, j + 1]) + sm.get("-", r_seq[j])
        mx = max(d, u, l)
        rev_ending_node = i
        if mx == d:
            cigar.append("D" if lnz[i] == r_seq[j] else "d")
            handles.append(int(ids[i]))
            path_seq.append(lnz[i])
            i = (i + 1) if predecessor is None else predecessor
            j += 1
            rev_path_length += 1
        elif mx == u:
            cigar.append("U")
            handles.append(int(ids[i]))
            path_seq.append(lnz[i])
            i = (i + 1) if predecessor is None else predecessor
            rev_path_length += 1
        else:
            cigar.append("L")
            j += 1
    while j < L - 1:
        cigar.append("L")
        j += 1
    return i, cigar, handles, path_seq, rev_path_length, rev_ending_node


def get_rec_path_len_start_end(
    ids: np.ndarray,
    fen: int,
    rsn: int,
    start: int,
    end: int,
    forw_path_length: int,
    rev_path_length: int,
) -> tuple[int, int, int]:
    """Mirrors utils::get_rec_path_len_start_end (utils.rs:256-323)."""
    path_start = 0
    if start > 0:
        first_node_id = ids[start]
        counter = start - 1
        while counter > 0 and ids[counter] == first_node_id:
            counter -= 1
            path_start += 1
    forw_path_end = path_start + forw_path_length - 1 if forw_path_length > 0 else 0
    forw_end_offset = 0
    if fen > 0:
        last_node_id = ids[fen]
        counter = fen + 1
        while counter < len(ids) - 1 and ids[counter] == last_node_id:
            counter += 1
            forw_end_offset += 1
    forw_path_len = forw_path_end + forw_end_offset + 1

    rev_path_start = 0
    if rsn > 0:
        first_node_id = ids[rsn]
        counter = rsn - 1
        while counter > 0 and ids[counter] == first_node_id:
            counter -= 1
            rev_path_start += 1
    rev_path_end = rev_path_start + rev_path_length - 1 if rev_path_length > 0 else 0
    path_end = forw_path_len + rev_path_end
    end_offset = 0
    if end > 0:
        last_node_id = ids[end]
        counter = end + 1
        while counter < len(ids) - 1 and ids[counter] == last_node_id:
            counter += 1
            end_offset += 1
    rev_path_len = rev_path_end + end_offset + 1
    return forw_path_len + rev_path_len, path_start, path_end


def _gaf_no_rec(
    dpm: np.ndarray,
    g: PathGraph,
    seq: str,
    sm: ScoreMatrix,
    best_path: int,
    end_node: int,
    global_tail: bool,
) -> GafRecord:
    """gaf_output_{global,semiglobal}_no_rec (recombination_output.rs:239-361,633-782)."""
    if dpm.ndim == 3:
        dpm = dpm[:, :, best_path]
    L = dpm.shape[1]
    score = int(dpm[end_node, L - 1])
    i, cigar, handles, path_seq, path_length = _trace_forward(
        dpm, g, seq, sm, best_path, end_node, L - 1
    )
    if global_tail:
        i, path_length = _trace_forward_global_tail(
            g, best_path, i, cigar, handles, path_seq, path_length
        )
    cigar.reverse()
    path_seq.reverse()
    handles_d: list[int] = []
    for h in handles:
        if not handles_d or handles_d[-1] != h:
            handles_d.append(h)
    handles_d.reverse()
    path_len, path_start, path_end = get_path_len_start_end(
        g.nodes_id_pos, i if i == 0 else i + 1, end_node, path_length
    )
    comments = (
        f"{build_cigar(cigar)}, best path: {best_path}, score: {score}"
        f"\t{''.join(path_seq)}"
    )
    return GafRecord(
        query_name="Temp",
        query_length=L - 1,
        query_start=0,
        query_end=L - 2,
        strand="+",
        path=handles_d,
        path_length=path_len,
        path_start=path_start,
        path_end=path_end,
        residue_matches_number=0,
        alignment_block_length="*",
        mapping_quality="*",
        comments=comments,
    )


def _gaf_rec(
    dpm: np.ndarray,
    rev_dpm: np.ndarray,
    g: PathGraph,
    rg: PathGraph,
    seq: str,
    sm: ScoreMatrix,
    best_path: int,
    rev_best_path: int,
    fen: int,
    rsn: int,
    rec_col: int,
    best_score: tuple[float, int],
    global_mode: bool,
) -> GafRecord:
    """gaf_output_{global,semiglobal}_rec (recombination_output.rs:12-237,363-631)."""
    ids = g.nodes_id_pos
    if dpm.ndim == 3:
        dpm = dpm[:, :, best_path]
    if rev_dpm.ndim == 3:
        rev_dpm = rev_dpm[:, :, rev_best_path]
    n, L = dpm.shape[0], dpm.shape[1]
    (
        i_rev,
        cigar,
        handles,
        path_seq,
        rev_path_length,
        rev_ending_node,
    ) = _trace_reverse(rev_dpm, g, rg, seq, sm, rev_best_path, rsn, rec_col)
    if global_mode:
        # trailing-U to the sinks (recombination_output.rs:451-470)
        i = i_rev
        while i < n - 1:
            cigar.append("U")
            handles.append(int(ids[i]))
            path_seq.append(g.lnz[i])
            predecessor = None
            if rg.node_start[i]:
                for pred, paths in rg.preds_and_paths(i):
                    if paths[rev_best_path]:
                        predecessor = pred
            i = (i + 1) if predecessor is None else predecessor
            rev_path_length += 1

    i_f, temp_cigar, temp_handles, temp_path_seq, path_length = _trace_forward(
        dpm, g, seq, sm, best_path, fen, rec_col
    )
    if global_mode:
        i_f, path_length = _trace_forward_global_tail(
            g, best_path, i_f, temp_cigar, temp_handles, temp_path_seq, path_length
        )
    rec_edge = len(temp_path_seq) - 1
    temp_cigar.reverse()
    temp_cigar.extend(cigar)
    temp_handles.reverse()
    temp_handles.extend(handles)
    handles_d: list[int] = []
    for h in temp_handles:
        if not handles_d or handles_d[-1] != h:
            handles_d.append(h)
    temp_path_seq.reverse()
    temp_path_seq.extend(path_seq)
    path_sequence_string = "".join(temp_path_seq)

    start = i_f if i_f == 0 else i_f + 1
    path_len, path_start, path_end = get_rec_path_len_start_end(
        ids, fen, rsn, start, rev_ending_node, path_length, rev_path_length
    )
    if best_path == rev_best_path:
        recombination = f"No recombination, best path: {best_path}"
    else:
        fen_off = get_node_offset(ids, fen)
        rsn_off = get_node_offset(ids, rsn)
        recombination = (
            f"recombination path {best_path} {rev_best_path}, "
            f"nodes {ids[fen]}[{fen_off}] {ids[rsn]}[{rsn_off}], "
            f"score: {_fmt_f32(best_score[0])}, displacement: {best_score[1]}"
            f"\t{path_sequence_string}\t{rec_edge}"
        )
    comments = f"{build_cigar(temp_cigar)}, {recombination}"
    return GafRecord(
        query_name="Temp",
        query_length=L - 1,
        query_start=0,
        query_end=L - 2,
        strand="+",
        path=handles_d,
        path_length=path_len,
        path_start=path_start,
        path_end=path_end,
        residue_matches_number=0,
        alignment_block_length="*",
        mapping_quality="*",
        comments=comments,
    )


def _fmt_f32(v: float) -> str:
    """Rust's f32 Display: integral values print without decimals."""
    if v == int(v):
        return str(int(v))
    return repr(np.float32(v).item())


def exec_mode(
    aln_mode: int,
    seq: str,
    g: PathGraph,
    rg: PathGraph,
    sm: ScoreMatrix,
    base_rec_cost: int,
    multi_rec_cost: float,
    dms: np.ndarray,
    rbw: float,
) -> GafRecord:
    """Modes 8/9 entry; mirrors pathwise_alignment_recombination::exec (:23-127)."""
    forward = align(aln_mode, seq, g, sm)
    rev_seq = get_rev_sequence(seq)
    reverse = rev_align(aln_mode, rev_seq, rg, sm)
    fen, rsn, fp, rp, rec_col, score = best_alignment(
        forward, reverse, dms, base_rec_cost, multi_rec_cost, aln_mode, g, rbw
    )
    if fp == rp:
        if aln_mode == 8:
            # ending node: last F-pred edge containing the path (:649-655)
            end_node = 0
            for node, paths in g.preds_and_paths(g.n - 1):
                if paths[fp]:
                    end_node = node
            return _gaf_no_rec(forward, g, seq, sm, fp, end_node, global_tail=True)
        end_node = ending_node(forward, fp, g)
        return _gaf_no_rec(forward, g, seq, sm, fp, end_node, global_tail=False)
    return _gaf_rec(
        forward,
        reverse,
        g,
        rg,
        seq,
        sm,
        fp,
        rp,
        fen,
        rsn,
        rec_col,
        score,
        global_mode=(aln_mode == 8),
    )
