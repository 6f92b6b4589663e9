"""Oracle for pathwise modes 4 (global) and 5 (semiglobal).

Copy of ``recgraph_tpu/oracle/pathwise.py``: literal ports of the
reference's alpha/delta-compressed DP:

- mode 4: pathwise_alignment::exec            (pathwise_alignment.rs:5-340)
- mode 5: pathwise_alignment_semiglobal::exec (pathwise_alignment_semiglobal.rs:6-277)
- traceback: build_alignment                  (pathwise_alignment_output.rs:7-184)

The DP matrix ``dpm[i][j][p]`` stores, per the reference's compression,
the *absolute* score on the row's alpha path and *deltas vs alpha* on
every other path covering the node.  ``absolute()`` resolves the
compression (pathwise_alignment_recombination.rs:747-757); the device
fills compute the absolute form directly.
"""

from __future__ import annotations

import numpy as np

from ..graph.pathgraph import PathGraph
from ..io.gaf import GafRecord
from ..scoring import ScoreMatrix
from .gaf_emit import build_cigar


def fill(seq: str, g: PathGraph, sm: ScoreMatrix, semiglobal: bool) -> np.ndarray:
    """Delta-form DP fill; mirrors pathwise_alignment{,_semiglobal}::exec."""
    lnz = g.lnz
    n = g.n
    L = len(seq)
    P = g.paths_number
    alphas = g.alphas
    pn = g.paths_nodes
    dpm = np.zeros((n, L, P), dtype=np.int64)

    for i in range(n - 1):
        gap_i = sm.get(lnz[i], "-") if i > 0 else 0
        for j in range(L):
            if i == 0 and j == 0:
                continue
            if j == 0:
                if semiglobal:
                    continue  # first column zeroed (…_semiglobal.rs:25)
                _fill_first_col(dpm, g, i, gap_i)
            elif i == 0:
                a0 = alphas[0]
                dpm[0, j, a0] = dpm[0, j - 1, a0] + sm.get(seq[j], "-")
                dpm[0, j, a0 + 1 :] = dpm[0, j - 1, a0 + 1 :]
            else:
                sub = sm.get(lnz[i], seq[j])
                gap_j = sm.get(seq[j], "-")
                if not g.node_start[i]:
                    common = pn[i] & pn[i - 1]
                    ai, ap = alphas[i], alphas[i - 1]
                    if common[ap]:
                        u = dpm[i - 1, j, ap] + gap_i
                        d = dpm[i - 1, j - 1, ap] + sub
                        l = dpm[i, j - 1, ai] + gap_j
                        mx = max(d, u, l)
                        dpm[i, j, ai] = mx
                        mask = common.copy()
                        mask[ai] = False
                        if mx == d:
                            dpm[i, j, mask] = dpm[i - 1, j - 1, mask]
                        elif mx == u:
                            dpm[i, j, mask] = dpm[i - 1, j, mask]
                        else:
                            dpm[i, j, mask] = dpm[i, j - 1, mask]
                    else:
                        u = dpm[i - 1, j, ap] + dpm[i - 1, j, ai] + gap_i
                        d = dpm[i - 1, j - 1, ap] + dpm[i - 1, j - 1, ai] + sub
                        l = dpm[i, j - 1, ai] + gap_j
                        mx = max(d, u, l)
                        dpm[i, j, ai] = mx
                        mask = common.copy()
                        mask[ai] = False
                        if mx == d:
                            dpm[i, j, mask] = (
                                dpm[i - 1, j - 1, mask] - dpm[i - 1, j - 1, ai]
                            )
                        elif mx == u:
                            dpm[i, j, mask] = dpm[i - 1, j, mask] - dpm[i - 1, j, ai]
                        else:
                            dpm[i, j, mask] = dpm[i, j - 1, mask]
                else:
                    _fill_node_start(dpm, g, i, j, sub, gap_i, gap_j)
    return dpm


def _fill_first_col(dpm: np.ndarray, g: PathGraph, i: int, gap_i: int) -> None:
    """(_, 0) branch of the global fill (pathwise_alignment.rs:24-120)."""
    alphas, pn = g.alphas, g.paths_nodes
    ai = alphas[i]
    j = 0
    if not g.node_start[i]:
        common = pn[i] & pn[i - 1]
        ap = alphas[i - 1]
        if common[ap]:
            mask = common.copy()
            mask[ai] = False
            dpm[i, j, ai] = dpm[i - 1, j, ai] + gap_i
            dpm[i, j, mask] = dpm[i - 1, j, mask]
        else:
            dpm[i, j, ai] = dpm[i - 1, j, ai] + dpm[i - 1, j, ap] + gap_i
            mask = common.copy()
            mask[ai] = False
            dpm[i, j, mask] = dpm[i - 1, j, mask] - dpm[i - 1, j, ai]
    else:
        alphas_deltas: dict[int, np.ndarray] = {}
        for p, p_paths in g.preds_and_paths(i):
            common = pn[i] & p_paths
            if not common.any():
                raise RuntimeError("empty common-paths set")
            ap = alphas[p]
            if ap < g.paths_number and common[ap]:
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
        _remove_multiple_alphas(dpm, i, j, ai, alphas_deltas)


def _fill_node_start(dpm, g, i, j, sub, gap_i, gap_j) -> None:
    """nwp branch of the interior fill (pathwise_alignment.rs:183-300)."""
    alphas, pn = g.alphas, g.paths_nodes
    ai = alphas[i]
    alphas_deltas: dict[int, np.ndarray] = {}
    for p, p_paths in g.preds_and_paths(i):
        common = pn[i] & p_paths
        if not common.any():
            raise RuntimeError("empty common-paths set")
        ap = alphas[p]
        if ap < g.paths_number and common[ap]:
            alphas_deltas[ap] = common
            u = dpm[p, j, ap] + gap_i
            d = dpm[p, j - 1, ap] + sub
            if ai == ap:
                l = dpm[i, j - 1, ap] + gap_j
            else:
                l = dpm[i, j - 1, ap] + dpm[i, j - 1, ai] + gap_j
            mx = max(d, u, l)
            dpm[i, j, ap] = mx
            mask = common.copy()
            mask[ap] = False
            if mx == d:
                dpm[i, j, mask] = dpm[p, j - 1, mask]
            elif mx == u:
                dpm[i, j, mask] = dpm[p, j, mask]
            else:
                if ap == ai:
                    dpm[i, j, mask] = dpm[i, j - 1, mask]
                else:
                    dpm[i, j, mask] = dpm[i, j - 1, mask] - dpm[i, j - 1, ap]
        else:
            ta = ai if common[ai] else int(np.flatnonzero(common)[0])
            alphas_deltas[ta] = common
            u = dpm[p, j, ap] + dpm[p, j, ta] + gap_i
            d = dpm[p, j - 1, ap] + dpm[p, j - 1, ta] + sub
            if ai == ta:
                l = dpm[i, j - 1, ta] + gap_j
            else:
                l = dpm[i, j - 1, ta] + dpm[i, j - 1, ai] + gap_j
            mx = max(d, u, l)
            dpm[i, j, ta] = mx
            mask = common.copy()
            mask[ta] = False
            if mx == d:
                dpm[i, j, mask] = dpm[p, j - 1, mask] - dpm[p, j - 1, ta]
            elif mx == u:
                dpm[i, j, mask] = dpm[p, j, mask] - dpm[p, j, ta]
            else:
                if ta == ai:
                    dpm[i, j, mask] = dpm[i, j - 1, mask]
                else:
                    dpm[i, j, mask] = dpm[i, j - 1, mask] - dpm[i, j - 1, ta]
    _remove_multiple_alphas(dpm, i, j, ai, alphas_deltas)


def _remove_multiple_alphas(
    dpm: np.ndarray, i: int, j: int, ai: int, alphas_deltas: dict[int, np.ndarray]
) -> None:
    """Multi-alpha merge fixup (pathwise_alignment.rs:288-299)."""
    for a, members in alphas_deltas.items():
        if a != ai:
            dpm[i, j, a] -= dpm[i, j, ai]
            mask = members.copy()
            mask[a] = False
            dpm[i, j, mask] += dpm[i, j, a]


def absolute(dpm: np.ndarray, g: PathGraph) -> np.ndarray:
    """Resolve deltas to absolute per-path scores.

    Mirrors absolute_scores (pathwise_alignment_recombination.rs:747-757):
    rows 0..n-2 only, members only; untouched entries remain raw (0).
    """
    out = dpm.copy()
    for i in range(g.n - 1):
        ai = g.alphas[i]
        mask = g.paths_nodes[i].copy()
        if ai < g.paths_number:
            mask[ai] = False
            out[i, :, mask] += out[i, :, ai]
    return out


# -- endings ----------------------------------------------------------------


def final_results_global(dpm: np.ndarray, g: PathGraph) -> tuple[np.ndarray, np.ndarray, int]:
    """Per-path final scores + ending nodes + best path (mode 4).

    Mirrors pathwise_alignment.rs:305-325.  Tie-break: the tuple max
    (score, path) prefers the larger path id.
    """
    P = g.paths_number
    results = np.zeros(P, dtype=np.int64)
    ending_nodes = np.zeros(P, dtype=np.int64)
    last = dpm.shape[1] - 1
    for pred, paths in g.preds_and_paths(g.n - 1):
        ap = g.alphas[pred]
        for path in np.flatnonzero(paths):
            if path == ap:
                results[path] = dpm[pred, last, path]
            else:
                results[path] = dpm[pred, last, path] + dpm[pred, last, ap]
            ending_nodes[path] = pred
    best_path = max(range(P), key=lambda p: (results[p], p))
    return results, ending_nodes, best_path


def best_ending_node_semiglobal(dpm: np.ndarray, g: PathGraph) -> tuple[int, int]:
    """(ending_node, path) for mode 5.

    Mirrors best_ending_node (pathwise_alignment_semiglobal.rs:244-277):
    first-maximum over paths within a node (strict <), first-maximum
    over nodes (strict >), scanning nodes 1..n-2.
    """
    mx = None
    ending_node = 0
    chosen_path = 0
    last = dpm.shape[1] - 1
    for i in range(1, g.n - 1):
        ai = g.alphas[i]
        absolute_scores = dpm[i, last].copy()
        on = g.paths_nodes[i]
        for path in np.flatnonzero(on):
            if path != ai:
                absolute_scores[path] += absolute_scores[ai]
        best = None
        for path in range(g.paths_number):
            if on[path] and (best is None or best[0] < absolute_scores[path]):
                best = (absolute_scores[path], path)
        if best is None:
            raise RuntimeError("node covered by no path")
        if mx is None or best[0] > mx:
            mx = best[0]
            ending_node = i
            chosen_path = best[1]
    return ending_node, chosen_path


# -- traceback ----------------------------------------------------------------


def get_path_len_start_end(
    handles_nodes_id: np.ndarray, start: int, end: int, path_len: int
) -> tuple[int, int, int]:
    """Mirrors utils::get_path_len_start_end (utils.rs:221-254)."""
    path_start = 0
    if start > 0:
        first_node_id = handles_nodes_id[start]
        counter = start - 1
        while counter > 0 and handles_nodes_id[counter] == first_node_id:
            counter -= 1
            path_start += 1
    path_end = path_start + path_len - 1 if path_len > 0 else 0
    end_offset = 0
    if end > 0:
        last_node_id = handles_nodes_id[end]
        counter = end + 1
        while (
            counter < len(handles_nodes_id) - 1
            and handles_nodes_id[counter] == last_node_id
        ):
            counter += 1
            end_offset += 1
    return path_end + end_offset + 1, path_start, path_end


def build_alignment(
    dpm: np.ndarray,
    g: PathGraph,
    seq: str,
    sm: ScoreMatrix,
    best_path: int,
    ending_node: int,
    global_align: bool,
) -> GafRecord:
    """Traceback by d/u/l recomputation over the delta-form matrix.

    Mirrors build_alignment (pathwise_alignment_output.rs:7-184),
    including the D >= U >= L effective tie order of the `max == d`
    cascade and the trailing-L / leading-U (global) tails.
    """
    lnz = g.lnz
    alphas = g.alphas
    nwp = g.node_start
    handles_nodes_id = g.nodes_id_pos
    cigar: list[str] = []
    path_length = 0
    i = ending_node
    j = dpm.shape[1] - 1
    handle_id_alignment: list[int] = []
    path_sequence: list[str] = []

    if best_path == alphas[i]:
        score = int(dpm[i, j, best_path])
    else:
        score = int(dpm[i, j, best_path] + dpm[i, j, alphas[i]])

    def abs_at(ii: int, jj: int) -> int:
        if alphas[ii] == best_path:
            return int(dpm[ii, jj, best_path])
        return int(dpm[ii, jj, best_path] + dpm[ii, jj, alphas[ii]])

    while i > 0 and j > 0:
        predecessor = None
        if not nwp[i]:
            d = abs_at(i - 1, j - 1) + sm.get(lnz[i], seq[j])
            u = abs_at(i - 1, j) + sm.get(lnz[i], "-")
            l = abs_at(i, j - 1) + sm.get("-", seq[j])
        else:
            d = u = l = 0
            for pred, paths in g.preds_and_paths(i):
                if paths[best_path]:
                    predecessor = pred
                    d = abs_at(pred, j - 1) + sm.get(lnz[i], seq[j])
                    u = abs_at(pred, j) + sm.get(lnz[i], "-")
                    l = abs_at(i, j - 1) + sm.get("-", seq[j])
        mx = max(d, u, l)
        if mx == d:
            cigar.append("D" if lnz[i] == seq[j] else "d")
            handle_id_alignment.append(int(handles_nodes_id[i]))
            path_sequence.append(lnz[i])
            i = (i - 1) if predecessor is None else predecessor
            j -= 1
            path_length += 1
        elif mx == u:
            cigar.append("U")
            handle_id_alignment.append(int(handles_nodes_id[i]))
            path_sequence.append(lnz[i])
            i = (i - 1) if predecessor is None else predecessor
            path_length += 1
        else:
            cigar.append("L")
            j -= 1
    while j > 0:
        cigar.append("L")
        j -= 1
    if global_align:
        while i > 0:
            cigar.append("U")
            handle_id_alignment.append(int(handles_nodes_id[i]))
            path_sequence.append(lnz[i])
            path_length += 1
            if not nwp[i]:
                predecessor = i - 1
            else:
                p = 0
                for pred, paths in g.preds_and_paths(i):
                    if paths[best_path]:
                        p = pred
                predecessor = p
            i = predecessor

    cigar.reverse()
    path_sequence.reverse()
    path_string_sequence = "".join(path_sequence)

    handle_dedup: list[int] = []
    for h in handle_id_alignment:
        if not handle_dedup or handle_dedup[-1] != h:
            handle_dedup.append(h)
    handle_dedup.reverse()

    path_len, path_start, path_end = get_path_len_start_end(
        handles_nodes_id, i if i == 0 else i + 1, ending_node, path_length
    )

    comments = (
        f"{build_cigar(cigar)}, best path: {best_path}, score: {score}"
        f"\t{path_string_sequence}"
    )
    L = dpm.shape[1]
    return GafRecord(
        query_name="Temp",
        query_length=L - 1,
        query_start=0,
        query_end=L - 2,
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


# -- top-level mode entry points ---------------------------------------------


def exec_global(seq: str, g: PathGraph, sm: ScoreMatrix) -> GafRecord:
    """Mode 4; mirrors pathwise_alignment::exec."""
    dpm = fill(seq, g, sm, semiglobal=False)
    _, ending_nodes, best_path = final_results_global(dpm, g)
    return build_alignment(
        dpm, g, seq, sm, best_path, int(ending_nodes[best_path]), True
    )


def exec_semiglobal(seq: str, g: PathGraph, sm: ScoreMatrix) -> GafRecord:
    """Mode 5; mirrors pathwise_alignment_semiglobal::exec."""
    dpm = fill(seq, g, sm, semiglobal=True)
    final_node, best_path = best_ending_node_semiglobal(dpm, g)
    return build_alignment(dpm, g, seq, sm, best_path, final_node, False)
