"""Pathwise graph compiler: GFA with P-lines -> dense arrays.

Copy of ``recgraph_tpu/graph/pathgraph.py``: ``PathGraph`` with
``from_gfa``, ``preds_and_paths``, ``reverse`` and the displacement
distances, ``nodes_displacement_matrix`` (for the scalar oracle only),
``pathwise_meta`` (modes 4/5 and the forward fill of modes 8/9) and
``pathwise_meta_rev`` (the reverse fill of modes 8/9).

Equivalent of the reference's ``PathGraph`` (reference:
src/pathwise_graph.rs:10-18), re-designed as dense arrays:

- ``lnz`` / ``codes``      linearisation as in PoaGraph, same order.
- ``node_start``           bool[n]; set only at node starts *visited by
                           some path* plus F (pathwise_graph.rs:207-209,236)
                           — unvisited nodes keep False, a reference quirk
                           we preserve.
- ``pred_edges``           dict[node_start_pos] -> dict[pred_end_pos] ->
                           path-id bool[P] (the reference's PredHash,
                           pathwise_graph.rs:74-125).
- ``paths_nodes``          bool[n, P]; rows 0 and n-1 are all-True
                           (pathwise_graph.rs:185,237).
- ``alphas``               int32[n]; first path id covering the position,
                           P+1 sentinel when uncovered; 0 at both ends
                           (pathwise_graph.rs:182-205).
- ``nodes_id_pos``         int64[n]; GFA node id per position, 0 at the
                           sentinels (pathwise_graph.rs:151-165).

Plus the per (position, path) *group representative* and *predecessor
position* of ``pathwise_meta``: the reference's alpha/delta compression
(pathwise_alignment.rs) is an implementation trick whose observable
semantics are that every path in a "common paths" group moves in the
direction chosen by the group's representative path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import scoring
from ..io.gfa import Gfa
from .poagraph import _revcomp


@dataclass
class PathGraph:
    lnz: str
    codes: np.ndarray                 # int8[n]
    node_start: np.ndarray            # bool[n]
    pred_edges: dict[int, dict[int, np.ndarray]]  # pos -> pred_end -> bool[P]
    paths_nodes: np.ndarray           # bool[n, P]
    alphas: np.ndarray                # int32[n]
    paths_number: int
    nodes_id_pos: np.ndarray          # int64[n]

    @property
    def n(self) -> int:
        return len(self.lnz)

    def preds_and_paths(self, i: int) -> list[tuple[int, np.ndarray]]:
        """(pred_end_pos, path mask) pairs, ascending by position.

        The reference iterates these in HashMap order
        (pathwise_graph.rs:86-93); groups are disjoint per path so the
        order only matters for degenerate ties — we canonicalise.
        """
        return sorted(self.pred_edges[i].items())

    @classmethod
    def from_gfa(cls, gfa: Gfa, is_reversed: bool = False) -> "PathGraph":
        """Mirrors create_path_graph (pathwise_graph.rs:135-248)."""
        order = gfa.sorted_ids
        if is_reversed:
            order = list(reversed(order))
        seq_of = {
            nid: (_revcomp(gfa.segments[nid]) if is_reversed else gfa.segments[nid])
            for nid in order
        }

        lnz_parts = ["$"]
        nodes_id_pos = [0]
        start_of: dict[int, int] = {}
        end_of: dict[int, int] = {}
        pos = 1
        for nid in order:
            s = seq_of[nid]
            start_of[nid] = pos
            for _ in s:
                nodes_id_pos.append(nid)
            pos += len(s)
            end_of[nid] = pos - 1
            lnz_parts.append(s)
        lnz_parts.append("F")
        nodes_id_pos.append(0)
        lnz = "".join(lnz_parts)
        n = len(lnz)

        P = len(gfa.paths)
        node_start = np.zeros(n, dtype=bool)
        paths_nodes = np.zeros((n, P), dtype=bool)
        alphas = np.full(n, P + 1, dtype=np.int32)
        paths_nodes[0, :] = True
        alphas[0] = 0
        alphas[n - 1] = 0
        pred_edges: dict[int, dict[int, np.ndarray]] = {}

        def set_pred(curr: int, pred: int, path_id: int) -> None:
            d = pred_edges.setdefault(curr, {})
            if pred not in d:
                d[pred] = np.zeros(P, dtype=bool)
            d[pred][path_id] = True

        for path_id, path in enumerate(gfa.paths):
            nodes = list(reversed(path.nodes)) if is_reversed else list(path.nodes)
            for posn, nid in enumerate(nodes):
                hs, he = start_of[nid], end_of[nid]
                for idx in range(hs, he + 1):
                    paths_nodes[idx, path_id] = True
                    if alphas[idx] == P + 1:
                        alphas[idx] = path_id
                node_start[hs] = True
                if posn == 0:
                    set_pred(hs, 0, path_id)
                else:
                    pred_end = end_of[nodes[posn - 1]]
                    set_pred(hs, pred_end, path_id)
                    # quirk preserved: single-node paths never register an
                    # F predecessor (pathwise_graph.rs:211-232, the F update
                    # lives in the `else` branch only)
                    if posn == len(nodes) - 1:
                        set_pred(n - 1, he, path_id)
        node_start[n - 1] = True
        paths_nodes[n - 1, :] = True

        return cls(
            lnz=lnz,
            codes=scoring.encode(lnz),
            node_start=node_start,
            pred_edges=pred_edges,
            paths_nodes=paths_nodes,
            alphas=alphas,
            paths_number=P,
            nodes_id_pos=np.array(nodes_id_pos, dtype=np.int64),
        )

    def reverse(self) -> "PathGraph":
        """Flip the predecessor hash into a successor hash.

        Mirrors create_reverse_path_graph (pathwise_graph.rs:250-282):
        everything else (lnz, paths, alphas, ids) is shared.
        """
        node_start_rev = np.zeros(self.n, dtype=bool)
        pred_rev: dict[int, dict[int, np.ndarray]] = {}
        for node, d in self.pred_edges.items():
            for pred, paths in d.items():
                node_start_rev[pred] = True
                dd = pred_rev.setdefault(pred, {})
                if node not in dd:
                    dd[node] = np.zeros(self.paths_number, dtype=bool)
                dd[node] |= paths
        return PathGraph(
            lnz=self.lnz,
            codes=self.codes,
            node_start=node_start_rev,
            pred_edges=pred_rev,
            paths_nodes=self.paths_nodes,
            alphas=self.alphas,
            paths_number=self.paths_number,
            nodes_id_pos=self.nodes_id_pos,
        )

    def distance_from_end(self) -> np.ndarray:
        """Mirrors get_distance_from_end (pathwise_graph.rs:330-354)."""
        n = self.n
        r = np.full(n, -1, dtype=np.int64)
        r[n - 1] = 0
        for p, _ in self.preds_and_paths(n - 1):
            r[p] = 1
        for i in range(n - 2, 0, -1):
            if r[i] == -1 or r[i] > r[i + 1] + 1:
                r[i] = r[i + 1] + 1
            if self.node_start[i]:
                for p, _ in self.preds_and_paths(i):
                    if r[p] == -1 or r[p] > r[i] + 1:
                        r[p] = r[i] + 1
        return r

    def distance_from_start_on_reverse(self) -> np.ndarray:
        """Mirrors get_distance_from_start applied to the reverse graph
        (pathwise_graph.rs:306-329); ``self`` must be the reverse graph."""
        n = self.n
        r = np.full(n, -1, dtype=np.int64)
        r[0] = 0
        if 0 in self.pred_edges:
            for p, _ in self.preds_and_paths(0):
                r[p] = 1
        for i in range(1, n - 1):
            if r[i] == -1 or r[i] > r[i - 1] + 1:
                r[i] = r[i - 1] + 1
            if self.node_start[i]:
                for p, _ in self.preds_and_paths(i):
                    if r[p] == -1 or r[p] > r[i] + 1:
                        r[p] = r[i] + 1
        return r


def nodes_displacement_matrix(graph: PathGraph, rev_graph: PathGraph) -> np.ndarray:
    """int32[n, n] displacement; mirrors pathwise_graph.rs:284-305.

    dms[i][j] = |dfs_i - dfs_j| + |dfe_i - dfe_j|, 0 on the diagonal.
    The device kernels recompute this on the fly from dfs/dfe to avoid
    the O(n^2) HBM footprint; this dense form is for the oracle.
    """
    dfe = graph.distance_from_end()
    dfs = rev_graph.distance_from_start_on_reverse()
    d = np.abs(dfs[:, None] - dfs[None, :]) + np.abs(dfe[:, None] - dfe[None, :])
    np.fill_diagonal(d, 0)
    return d.astype(np.int32)

def pathwise_meta(g: PathGraph) -> tuple[np.ndarray, np.ndarray]:
    """Per-(position, path) DP metadata for the pathwise fills.

    Returns (rep_of int32[n, P], pred_of int32[n, P]):

    - ``rep_of[i, p]``  the representative path whose d/u/l argmax
      decision path p inherits at row i (-1 when p not on node i).
      For non-start rows every on-node path shares ``alphas[i]``
      (positions in one node have identical path sets, so the
      reference's `else` rebasing branch is unreachable there).  For
      node-start rows the groups are the per-predecessor-edge "common
      paths" sets and the representative is ``alphas[pred]`` when it is
      in the group, else ``alphas[i]`` when in the group, else the
      smallest path id in the group (pathwise_alignment.rs:57-91,235-248).
    - ``pred_of[i, p]`` the DP predecessor row for path p at row i
      (i-1 for non-start rows; the path's pred-edge position otherwise;
      -1 when p not on node i).
    """
    n, P = g.n, g.paths_number
    rep_of = np.full((n, P), -1, dtype=np.int32)
    pred_of = np.full((n, P), -1, dtype=np.int32)
    for i in range(1, n - 1):
        on = g.paths_nodes[i]
        if not g.node_start[i]:
            rep_of[i, on] = g.alphas[i]
            pred_of[i, on] = i - 1
        else:
            for p, edge_paths in g.preds_and_paths(i):
                common = on & edge_paths
                if not common.any():
                    continue
                ap = g.alphas[p]
                if ap < P and common[ap]:
                    rep = ap
                elif common[g.alphas[i]]:
                    rep = g.alphas[i]
                else:
                    rep = int(np.flatnonzero(common)[0])
                rep_of[i, common] = rep
                pred_of[i, common] = p
    return rep_of, pred_of


def pathwise_meta_rev(rg: PathGraph) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reverse-fill group metadata; mirrors rev_align's branch structure
    (pathwise_alignment_recombination.rs:129-435) over the reverse graph
    (successor edges).  ``pred_of`` here points *forward* (successor
    rows; i+1 for rows that are not node ends).

    Returns (rep_of, pred_of, qsrc_of), all int32[n, P].  ``qsrc_of`` is
    the plane a path reads its *own* source values from — the path
    itself everywhere except on the reference's delta-leak rows, where
    a path's slot is never written (delta 0) or is force-assigned the
    representative's value.  Both collapse, in absolute terms, to
    "read the representative's plane instead of your own", which makes
    the device fill exact on graphs that previously required the scalar
    oracle fallback:

    - *ghost rows*: a single-node path registers no F predecessor
      (pathwise_graph.rs:211-232), leaving it uncovered by every
      successor edge at its reverse node-start row — its cells stay
      delta-0 clones of the node alpha (:436-445 never writes them);
    - *unmarked node-end rows with differing path sets*: the
      within-node branch (:245-320) computes candidates from row i+1's
      alpha ``ap`` but stores the max into row i's alpha slot ``ai``
      and only updates ``common`` members; covered paths outside
      ``common`` (and ``ai`` itself) end up carrying the
      representative's absolute value.
    """
    n, P = rg.n, rg.paths_number
    rep_of = np.full((n, P), -1, dtype=np.int32)
    pred_of = np.full((n, P), -1, dtype=np.int32)
    qsrc_of = np.tile(np.arange(P, dtype=np.int32), (n, 1))
    for i in range(1, n - 1):
        on = rg.paths_nodes[i]
        ai = rg.alphas[i]
        if not rg.node_start[i]:
            nxt = rg.paths_nodes[i + 1]
            ap = rg.alphas[i + 1]
            if np.array_equal(on, nxt):
                rep_of[i, on] = ai
                pred_of[i, on] = i + 1
                continue
            # delta-leak row: see docstring
            common = on & nxt
            if ap < P and common[ap]:
                rep = ap
            elif ap < P and ai < P and nxt[ai]:
                # reference else-branch with a valid ai delta at i+1:
                # rep chain = ai's own absolutes (:282-320)
                rep = ai
            else:
                # ai's delta slot at i+1 is never written (0): the
                # candidate sums collapse to ap's absolutes
                rep = ap
            rep_of[i, on] = rep
            pred_of[i, on] = i + 1
            clones = on & ~common                 # incl. ai when outside common
            qsrc_of[i, clones] = rep
            if ai < P:
                qsrc_of[i, ai] = rep              # ai is assigned the rep value
        else:
            covered = np.zeros(P, dtype=bool)
            for p, edge_paths in rg.preds_and_paths(i):
                common = on & edge_paths
                if not common.any():
                    continue
                ap = rg.alphas[p]
                if ap < P and common[ap]:
                    rep = ap
                elif common[ai]:
                    rep = ai
                else:
                    rep = int(np.flatnonzero(common)[0])
                rep_of[i, common] = rep
                pred_of[i, common] = p
                covered |= common
            ghosts = on & ~covered
            if ghosts.any():
                if not covered[ai]:
                    # ghost-alpha row: the alpha slot itself is never
                    # written, so in absolute terms every ghost here
                    # (incl. the alpha) reads as constant 0 — rows
                    # below then chain off those zeros, which the
                    # normal follower math reproduces.  qsrc == -1
                    # marks "constant 0" to the device fill.
                    qsrc_of[i, ghosts] = -1
                else:
                    # ghost paths: delta-0 clones of the node alpha —
                    # copy the alpha's group triple and read the
                    # alpha's plane
                    rep_of[i, ghosts] = rep_of[i, ai]
                    pred_of[i, ghosts] = pred_of[i, ai]
                    qsrc_of[i, ghosts] = ai
    return rep_of, pred_of, qsrc_of
