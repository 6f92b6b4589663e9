"""Pathwise graph compiler: GFA with P-lines -> dense arrays.

Copy of ``recgraph_tpu/graph/pathgraph.py`` (``PathGraph``, ``from_gfa``,
``preds_and_paths`` and ``pathwise_meta``), cut to what modes 4/5 call:
the reverse graph, the distance functions and the reverse metadata
belong to modes 8/9.

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
