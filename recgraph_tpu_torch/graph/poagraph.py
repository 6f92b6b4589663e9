"""POA graph compiler: GFA -> dense linearised arrays.

Copy of ``recgraph_tpu/graph/poagraph.py``.

This is the equivalent of the reference's ``LnzGraph``
(reference: src/graph.rs:23-27) re-designed as flat arrays ready for
device upload:

- ``lnz``          the linearisation string: ``'$' + concat(node seqs in
                   sorted-id order) + 'F'`` (graph.rs:45-57,112-123).
- ``codes``        int8[n] base codes of ``lnz`` (scoring.encode).
- ``node_start``   bool[n]  True at every position that starts a node
                   (the reference's ``nwp`` bitvector; set for sources at
                   graph.rs:69-74 and for pred-bearing nodes at :80).
- ``preds``        dict[node_start_pos] -> sorted list of predecessor
                   *end* positions; 0 for source nodes (graph.rs:73).
                   The final virtual node 'F' at position n-1 has every
                   sink's end position as predecessor (graph.rs:112-123).
- ``pred_idx``     int32[n, max_preds] padded predecessor-end positions
                   (-1 padding), ascending; for non-start rows the single
                   implicit predecessor is i-1.
- ``handle_pos``   list[str] GFA node id per lnz position ("-1" at 0),
                   the reference's hofp map (utils.rs:144-165).

Determinism note: the reference stores predecessor lists in HashMap
iteration order, which is unspecified; we canonicalise to ascending
position order.  This only affects argmax *tie-breaking* among equal
predecessors, never scores.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.gfa import Gfa
from .. import scoring

_COMPL = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}


def _revcomp(seq: str) -> str:
    return "".join(_COMPL.get(c, "N") for c in reversed(seq))


@dataclass
class PoaGraph:
    lnz: str
    codes: np.ndarray          # int8[n]
    node_start: np.ndarray     # bool[n]
    preds: dict[int, list[int]]
    handle_pos: list[str]      # str per position; "-1" at 0

    @property
    def n(self) -> int:
        return len(self.lnz)

    # -- constructors ----------------------------------------------------

    @classmethod
    def from_gfa(cls, gfa: Gfa, amb_mode: bool = False) -> "PoaGraph":
        """Mirrors create_graph_struct (graph.rs:31-102).

        ``amb_mode=True`` builds the reverse-complement graph: node order
        reversed, node sequences reverse-complemented, edges flipped
        (graph.rs:34-40 via handle.flip()).
        """
        order = gfa.sorted_ids
        if amb_mode:
            order = list(reversed(order))

        seq_of = {
            nid: (_revcomp(gfa.segments[nid]) if amb_mode else gfa.segments[nid])
            for nid in order
        }
        if amb_mode:
            pred_ids = gfa.successors()
        else:
            pred_ids = gfa.predecessors()

        lnz_parts = ["$"]
        start_of: dict[int, int] = {}
        end_of: dict[int, int] = {}
        pos = 1
        for nid in order:
            s = seq_of[nid]
            start_of[nid] = pos
            pos += len(s)
            end_of[nid] = pos - 1
            lnz_parts.append(s)
        lnz_parts.append("F")
        lnz = "".join(lnz_parts)
        n = len(lnz)

        node_start = np.zeros(n, dtype=bool)
        preds: dict[int, list[int]] = {}
        has_succ: set[int] = set()
        for nid in order:
            sp = start_of[nid]
            node_start[sp] = True
            plist = pred_ids.get(nid, [])
            if not plist:
                preds[sp] = [0]
            else:
                preds[sp] = sorted(end_of[p] for p in plist)
                for p in plist:
                    has_succ.add(p)
        # final virtual node F: predecessors = every sink's end position
        node_start[n - 1] = True
        sinks = [nid for nid in order if nid not in has_succ]
        preds[n - 1] = sorted(end_of[nid] for nid in sinks)

        handle_pos = ["-1"] * n
        cur = None
        for nid in order:
            for i in range(start_of[nid], end_of[nid] + 1):
                handle_pos[i] = str(nid)
        del cur
        handle_pos[n - 1] = "-1"

        return cls(
            lnz=lnz,
            codes=scoring.encode(lnz),
            node_start=node_start,
            preds=preds,
            handle_pos=handle_pos,
        )

    # -- derived arrays ---------------------------------------------------

    def pred_list(self, i: int) -> list[int]:
        """Predecessor positions used by the DP at row i.

        For node-start rows this is the explicit list; other rows have
        the single implicit predecessor i-1 (the reference passes
        ``&vec![i-1]`` at e.g. global_abpoa.rs:319-322).
        """
        if self.node_start[i]:
            return self.preds[i]
        return [i - 1]

    def padded_preds(self) -> tuple[np.ndarray, np.ndarray]:
        """(pred_idx int32[n, P], pred_mask bool[n, P]) padded with -1.

        Row 0 and padding entries are masked out.
        """
        maxp = 1
        for v in self.preds.values():
            maxp = max(maxp, len(v))
        n = self.n
        idx = np.full((n, maxp), -1, dtype=np.int32)
        for i in range(1, n):
            pl = self.pred_list(i)
            idx[i, : len(pl)] = pl
        mask = idx >= 0
        return idx, mask

    def min_pred(self, i: int) -> int:
        """The fallback predecessor used by banded kernels.

        Mirrors ``pred_hash.get(&i).unwrap().iter().min()`` /
        ``i - 1`` (global_abpoa.rs:311-315 etc.).
        """
        if self.node_start[i]:
            return min(self.preds[i])
        return i - 1

    def r_values(self) -> np.ndarray:
        """Distance-to-sink estimate per position, for band placement.

        Mirrors utils::set_r_values (utils.rs:103-126): reverse sweep
        with the quirk that unvisited positions relax from their right
        neighbour even when that neighbour is still -1.
        """
        n = self.n
        r = np.full(n, -1, dtype=np.int64)
        r[n - 1] = 0
        for p in self.preds[n - 1]:
            r[p] = 0
        for i in range(n - 2, 0, -1):
            if r[i] == -1 or r[i] > r[i + 1] + 1:
                r[i] = r[i + 1] + 1
            if self.node_start[i]:
                for p in self.preds[i]:
                    if r[p] == -1 or r[p] > r[i] + 1:
                        r[p] = r[i] + 1
        return r.astype(np.int64)


# -- band utilities (shared by oracle and device paths) --------------------


def set_ampl_for_row(
    i: int,
    p_arr: list[int],
    r_val: int,
    best_scoring_pos,
    seq_len: int,
    bta: int,
) -> tuple[int, int]:
    """abPOA-style adaptive band for one row; mirrors utils.rs:17-72.

    ``p_arr`` must be empty for non-start rows (the caller then uses
    ``best_scoring_pos[i-1]``), matching the reference call sites.
    """
    if i == 0:
        ms = me = 0
    elif not p_arr:
        pl = best_scoring_pos[i - 1]
        ms = me = pl + 1
    else:
        bs = [best_scoring_pos[p] for p in p_arr]
        ms = min(bs) + 1
        me = max(bs) + 1
    tmp_bs = min(ms, seq_len - r_val - bta)
    band_start = 0 if tmp_bs < 0 else max(0, tmp_bs)
    if seq_len > r_val:
        band_end = min(seq_len, max(me, seq_len - r_val) + bta)
    else:
        band_end = min(seq_len, me + bta)
    return band_start, band_end


def get_max_d_u_l(d: int, u: int, l: int) -> tuple[int, str]:
    """3-way max with tie order D >= U >= L; mirrors utils.rs:129-140."""
    if d < u:
        if u < l:
            return l, "L"
        return u, "U"
    if d < l:
        return l, "L"
    return d, "D"
