"""Oracle for experimental pathwise affine-gap modes 6/7.

Copy of ``recgraph_tpu/oracle/pathwise_gap.py``: literal ports of

- mode 6: pathwise_alignment_gap::exec       (pathwise_alignment_gap.rs:4-574)
- mode 7: pathwise_alignment_gap_semi::exec  (pathwise_alignment_gap_semi.rs:5-473)
- tracebacks: build_alignment_gap / build_alignment_semiglobal_gap
  (pathwise_alignment_output.rs:186-451)

These modes print a CIGAR + best-path index instead of emitting GAF
(main.rs:271-288).  Reference quirks preserved:

- the three matrices (dpm/x/y) share the alpha/delta compression and
  the multi-alpha fixup touches all three (gap.rs:521-537);
- the u_y member update in the node-start branch filters on
  ``alphas[i]`` instead of ``alphas[p]`` (gap.rs:336-343, a reference
  inconsistency we replicate);
- gap-run extension during traceback compares *delta-form* dpm vs x/y
  entries directly (output.rs:272,289);
- mode 6's trailing-U tail decrements i without consulting preds
  (output.rs:299-302).
"""

from __future__ import annotations

import numpy as np

from ..graph.pathgraph import PathGraph
from ..scoring import ScoreMatrix
from .gaf_emit import build_cigar


def fill(
    seq: str, g: PathGraph, sm: ScoreMatrix, o: int, e: int, semiglobal: bool
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    lnz = g.lnz
    n = g.n
    L = len(seq)
    P = g.paths_number
    alphas = g.alphas
    pn = g.paths_nodes
    dpm = np.zeros((n, L, P), dtype=np.int64)
    x = np.zeros((n, L, P), dtype=np.int64)
    y = np.zeros((n, L, P), dtype=np.int64)

    for i in range(n - 1):
        for j in range(L):
            if i == 0 and j == 0:
                continue
            if i == 0:
                a0 = alphas[0]
                y[0, j, a0] = o + e * j
                dpm[0, j, a0] = y[0, j, a0]
                y[0, j, a0 + 1 :] = y[0, j - 1, a0 + 1 :]
                dpm[0, j, a0 + 1 :] = y[0, j, a0 + 1 :]
            elif j == 0:
                if semiglobal:
                    continue  # first column zeroed (gap_semi.rs:28)
                _fill_first_col_gap(dpm, x, g, i, o, e)
            else:
                _fill_interior(dpm, x, y, g, sm, i, j, seq, o, e)
    return dpm, x, y


def _fill_first_col_gap(
    dpm: np.ndarray, x: np.ndarray, g: PathGraph, i: int, o: int, e: int
) -> None:
    """(_, 0) branch of mode 6 (gap.rs:35-148)."""
    alphas, pn = g.alphas, g.paths_nodes
    ai = alphas[i]
    j = 0
    if not g.node_start[i]:
        common = pn[i] & pn[i - 1]
        ap = alphas[i - 1]
        if common[ap]:
            mask = common.copy()
            mask[ai] = False
            if i == 1:
                x[i, j, ai] = o + e
            else:
                x[i, j, ai] = x[i - 1, j, ai] + e
            x[i, j, mask] = x[i - 1, j, mask]
            dpm[i, j, common] = x[i, j, common]
        else:
            if i != 1:
                x[i, j, ai] = x[i - 1, j, ai] + x[i - 1, j, ap] + e
            else:
                x[i, j, ai] = o + e
            dpm[i, j, ai] = x[i, j, ai]
            mask = common.copy()
            mask[ai] = False
            x[i, j, mask] = x[i - 1, j, mask] - x[i - 1, j, ai]
            dpm[i, j, mask] = x[i, j, mask]
    else:
        alphas_deltas: dict[int, np.ndarray] = {}
        for p, p_paths in g.preds_and_paths(i):
            common = pn[i] & p_paths
            if not common.any():
                raise RuntimeError("empty common-paths set")
            ap = alphas[p]
            if ap < g.paths_number and common[ap]:
                alphas_deltas[ap] = common
                x[i, j, ap] = (o + e) if p == 0 else (x[p, j, ap] + e)
                dpm[i, j, ap] = x[i, j, ap]
                mask = common.copy()
                mask[ap] = False
                x[i, j, mask] = x[p, j, mask]
                dpm[i, j, mask] = x[i, j, mask]
            else:
                ta = ai if common[ai] else int(np.flatnonzero(common)[0])
                alphas_deltas[ta] = common
                x[i, j, ta] = (o + e) if p == 0 else (x[p, j, ta] + x[p, j, ap] + e)
                dpm[i, j, ta] = x[i, j, ta]
                mask = common.copy()
                mask[ta] = False
                x[i, j, mask] = x[p, j, mask] - x[p, j, ta]
                dpm[i, j, mask] = x[i, j, mask]
        # fixup over x only, dpm mirrored (gap.rs:133-147)
        for a, members in alphas_deltas.items():
            if a != ai:
                x[i, j, a] -= x[i, j, ai]
                dpm[i, j, a] = x[i, j, a]
                mask = members.copy()
                mask[a] = False
                x[i, j, mask] += x[i, j, a]
                dpm[i, j, mask] = x[i, j, mask]


def _fill_interior(
    dpm: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    g: PathGraph,
    sm: ScoreMatrix,
    i: int,
    j: int,
    seq: str,
    o: int,
    e: int,
) -> None:
    """Interior cells of modes 6/7 (gap.rs:150-539 == gap_semi.rs:38-427)."""
    lnz = g.lnz
    alphas, pn = g.alphas, g.paths_nodes
    ai = alphas[i]
    sub = sm.get(lnz[i], seq[j])
    if not g.node_start[i]:
        common = pn[i] & pn[i - 1]
        ap = alphas[i - 1]
        mask = common.copy()
        mask[ai] = False
        if common[ap]:
            u_y = y[i - 1, j, ap] + e
            u_dpm = dpm[i - 1, j, ap] + o + e
            if u_dpm >= u_y:
                y[i, j, mask] = dpm[i - 1, j, mask]
                y[i, j, ai] = u_dpm
            else:
                y[i, j, mask] = y[i - 1, j, mask]
                y[i, j, ai] = u_y
            u = y[i, j, ai]
            l_x = x[i, j - 1, ai] + e
            l_dpm = dpm[i, j - 1, ai] + o + e
            if l_dpm >= l_x:
                x[i, j, mask] = dpm[i, j - 1, mask]
                x[i, j, ai] = l_dpm
            else:
                x[i, j, mask] = x[i, j - 1, mask]
                x[i, j, ai] = l_x
            l = x[i, j, ai]
            d = dpm[i - 1, j - 1, ap] + sub
            mx = max(d, u, l)
            dpm[i, j, ai] = mx
            if mx == d:
                dpm[i, j, mask] = dpm[i - 1, j - 1, mask]
            elif mx == u:
                dpm[i, j, mask] = y[i, j, mask]
            else:
                dpm[i, j, mask] = x[i, j, mask]
        else:
            u_y = y[i - 1, j, ap] + y[i - 1, j, ai] + e
            u_dpm = dpm[i - 1, j, ap] + dpm[i - 1, j, ai] + o + e
            if u_dpm >= u_y:
                y[i, j, mask] = dpm[i - 1, j, mask] - dpm[i - 1, j, ai]
                y[i, j, ai] = u_dpm
            else:
                y[i, j, mask] = y[i - 1, j, mask] - y[i - 1, j, ai]
                y[i, j, ai] = u_y
            u = y[i, j, ai]
            l_x = x[i, j - 1, ai] + e
            l_dpm = dpm[i, j - 1, ai] + o + e
            if l_dpm >= l_x:
                x[i, j, mask] = dpm[i, j - 1, mask]
                x[i, j, ai] = l_dpm
            else:
                x[i, j, mask] = x[i, j - 1, mask]
                x[i, j, ai] = l_x
            l = x[i, j, ai]
            d = dpm[i - 1, j - 1, ap] + dpm[i - 1, j - 1, ai] + sub
            mx = max(d, u, l)
            dpm[i, j, ai] = mx
            if mx == d:
                dpm[i, j, mask] = dpm[i - 1, j - 1, mask] - dpm[i - 1, j - 1, ai]
            elif mx == u:
                dpm[i, j, mask] = y[i, j, mask]
            else:
                dpm[i, j, mask] = x[i, j, mask]
    else:
        alphas_deltas: dict[int, np.ndarray] = {}
        for p, p_paths in g.preds_and_paths(i):
            common = pn[i] & p_paths
            if not common.any():
                raise RuntimeError("empty common-paths set")
            ap = alphas[p]
            if ap < g.paths_number and common[ap]:
                alphas_deltas[ap] = common
                mask = common.copy()
                mask[ap] = False
                u_y = y[p, j, ap] + e
                u_dpm = dpm[p, j, ap] + o + e
                if u_dpm >= u_y:
                    y[i, j, mask] = dpm[p, j, mask]
                    y[i, j, ap] = u_dpm
                else:
                    # quirk: filter on alphas[i], not alphas[p] (gap.rs:336-343)
                    mask_q = common.copy()
                    mask_q[ai] = False
                    y[i, j, mask_q] = y[p, j, mask_q]
                    y[i, j, ap] = u_y
                u = y[i, j, ap]
                if ap == ai:
                    l_x = x[i, j - 1, ap] + e
                    l_dpm = dpm[i, j - 1, ap] + o + e
                else:
                    l_x = x[i, j - 1, ap] + x[i, j - 1, ai] + e
                    l_dpm = dpm[i, j - 1, ai] + dpm[i, j - 1, ap] + o + e
                if l_dpm >= l_x:
                    if ap == ai:
                        x[i, j, mask] = dpm[i, j - 1, mask]
                    else:
                        x[i, j, mask] = dpm[i, j - 1, mask] - dpm[i, j - 1, ap]
                    x[i, j, ap] = l_dpm
                else:
                    if ap == ai:
                        x[i, j, mask] = x[i, j - 1, mask]
                    else:
                        x[i, j, mask] = x[i, j - 1, mask] - x[i, j - 1, ap]
                    x[i, j, ap] = l_x
                l = x[i, j, ap]
                d = dpm[p, j - 1, ap] + sub
                mx = max(d, u, l)
                dpm[i, j, ap] = mx
                if mx == d:
                    dpm[i, j, mask] = dpm[p, j - 1, mask]
                elif mx == u:
                    dpm[i, j, mask] = y[i, j, mask]
                else:
                    dpm[i, j, mask] = x[i, j, mask]
            else:
                ta = ai if common[ai] else int(np.flatnonzero(common)[0])
                alphas_deltas[ta] = common
                mask = common.copy()
                mask[ta] = False
                u_y = y[p, j, ap] + y[p, j, ta] + e
                u_dpm = dpm[p, j, ap] + dpm[p, j, ta] + o + e
                if u_dpm >= u_y:
                    y[i, j, mask] = dpm[p, j, mask] - dpm[p, j, ta]
                    y[i, j, ta] = u_dpm
                else:
                    y[i, j, mask] = y[p, j, mask] - y[p, j, ta]
                    y[i, j, ta] = u_y
                u = y[i, j, ta]
                if ai == ta:
                    l_x = x[i, j - 1, ai] + e
                    l_dpm = dpm[i, j - 1, ai] + o + e
                else:
                    l_x = x[i, j - 1, ai] + x[i, j - 1, ta] + e
                    l_dpm = dpm[i, j - 1, ai] + dpm[i, j - 1, ta] + o + e
                if l_dpm >= l_x:
                    if ta == ai:
                        x[i, j, mask] = dpm[i, j - 1, mask]
                    else:
                        x[i, j, mask] = dpm[i, j - 1, mask] - dpm[i, j - 1, ta]
                    x[i, j, ta] = l_dpm
                else:
                    if ta == ai:
                        x[i, j, mask] = x[i, j - 1, mask]
                    else:
                        x[i, j, mask] = x[i, j - 1, mask] - x[i, j - 1, ta]
                    x[i, j, ta] = l_x
                l = x[i, j, ta]
                d = dpm[p, j - 1, ap] + dpm[p, j - 1, ta] + sub
                mx = max(d, u, l)
                dpm[i, j, ta] = mx
                if mx == d:
                    dpm[i, j, mask] = dpm[p, j - 1, mask] - dpm[p, j - 1, ta]
                elif mx == u:
                    dpm[i, j, mask] = y[i, j, mask]
                else:
                    dpm[i, j, mask] = x[i, j, mask]
        # fixup touches all three matrices (gap.rs:521-537)
        for a, members in alphas_deltas.items():
            if a != ai:
                dpm[i, j, a] -= dpm[i, j, ai]
                x[i, j, a] -= x[i, j, ai]
                y[i, j, a] -= y[i, j, ai]
                mask = members.copy()
                mask[a] = False
                dpm[i, j, mask] += dpm[i, j, a]
                x[i, j, mask] += x[i, j, a]
                y[i, j, mask] += y[i, j, a]


def _fill_row_vec(dpm, x, y, i, pr, ap, ai, delta, midx, sub, o, e, jidx):
    """Vectorised interior fill of one row ``i`` whose only predecessor
    row is ``pr`` (row i-1 for non-start rows, the single pred for
    single-pred start rows with ta == ai — both execute the identical
    cell program, gap.rs:150-316 == 318-435 in that configuration).

    ``delta``: the pred's alpha lane is not in the common set, so pred
    row terms carry the + pred-alpha delta adjustment and mask copies
    subtract the base lane (gap.rs:246-316).
    """
    L = jidx.shape[0]
    prevD = dpm[pr]
    prevY = y[pr]
    xi, yi, di = x[i], y[i], dpm[i]

    # U branch (pred row only; no in-row coupling)
    if delta:
        u_y = prevY[:, ap] + prevY[:, ai] + e
        u_dpm = prevD[:, ap] + prevD[:, ai] + o + e
    else:
        u_y = prevY[:, ap] + e
        u_dpm = prevD[:, ap] + o + e
    usel = u_dpm >= u_y                                  # [L]
    y_a = np.where(usel, u_dpm, u_y)
    if delta:
        Ym = np.where(
            usel[:, None],
            prevD[:, midx] - prevD[:, ai:ai + 1],
            prevY[:, midx] - prevY[:, ai:ai + 1],
        )
    else:
        Ym = np.where(usel[:, None], prevD[:, midx], prevY[:, midx])
    yi[1:, ai] = y_a[1:]
    if len(midx):
        yi[1:, midx] = Ym[1:]

    # alpha lane: closed-form (max,+) scan over j
    base = prevD[:, ap] + prevD[:, ai] if delta else prevD[:, ap]
    d_col = np.empty(L, dtype=np.int64)
    d_col[0] = 0                                         # unused
    d_col[1:] = base[:-1] + sub[1:]                      # D term at column j
    const = np.maximum(d_col, y_a)                       # valid for j >= 1
    dpm_a0 = int(di[0, ai])
    x_a0 = int(xi[0, ai])
    q = np.empty(L, dtype=np.int64)
    q[0] = max(dpm_a0, x_a0 - o)
    q[1:] = const[1:] - e * jidx[1:]
    M = np.maximum.accumulate(q)
    x_a = o + e * jidx + np.concatenate(([q[0]], M[:-1]))
    x_a[0] = x_a0
    dpm_a = np.maximum(const, x_a)
    dpm_a[0] = dpm_a0
    # selectors: lsel[t] / dsel for column j = t + 1
    lsel = dpm_a[:-1] + o >= x_a[:-1]                    # [L-1]
    dsel = np.where(dpm_a == d_col, 0, np.where(dpm_a == y_a, 1, 2))

    if len(midx):
        # dpm const sources per column (dsel 0 -> D, 1 -> Y)
        Dm = prevD[:, midx] - prevD[:, ai:ai + 1] if delta else prevD[:, midx]
        Dm_sh = np.empty_like(Dm)
        Dm_sh[0] = 0
        Dm_sh[1:] = Dm[:-1]
        Cval = np.where((dsel == 0)[:, None], Dm_sh, Ym)
        CvalFull = Cval
        CvalFull[0] = di[0, midx]
        # x_m[j] = const injected at the largest k <= j (value at k-1)
        inject = np.zeros(L, dtype=bool)
        if L > 1:
            inject[1] = lsel[0]
            if L > 2:
                inject[2:] = lsel[1:] & (dsel[1:-1] != 2)
        src = np.maximum.accumulate(np.where(inject, jidx, 0))
        x_m = np.where(
            (src == 0)[:, None],
            xi[0, midx][None, :],
            np.take_along_axis(CvalFull, np.maximum(src - 1, 0)[:, None], 0),
        )
        dpm_m = np.where(
            (dsel == 0)[:, None], Dm_sh,
            np.where((dsel == 1)[:, None], Ym, x_m),
        )
        xi[1:, midx] = x_m[1:]
        di[1:, midx] = dpm_m[1:]
    xi[1:, ai] = x_a[1:]
    di[1:, ai] = dpm_a[1:]


def fill_fast(
    seq: str, g: PathGraph, sm: ScoreMatrix, o: int, e: int, semiglobal: bool
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row-vectorised :func:`fill` (bit-identical dpm/x/y).

    Non-start rows and single-pred start rows with ta == ai (together
    ~97% of cells on pangenome graphs) are filled with closed-form
    NumPy vector ops (:func:`_fill_row_vec`); multi-pred / ta != ai
    start rows keep the scalar per-cell program (their sequential
    per-pred overwrites, the u_y alphas[i] filter quirk, and the delta
    fixups are row-local and rare).  The in-row affine coupling has the
    standard (max,+) closed form: with const[j] = max(d[j], u[j]),

        x_a[j]   = o + e*j + max_{k<j}(q[k]),   q[k] = const[k] - e*k
        dpm_a[j] = max(const[j], x_a[j])

    (chaining through intermediate dpm cells never beats direct
    extension for o <= 0), so the alpha lane needs one
    ``maximum.accumulate``.  The mask-lane delta copies are pure
    selections driven by the alpha-lane comparisons: x-lane values
    resolve to the most recent "const injection" (a D- or Y-sourced
    dpm value), found with a second ``maximum.accumulate`` over
    injection indices and a gather.  All reference quirks (delta-form
    copies, tie orders d >= u >= l and u_dpm >= u_y) are preserved
    exactly; validated cell-identical to :func:`fill` by tests.
    """
    from .. import scoring

    n = g.n
    L = len(seq)
    P = g.paths_number
    alphas = g.alphas
    pn = g.paths_nodes
    dpm = np.zeros((n, L, P), dtype=np.int64)
    x = np.zeros((n, L, P), dtype=np.int64)
    y = np.zeros((n, L, P), dtype=np.int64)
    if L == 0 or n == 0:
        return dpm, x, y

    codes_l = np.asarray(g.codes, dtype=np.int64)
    codes_s = scoring.encode(seq).astype(np.int64)
    table = np.asarray(sm.table, dtype=np.int64)
    jidx = np.arange(L, dtype=np.int64)

    # row 0: y/dpm alpha lane is the open+extend ladder; the a0+1: lanes
    # copy column j-1 repeatedly from the zero column, i.e. stay 0
    a0 = alphas[0]
    if L > 1:
        y[0, 1:, a0] = o + e * jidx[1:]
        dpm[0, 1:, a0] = y[0, 1:, a0]

    for i in range(1, n - 1):
        if not semiglobal:
            _fill_first_col_gap(dpm, x, g, i, o, e)
        ai = alphas[i]
        sub = table[codes_l[i], codes_s]                     # [L]
        if not g.node_start[i]:
            ap = alphas[i - 1]
            common = pn[i] & pn[i - 1]
            pr, delta = i - 1, not common[ap]
        else:
            blocks = g.preds_and_paths(i)
            easy = False
            if len(blocks) == 1:
                p, p_paths = blocks[0]
                common = pn[i] & p_paths
                ap = alphas[p]
                if ap < P and ((common[ap] and ap == ai)
                               or (not common[ap] and common[ai])):
                    # same cell program as a non-start row (ta == ai,
                    # no fixup, no mask_q quirk), pred row = p
                    pr, delta, easy = p, not common[ap], True
            if not easy:
                for j in range(1, L):
                    _fill_interior(dpm, x, y, g, sm, i, j, seq, o, e)
                continue
        mask = common.copy()
        mask[ai] = False
        midx = np.flatnonzero(mask)
        _fill_row_vec(dpm, x, y, i, pr, ap, ai, delta, midx, sub, o, e, jidx)
    return dpm, x, y


# -- tracebacks ---------------------------------------------------------------


def build_alignment_gap(
    dpm: np.ndarray, x: np.ndarray, y: np.ndarray, g: PathGraph, best_path: int
) -> str:
    """Mirrors build_alignment_gap (pathwise_alignment_output.rs:186-306)."""
    alphas = g.alphas
    nwp = g.node_start
    cigar: list[str] = []
    i = 0
    for node, paths in g.preds_and_paths(g.n - 1):
        if paths[best_path]:
            i = node
    j = dpm.shape[1] - 1

    def abs_at(ii: int, jj: int) -> int:
        if alphas[ii] == best_path:
            return int(dpm[ii, jj, best_path])
        return int(dpm[ii, jj, best_path] + dpm[ii, jj, alphas[ii]])

    while i != 0 and j != 0:
        curr_score = abs_at(i, j)
        predecessor = None
        if not nwp[i]:
            d = abs_at(i - 1, j - 1)
            u = abs_at(i - 1, j)
            l = abs_at(i, j - 1)
        else:
            d = u = l = 0
            for pred, paths in g.preds_and_paths(i):
                if paths[best_path]:
                    predecessor = pred
                    d = abs_at(pred, j - 1)
                    u = abs_at(pred, j)
                    l = abs_at(i, j - 1)
        mx = max(d, u, l)
        if mx == d:
            cigar.append("d" if curr_score < d else "D")
            i = (i - 1) if predecessor is None else predecessor
            j -= 1
        elif mx == u:
            cigar.append("U")
            i = (i - 1) if predecessor is None else predecessor
            # delta-form gap-run comparison, quirk preserved (output.rs:272)
            while dpm[i, j, best_path] < y[i, j, best_path]:
                cigar.append("U")
                if nwp[i]:
                    for pred, paths in g.preds_and_paths(i):
                        if paths[best_path]:
                            predecessor = pred
                else:
                    predecessor = i - 1
                i = predecessor
        else:
            cigar.append("L")
            j -= 1
            while dpm[i, j, best_path] < x[i, j, best_path]:
                cigar.append("L")
                j -= 1
    while j > 0:
        cigar.append("L")
        j -= 1
    while i > 0:
        cigar.append("U")
        i -= 1  # quirk: no pred lookup in this tail (output.rs:299-302)
    cigar.reverse()
    if cigar:
        cigar.pop()  # quirk: last move dropped (output.rs:304)
    return build_cigar(cigar)


def build_alignment_semiglobal_gap(
    dpm: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    g: PathGraph,
    best_path: int,
    end_node: int,
) -> str:
    """Mirrors build_alignment_semiglobal_gap (output.rs:308-451)."""
    alphas = g.alphas
    nwp = g.node_start
    cigar: list[str] = []
    i = end_node
    j = dpm.shape[1] - 1

    def abs_at(ii: int, jj: int) -> int:
        if alphas[ii] == best_path:
            return int(dpm[ii, jj, best_path])
        return int(dpm[ii, jj, best_path] + dpm[ii, jj, alphas[ii]])

    while i != 0 and j != 0:
        curr_score = abs_at(i, j)
        predecessor = None
        if not nwp[i]:
            d = abs_at(i - 1, j - 1)
            u = abs_at(i - 1, j)
            l = abs_at(i, j - 1)
        else:
            d = u = l = 0
            for pred, paths in g.preds_and_paths(i):
                if paths[best_path]:
                    predecessor = pred
                    d = abs_at(pred, j - 1)
                    u = abs_at(pred, j)
                    l = abs_at(i, j - 1)
        mx = max(d, u, l)
        if mx == d:
            cigar.append("d" if curr_score < d else "D")
            i = (i - 1) if predecessor is None else predecessor
            j -= 1
        elif mx == u:
            cigar.append("U")
            i = (i - 1) if predecessor is None else predecessor
            while dpm[i, j, best_path] < y[i, j, best_path]:
                cigar.append("U")
                if nwp[i]:
                    for pred, paths in g.preds_and_paths(i):
                        if paths[best_path]:
                            predecessor = pred
                else:
                    predecessor = i - 1
                i = predecessor
        else:
            cigar.append("L")
            j -= 1
            while dpm[i, j, best_path] < x[i, j, best_path]:
                cigar.append("L")
                j -= 1
    while j > 0:
        cigar.append("L")
        j -= 1
    cigar.reverse()

    starting_node = 0
    while i > 0:
        if nwp[i]:
            for pred, paths in g.preds_and_paths(i):
                if paths[best_path]:
                    i = pred
        else:
            i -= 1
        starting_node += 1
    final_node = 0
    i = end_node
    while i > 0:
        if nwp[i]:
            for pred, paths in g.preds_and_paths(i):
                if paths[best_path]:
                    i = pred
        else:
            i -= 1
        final_node += 1
    return f"{build_cigar(cigar)}\t({starting_node} {final_node})"


def best_ending_node_gap_semi(dpm: np.ndarray, g: PathGraph) -> tuple[int, int]:
    """Mirrors gap_semi's best_ending_node (gap_semi.rs:446-473).

    Differences from mode 5: scans nodes 0..n-2, argmax over *all* path
    entries (tuple max, larger path wins ties).
    """
    mx = None
    ending_node = 0
    chosen_path = 0
    last = dpm.shape[1] - 1
    for i in range(g.n - 1):
        ai = g.alphas[i]
        absolute_scores = dpm[i, last].copy()
        on = g.paths_nodes[i]
        for path in np.flatnonzero(on):
            if path != ai:
                absolute_scores[path] += absolute_scores[ai]
        best_path = max(range(g.paths_number), key=lambda p: (absolute_scores[p], p))
        if mx is None or absolute_scores[best_path] > mx:
            mx = absolute_scores[best_path]
            ending_node = i
            chosen_path = best_path
    return ending_node, chosen_path


# -- entries -------------------------------------------------------------------


def exec_gap_global(
    seq: str, g: PathGraph, sm: ScoreMatrix, o: int, e: int
) -> tuple[int, str]:
    """Mode 6: returns (best_path, cigar string); mirrors gap.rs:4-574."""
    dpm, x, y = fill_fast(seq, g, sm, o, e, semiglobal=False)
    best_path = best_path_gap_global(dpm, g)
    cigar = build_alignment_gap(dpm, x, y, g, best_path)
    return best_path, cigar


def best_path_gap_global(dpm: np.ndarray, g: PathGraph) -> int:
    """Mode 6's best path: each path scores its absolute value in the last
    column of the last pred block of the sink that covers it (0 if none);
    the larger path wins ties."""
    P = g.paths_number
    results = np.zeros(P, dtype=np.int64)
    last = dpm.shape[1] - 1
    for pred, paths in g.preds_and_paths(g.n - 1):
        ap = g.alphas[pred]
        for path in np.flatnonzero(paths):
            if path == ap:
                results[path] = dpm[pred, last, path]
            else:
                results[path] = dpm[pred, last, path] + dpm[pred, last, ap]
    return max(range(P), key=lambda p: (results[p], p))


def exec_gap_semiglobal(
    seq: str, g: PathGraph, sm: ScoreMatrix, o: int, e: int
) -> tuple[int, str]:
    """Mode 7: returns (best_path, cigar+nodes string); mirrors gap_semi.rs:5-444."""
    dpm, x, y = fill_fast(seq, g, sm, o, e, semiglobal=True)
    final_node, best_path = best_ending_node_gap_semi(dpm, g)
    out = build_alignment_semiglobal_gap(dpm, x, y, g, best_path, final_node)
    return best_path, out
