"""Oracle for POA modes 0-3 (global / local, linear / affine gap).

Copy of ``recgraph_tpu/oracle/poa.py``: the port's ``engine="oracle"``
route and a reference for its tests.

Literal per-cell ports of the reference kernels:

- mode 0: global_abpoa::exec          (global_abpoa.rs:260-427)
- mode 1: local_poa::exec             (local_poa.rs:181-255)
- mode 2: gap_global_abpoa::exec      (gap_global_abpoa.rs:11-250)
- mode 3: gap_local_poa::exec         (gap_local_poa.rs:8-129)

All kernels target the reference's *scalar* (non-AVX2) semantics,
including adaptive-band fallback penalties, tie-breaking (D >= U >= L
via utils::get_max_d_u_l for modes 0/1/3; the distinct D/L/U cascade of
gap_global_abpoa.rs:150-195 for mode 2), and the first-best predecessor
argmax quirks of local modes (local_poa.rs:257-293 initialise the
running max to 0 with index 0).

Each fill returns a ``PoaState`` carrying the banded score rows and the
(pred, dir) traceback matrices consumed by oracle.gaf_emit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..graph.poagraph import PoaGraph, set_ampl_for_row, get_max_d_u_l
from ..scoring import ScoreMatrix


@dataclass
class PoaState:
    score: int
    m: list                      # per-row list[int], band-relative
    path: list                   # per-row list[(pred:int, dir:str)]
    ampl: list                   # per-row (left, right); full-width rows
                                 # for local modes use (0, seq_len)
    last_row: int
    last_col: int                # band-relative column
    band_check_ok: bool = True
    # affine-gap extras (modes 2/3)
    path_x: list = field(default_factory=list)
    path_y: list = field(default_factory=list)


# ---------------------------------------------------------------------------
# mode 0 — global POA, linear gap, adaptive band (global_abpoa.rs:260-427)
# ---------------------------------------------------------------------------


def global_banded(seq: str, g: PoaGraph, sm: ScoreMatrix, bta: int) -> PoaState:
    lnz = g.lnz
    n = g.n
    L = len(seq)
    r_values = g.r_values()
    bsp = [0] * n
    m: list = [None] * n
    path: list = [None] * n
    ampl = [(0, 0)] * n

    for i in range(n - 1):
        p_arr = g.preds[i] if g.node_start[i] else []
        left, right = set_ampl_for_row(i, p_arr, int(r_values[i]), bsp, L, bta)
        ampl[i] = (left, right)
        w = right - left
        mi = [0] * w
        pi = [(0, "O")] * w
        best_val_pos = 0
        for j in range(w):
            if i == 0 and j == 0:
                mi[j] = 0
                pi[j] = (0, "O")
            elif i == 0:
                mi[j] = mi[j - 1] + sm.get("-", seq[j + left])
                pi[j] = (i, "L")
            elif j == 0 and left == 0:
                best_p = g.min_pred(i)
                mi[j] = m[best_p][0] + sm.get("-", lnz[i])
                pi[j] = (best_p, "U")
            else:
                p_arr2 = g.pred_list(i)
                # best l (global_abpoa.rs:326-341,477-484)
                if j > 0:
                    l = mi[j - 1] + sm.get(seq[j + left], "-")
                    l_pred = i
                else:
                    l = sm.get(seq[j + left], "-") * (i + left + j)
                    l_pred = g.min_pred(i)
                # best u (global_abpoa.rs:346-360,528-566)
                u = None
                u_pred = 0
                for p in p_arr2:
                    left_p, right_p = ampl[p]
                    if left_p <= j + left < right_p:
                        j_pos = j + left - left_p
                        cur = m[p][j_pos]
                        if u is None or cur > u:
                            u = cur
                            u_pred = p
                if u is not None:
                    u += sm.get(lnz[i], "-")
                else:
                    u = sm.get(lnz[i], "-") * (i + left + j)
                    u_pred = g.min_pred(i)
                # best d (global_abpoa.rs:362-378,486-526)
                d = None
                d_pred = 0
                for p in p_arr2:
                    left_p, right_p = ampl[p]
                    if left_p < j + left <= right_p:
                        j_pos = j + left - left_p
                        cur = m[p][j_pos - 1]
                        if d is None or cur > d:
                            d = cur
                            d_pred = p
                if d is not None:
                    d += sm.get(lnz[i], seq[j + left])
                else:
                    d = sm.get(lnz[i], "-") * (i + left)
                    d_pred = g.min_pred(i)
                best_val, direction = get_max_d_u_l(d, u, l)
                if direction == "D" and seq[j + left] != lnz[i]:
                    direction = "d"
                mi[j] = best_val
                if direction in ("D", "d"):
                    pi[j] = (d_pred, direction)
                elif direction == "U":
                    pi[j] = (u_pred, "U")
                else:
                    pi[j] = (l_pred, "L")
            if mi[j] >= mi[best_val_pos]:
                best_val_pos = j
        m[i] = mi
        path[i] = pi
        bsp[i] = best_val_pos + left

    # final cell: best over F's predecessors (global_abpoa.rs:397-405)
    last_row = n - 2
    last_col = len(m[last_row]) - 1
    for p in g.preds[n - 1]:
        tmp_last_col = (ampl[p][1] - ampl[p][0]) - 1
        if m[p][tmp_last_col] > m[last_row][last_col]:
            last_row = p
            last_col = tmp_last_col

    ok = _band_ampl_enough(path, ampl, L, last_row, last_col)
    return PoaState(
        score=m[last_row][last_col],
        m=m,
        path=path,
        ampl=ampl,
        last_row=last_row,
        last_col=last_col,
        band_check_ok=ok,
    )


def _band_ampl_enough(path, ampl, seq_len, start_row, start_col) -> bool:
    """Mirrors band_ampl_enough (global_abpoa.rs:428-476)."""
    i, j = start_row, start_col
    while path[i][j][1] != "O":
        left, right = ampl[i]
        if i == 0 or (j == 0 and left == 0):
            return True
        if (j == 0 and left != 0) or (j == right - left - 1 and right != seq_len):
            return False
        pred, direction = path[i][j]
        left_p = ampl[pred][0]
        j_pos = j + left - left_p
        if direction in ("D", "d"):
            j = j_pos - 1
            i = pred
        elif direction == "L":
            j -= 1
        elif direction == "U":
            i = pred
            j = j_pos
        else:
            raise RuntimeError("impossible direction in path")
    return True


# ---------------------------------------------------------------------------
# mode 1 — local POA, full matrix (local_poa.rs:181-255)
# ---------------------------------------------------------------------------


def local_full(seq: str, g: PoaGraph, sm: ScoreMatrix) -> PoaState:
    lnz = g.lnz
    n = g.n
    L = len(seq)
    m = [[0] * L for _ in range(n)]
    path = [[(0, "O")] * L for _ in range(n)]
    best_row = best_col = 0

    for i in range(n - 1):
        for j in range(L):
            if i == 0 or j == 0:
                path[i][j] = (0, "O")
            else:
                l = m[i][j - 1] + sm.get(seq[j], "-")
                l_idx = i
                if not g.node_start[i]:
                    d = m[i - 1][j - 1] + sm.get(seq[j], lnz[i])
                    d_idx = i - 1
                    u = m[i - 1][j] + sm.get("-", lnz[i])
                    u_idx = i - 1
                else:
                    # first-best quirk: running max starts at 0/index 0
                    # (local_poa.rs:257-293, `first` is never true)
                    d, d_idx = 0, 0
                    u, u_idx = 0, 0
                    for p in g.preds[i]:
                        if m[p][j - 1] > d:
                            d = m[p][j - 1]
                            d_idx = p
                        if m[p][j] > u:
                            u = m[p][j]
                            u_idx = p
                    d += sm.get(seq[j], lnz[i])
                    u += sm.get("-", lnz[i])
                if d < 0 and l < 0 and u < 0:
                    m[i][j] = 0
                    path[i][j] = (0, "O")
                else:
                    best_val, direction = get_max_d_u_l(d, u, l)
                    if direction == "D" and lnz[i] != seq[j]:
                        direction = "d"
                    m[i][j] = best_val
                    if direction in ("D", "d"):
                        path[i][j] = (d_idx, direction)
                    elif direction == "U":
                        path[i][j] = (u_idx, "U")
                    else:
                        path[i][j] = (l_idx, "L")
            if m[i][j] > m[best_row][best_col]:
                best_row, best_col = i, j

    return PoaState(
        score=m[best_row][best_col],
        m=m,
        path=path,
        ampl=[(0, L)] * n,
        last_row=best_row,
        last_col=best_col,
    )


# ---------------------------------------------------------------------------
# mode 2 — affine-gap global POA, adaptive band (gap_global_abpoa.rs:11-250)
# ---------------------------------------------------------------------------


def gap_global_banded(
    seq: str, g: PoaGraph, sm: ScoreMatrix, o: int, e: int, bta: int
) -> PoaState:
    lnz = g.lnz
    n = g.n
    L = len(seq)
    r_values = g.r_values()
    bsp = [0] * n
    m: list = [None] * n
    x: list = [None] * n
    y: list = [None] * n
    path: list = [None] * n
    path_x: list = [None] * n
    path_y: list = [None] * n
    ampl = [(0, 0)] * n

    for i in range(n - 1):
        p_arr = g.preds[i] if g.node_start[i] else []
        left, right = set_ampl_for_row(i, p_arr, int(r_values[i]), bsp, L, bta)
        ampl[i] = (left, right)
        w = right - left
        mi, xi, yi = [0] * w, [0] * w, [0] * w
        pi = [(0, "O")] * w
        pxi = [(0, "O")] * w
        pyi = [(0, "O")] * w
        best_val_pos = 0
        for j in range(w):
            if i == 0 and j == 0:
                mi[j] = 0
                pi[j] = (0, "O")
            elif i == 0:
                yi[j] = o + e * (j + left)
                mi[j] = yi[j]
                pi[j] = (i, "L")
            elif j == 0 and left == 0:
                best_p = g.min_pred(i)
                xi[j] = o + e * (best_p + 1)
                mi[j] = xi[j]
                pi[j] = (best_p, "U")
            else:
                p_arr2 = g.pred_list(i)
                # x (within-row gap), gap_global_abpoa.rs:99-120,348-368
                if j > 0:
                    l_x = xi[j - 1]
                    l_m = mi[j - 1] + o
                    if l_x > l_m:
                        xi[j] = l_x + e
                        l_pred = i
                        pxi[j] = (i, "X")
                    else:
                        xi[j] = l_m + e
                        l_pred = i
                else:
                    best_p = g.min_pred(i)
                    xi[j] = 2 * o + e * (best_p + 1) + e * (j + left)
                    l_pred = best_p
                # y (cross-row gap), gap_global_abpoa.rs:121-141,294-346
                u_m = u_y = None
                u_m_idx = u_y_idx = 0
                for p in p_arr2:
                    left_p, right_p = ampl[p]
                    if left_p <= j + left < right_p:
                        j_pos = j + left - left_p
                        cur_m = m[p][j_pos] + o
                        cur_y = y[p][j_pos]
                        if u_m is None:
                            u_m, u_y = cur_m, cur_y
                            u_m_idx = u_y_idx = p
                        else:
                            if cur_m > u_m:
                                u_m = cur_m
                                u_m_idx = p
                            if cur_y > u_y:
                                u_y = cur_y
                                u_y_idx = p
                if u_m is not None:
                    if u_y > u_m:
                        yi[j] = u_y + e
                        u_pred = u_y_idx
                        pyi[j] = (u_y_idx, "Y")
                    else:
                        yi[j] = u_m + e
                        u_pred = u_m_idx
                else:
                    best_p = g.min_pred(i)
                    yi[j] = 2 * o + e * (best_p + 1) + e * (j + left)
                    u_pred = best_p
                # d from m, gap_global_abpoa.rs:143-195,252-292
                d = None
                d_idx = 0
                for p in p_arr2:
                    left_p, right_p = ampl[p]
                    if left_p < j + left <= right_p:
                        j_pos = j + left - left_p
                        cur = m[p][j_pos - 1]
                        if d is None or cur > d:
                            d = cur
                            d_idx = p
                l_val = xi[j]
                u_val = yi[j]
                if d is not None:
                    d += sm.get(lnz[i], seq[j + left])
                    if d < l_val:
                        if l_val < u_val:
                            # 'u' direction quirk (gap_global_abpoa.rs:153-157)
                            pi[j] = (u_pred, "u" if u_pred == 0 else "U")
                            mi[j] = u_val
                        else:
                            pi[j] = (l_pred, "L")
                            mi[j] = l_val
                    else:
                        if d < u_val:
                            pi[j] = (u_pred, "U")
                            mi[j] = u_val
                        else:
                            pi[j] = (
                                d_idx,
                                "D" if lnz[i] == seq[j + left] else "d",
                            )
                            mi[j] = d
                else:
                    if l_val < u_val:
                        pi[j] = (u_pred, "U")
                        mi[j] = u_val
                    else:
                        pi[j] = (l_pred, "L")
                        mi[j] = l_val
            if mi[j] >= mi[best_val_pos]:
                best_val_pos = j
        m[i], x[i], y[i] = mi, xi, yi
        path[i], path_x[i], path_y[i] = pi, pxi, pyi
        bsp[i] = best_val_pos + left

    last_row = n - 2
    last_col = len(m[last_row]) - 1
    for p in g.preds[n - 1]:
        tmp_last_col = (ampl[p][1] - ampl[p][0]) - 1
        if m[p][tmp_last_col] > m[last_row][last_col]:
            last_row = p
            last_col = tmp_last_col

    ok = _gap_band_ampl_enough(path, path_x, path_y, last_row, last_col, ampl, L)
    return PoaState(
        score=m[last_row][last_col],
        m=m,
        path=path,
        ampl=ampl,
        last_row=last_row,
        last_col=last_col,
        band_check_ok=ok,
        path_x=path_x,
        path_y=path_y,
    )


def _gap_band_ampl_enough(path, path_x, path_y, start_row, start_col, ampl, seq_len):
    """Mirrors gap_global_abpoa.rs:371-455."""
    i, j = start_row, start_col
    while path[i][j][1] != "O":
        left, right = ampl[i]
        if i == 0 or (j == 0 and left == 0):
            return True
        if (j == 0 and left != 0) or (j == right - left - 1 and right != seq_len):
            return False
        pred, direction = path[i][j]
        if direction in ("D", "d"):
            left_p = ampl[pred][0]
            j_pos = j + left - left_p
            j = j_pos - 1
            i = pred
        elif direction == "L":
            if path_x[i][j][1] == "X":
                while path_x[i][j][1] == "X" and j > 0:
                    j -= 1
            else:
                j -= 1
        elif direction == "U":
            if path_y[i][j][1] == "Y":
                while path_y[i][j][1] == "Y":
                    left_row = ampl[i][0]
                    p = path_y[i][j][0]
                    left_p = ampl[p][0]
                    j = j + left_row - left_p
                    i = p
            else:
                p = path[i][j][0]
                left_p = ampl[p][0]
                j = j + left - left_p
                i = p
        else:
            return False
    return True


# ---------------------------------------------------------------------------
# mode 3 — affine-gap local POA, full matrix (gap_local_poa.rs:8-129)
# ---------------------------------------------------------------------------


def gap_local_full(
    seq: str, g: PoaGraph, sm: ScoreMatrix, o: int, e: int
) -> PoaState:
    lnz = g.lnz
    n = g.n
    L = len(seq)
    m = [[0] * L for _ in range(n)]
    x = [[0] * L for _ in range(n)]
    y = [[0] * L for _ in range(n)]
    path = [[(0, "O")] * L for _ in range(n)]
    path_x = [[(0, "O")] * L for _ in range(n)]
    path_y = [[(0, "O")] * L for _ in range(n)]
    best_row = best_col = 0

    for i in range(n - 1):
        for j in range(L):
            if i == 0 or j == 0:
                path[i][j] = (0, "O")
                path_x[i][j] = (0, "O")
                path_y[i][j] = (0, "O")
            else:
                # x (gap_local_poa.rs:40-54); ties prefer M
                l_x = x[i][j - 1] + e
                l_m = m[i][j - 1] + o + e
                if l_x > l_m:
                    path_x[i][j] = (i, "X")
                    l = l_x
                else:
                    path_x[i][j] = (i, "M")
                    l = l_m
                x[i][j] = l
                l_idx = i
                # y and d (gap_local_poa.rs:56-93)
                if not g.node_start[i]:
                    d = m[i - 1][j - 1] + sm.get(seq[j], lnz[i])
                    d_idx = i - 1
                    u_y = y[i - 1][j] + e
                    u_m = m[i - 1][j] + o + e
                    u_idx = i - 1
                    if u_y > u_m:
                        path_y[i][j] = (u_idx, "Y")
                        u = u_y
                    else:
                        path_y[i][j] = (u_idx, "M")
                        u = u_m
                    y[i][j] = u
                else:
                    # first-best quirk: running max starts at 0/index 0
                    # (gap_local_poa.rs:131-187, `first` is never true)
                    d, d_idx = 0, 0
                    u_m, u_y = 0, 0
                    u_m_idx = u_y_idx = 0
                    for p in g.preds[i]:
                        if m[p][j - 1] > d:
                            d = m[p][j - 1]
                            d_idx = p
                        if m[p][j] + o > u_m:
                            u_m = m[p][j] + o
                            u_m_idx = p
                        if y[p][j] > u_y:
                            u_y = y[p][j]
                            u_y_idx = p
                    d += sm.get(seq[j], lnz[i])
                    if u_m > u_y:
                        u, u_idx, from_m = u_m, u_m_idx, True
                    else:
                        u, u_idx, from_m = u_y, u_y_idx, False
                    u += e
                    y[i][j] = u
                    path_y[i][j] = (u_idx, "M" if from_m else "Y")
                # m with zero floor (gap_local_poa.rs:96-110)
                if d < 0 and l < 0 and u < 0:
                    m[i][j] = 0
                    path[i][j] = (0, "O")
                else:
                    best_val, direction = get_max_d_u_l(d, u, l)
                    if direction == "D" and lnz[i] != seq[j]:
                        direction = "d"
                    m[i][j] = best_val
                    if direction in ("D", "d"):
                        path[i][j] = (d_idx, direction)
                    elif direction == "U":
                        path[i][j] = (u_idx, "U")
                    else:
                        path[i][j] = (l_idx, "L")
            if m[i][j] > m[best_row][best_col]:
                best_row, best_col = i, j

    return PoaState(
        score=m[best_row][best_col],
        m=m,
        path=path,
        ampl=[(0, L)] * n,
        last_row=best_row,
        last_col=best_col,
        path_x=path_x,
        path_y=path_y,
    )
