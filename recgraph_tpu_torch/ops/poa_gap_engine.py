"""Affine-gap POA fills for modes 2 and 3, and their dispatchers.

Counterpart of ``recgraph_tpu/ops/poa_gap_engine.py``: Gotoh on the
graph (reference: gap_global_abpoa.rs:11-250, gap_local_poa.rs:8-129)
with the in-row (M, X) coupled recurrence

    x[j] = max(x[j-1] + e, m[j-1] + o + e)
    m[j] = max(c[j], x[j])          c[j] = max(d[j], y[j] [, 0])

solved as a 2-state (max,+) affine scan across the row
(``_affine_row_scan``, ``:53-81``).  Cross-row Y and diagonal D
candidates are first-best reductions over predecessor rows in slot order.

- ``fill_gap_global_plain`` ports ``_fill_gap_global`` (``:89-268``) and
  ``fill_gap_global_windowed_plain`` ports ``_fill_gap_global_windowed``
  (``:269-475``): one torch row loop, full width being the window
  [0, Lp);
- ``fill_gap_local_plain`` ports ``_fill_gap_local`` (``:550-686``);
- ``fill_gap_*_best`` (``:687-751``): a CUDA tensor launches the
  hand-written kernel, a CPU tensor runs the plain version, for every
  sign of the penalties; ``fill_gap_global_long`` is the W ladder
  (``:476-548``).

Tie semantics match the reference exactly: mode 2's D/L/U cascade (L
beats U, D beats both) with the out-of-range 'u' code when u_pred == 0
(gap_global_abpoa.rs:143-195), and mode 3's asymmetric Y/M tie rules on
start and non-start rows (gap_local_poa.rs:56-93 vs :131-187).
"""

from __future__ import annotations

import torch

from . import cuda_poa_gap_global, cuda_poa_gap_global_win, cuda_poa_gap_local
from .poa_engine import (
    D, L_DIR, LOW_D, LOW_U, M_DIR, NEG, O, U_DIR, X_DIR, Y_DIR, _I32,
    _first_best, _row_preds, _shift_right, ladder,
)


def _mp_combine(Ma, ba, Mb, bb):
    """Compose two (max,+) affine maps, b after a; clamped to NEG."""
    M = (Mb[..., :, :, None] + Ma[..., None, :, :]).amax(-2)
    v = torch.maximum((Mb + ba[..., None, :]).amax(-1), bb)
    return M.clamp(min=NEG), v.clamp(min=NEG)


def _affine_row_scan(c, v_left, is_left, in_band, o, e):
    """Solve m[j] = max(c[j], x[j]), x[j] = max(x[j-1] + e, m[j-1] + o + e)
    along each row (``_affine_row_scan``, poa_gap_engine.py:62-81).

    c: int32[B, W] chain inputs; v_left: int32[B, 2] (m, x) at the band
    start.  An inclusive doubling scan over the (M, b) maps; integer
    (max,+) is exact, so the order of composition does not change a
    value the fill keeps.  Returns (m_row, x_row) int32[B, W].
    """
    B, W = c.shape
    dev = c.device
    oe = o + e
    M = torch.tensor([[oe, e], [oe, e]], dtype=_I32, device=dev).expand(B, W, 2, 2)
    ident = torch.tensor([[0, NEG], [NEG, 0]], dtype=_I32, device=dev)
    M = torch.where(is_left[..., None, None], NEG, M)
    M = torch.where(in_band[..., None, None], M, ident)
    b = torch.stack([c, torch.full_like(c, NEG)], dim=-1)
    b = torch.where(is_left[..., None], v_left[:, None, :], b)
    b = torch.where(in_band[..., None], b, NEG)
    d = 1
    while d < W:
        Mn, bn = _mp_combine(M[:, :-d], b[:, :-d], M[:, d:], b[:, d:])
        M = torch.cat([M[:, :d], Mn], 1)
        b = torch.cat([b[:, :d], bn], 1)
        d *= 2
    return b[..., 0], b[..., 1]


# ---------------------------------------------------------------------------
# mode 2 - affine-gap global POA, adaptive band (gap_global_abpoa.rs:11-250)
# ---------------------------------------------------------------------------


def fill_gap_global_plain(dg, table, seq, L, bta, o, e, chain=False):
    """Mode-2 fill for a read batch, as a torch row loop.

    Returns (score[B], last_row[B], last_col_abs[B], packed, packed_x,
    packed_y int32[B, n, Lp], lefts int32[B, n], rights int32[B, n]).
    ``chain`` solves each row's (M, X) recurrence as K4 does
    (:func:`x_chain_band_plain`: True, the prefix-max chain; "clamped",
    the clamped chain) instead of the reference's 2x2 map scan.
    """
    return _fill_gap_global_rows(dg, table, seq, L, bta, o, e, seq.shape[1], False,
                                 chain)[:8]


def fill_gap_global_windowed_plain(dg, table, seq, L, bta, o, e, W, chain=False):
    """Mode-2 fill with W-column windowed rows (long reads).

    Returns (score, last_row, last_col_abs, packed, packed_x, packed_y
    int32[B, n, W], lefts, rights, ws int32[B, n], over bool[B]).
    ``chain`` solves each row's (M, X) recurrence as K6 does (K4's chain
    on the row's window, :func:`x_chain_band_plain` with ``ws``).
    """
    return _fill_gap_global_rows(dg, table, seq, L, bta, o, e, W, True, chain)


def _fill_gap_global_rows(dg, table, seq, L, bta, o, e, W, windowed, chain=False):
    """The mode-2 row loop over W stored columns per row; full width is
    the window [0, Lp) (``windowed=False``: ws_i = 0, W = Lp)."""
    h = dg.host()
    n = dg.n
    B, Lp = seq.shape
    dev = seq.device
    tab = table.to(dev, _I32)
    L = L.to(_I32)
    bta = bta.to(_I32)
    kcol = torch.arange(W, dtype=_I32, device=dev)[None, :]
    zb = torch.zeros(B, dtype=_I32, device=dev)

    m = torch.zeros((B, n, W), dtype=_I32, device=dev)
    y = torch.zeros((B, n, W), dtype=_I32, device=dev)
    packed = torch.zeros((B, n, W), dtype=_I32, device=dev)
    packed_x = torch.zeros((B, n, W), dtype=_I32, device=dev)
    packed_y = torch.zeros((B, n, W), dtype=_I32, device=dev)
    lefts = torch.zeros((B, n), dtype=_I32, device=dev)
    rights = torch.zeros((B, n), dtype=_I32, device=dev)
    wss = torch.zeros((B, n), dtype=_I32, device=dev)
    bsp = torch.zeros((B, n), dtype=_I32, device=dev)
    over = torch.zeros(B, dtype=torch.bool, device=dev)

    for i in range(n - 1):
        code = int(h["codes"][i])
        minp = int(h["min_pred"][i])
        r_i = int(h["r_values"][i])
        preds = _row_preds(h, i)

        # --- adaptive band (same as mode 0) ---
        if i == 0:
            ms = me = zb
        else:
            pb = bsp[:, preds]
            ms = pb.min(1).values + 1
            me = pb.max(1).values + 1
        left = torch.clamp(torch.minimum(ms, L - r_i - bta), min=0)
        right = torch.where(
            L > r_i,
            torch.minimum(L, torch.maximum(me, L - r_i) + bta),
            torch.minimum(L, me + bta),
        )
        ws_i = (left // 8) * 8 if windowed else zb
        over |= right - ws_i > W
        jabs = ws_i[:, None] + kcol
        lc, rc = left[:, None], right[:, None]
        in_band = (lc <= jabs) & (jabs < rc)
        is_left = jabs == lc
        s64 = seq.gather(1, jabs.clamp(max=Lp - 1).long()).long()
        sub = tab[code][s64]

        if i == 0:
            # row 0 (":60-66"): y[j] = m[j] = o + e*j, x untouched
            row0 = torch.where(jabs == 0, 0, o + e * jabs)
            m_row = torch.where(in_band, row0, NEG)
            y_row = m_row
            dcode = torch.where(jabs == 0, O, L_DIR)
            packed[:, i] = torch.where(in_band, dcode, 0)
        else:
            # --- Y candidates (":121-141,294-346"): first best over the
            # covering predecessors of m[p][j] + o and of y[p][j] ---
            um_list, uy_list, d_list = [], [], []
            for p in preds:
                idx = (ws_i - wss[:, p])[:, None] + kcol
                lp, rp = lefts[:, p, None], rights[:, p, None]
                cov = (idx >= 0) & (idx < W) & (lp <= jabs) & (jabs < rp)
                d_ok = (idx >= 1) & (idx <= W) & (lp < jabs) & (jabs <= rp)
                ic = idx.clamp(0, W - 1).long()
                um_list.append(torch.where(cov, m[:, p, :].gather(1, ic), NEG))
                uy_list.append(torch.where(cov, y[:, p, :].gather(1, ic), NEG))
                im1 = (idx - 1).clamp(0, W - 1).long()
                d_list.append(torch.where(d_ok, m[:, p, :].gather(1, im1), NEG))
            um_best, um_idx = _first_best(um_list, preds)
            uy_best, uy_idx = _first_best(uy_list, preds)
            covered = um_best > NEG // 2
            um_best = um_best + o
            y_fb = 2 * o + e * (minp + 1) + e * jabs          # ":137"
            from_y = uy_best > um_best                        # strict (":328")
            y_row = torch.where(covered, torch.maximum(um_best, uy_best) + e, y_fb)
            u_pred = torch.where(covered, torch.where(from_y, uy_idx, um_idx), minp)
            y_chain = covered & from_y
            packed_y[:, i] = torch.where(in_band & y_chain, uy_idx * 16 + Y_DIR, 0)

            # --- D candidates (":143-195,252-292") ---
            d_best, d_idx = _first_best(d_list, preds)
            has_d = d_best > NEG // 2
            d_val = d_best + sub

            # --- in-row (M, X) affine scan ---
            c = torch.where(has_d, torch.maximum(d_val, y_row), y_row)
            # band-start state (":55-58" j==0 && left==0; ":104-107" fallback)
            x_left = torch.where(
                left == 0, o + e * (minp + 1), 2 * o + e * (minp + 1) + e * left
            )
            left_rel = (left - ws_i).clamp(0, W - 1).long()[:, None]
            c_left = c.gather(1, left_rel)[:, 0]
            m_left = torch.where(left == 0, x_left, torch.maximum(c_left, x_left))
            v_left = torch.stack([m_left, x_left], dim=-1)
            if chain:   # on the window's absolute columns, the band cut at its end
                m_row, x_row = x_chain_band_plain(c, x_left, left, right, o, e,
                                                  clamped=chain == "clamped", ws=ws_i)
            else:
                m_row, x_row = _affine_row_scan(c, v_left, is_left, in_band, o, e)
            m_row = torch.where(in_band, m_row, NEG)
            y_row = torch.where(in_band, y_row, NEG)

            # path_x plane (":99-120": 'X' iff x[j-1] > m[j-1] + o, j_rel > 0)
            stay_x = (_shift_right(x_row) > _shift_right(m_row) + o) & ~is_left
            packed_x[:, i] = torch.where(in_band & stay_x, i * 16 + X_DIR, 0)
            l_pred = torch.where(is_left, minp, i)

            # --- M directions: the mode-2 cascade (":143-195") ---
            d_lt_l = d_val < x_row
            l_lt_u = x_row < y_row
            d_lt_u = d_val < y_row
            dcode = torch.where(
                d_lt_l,
                torch.where(l_lt_u, torch.where(u_pred == 0, LOW_U, U_DIR), L_DIR),
                torch.where(d_lt_u, U_DIR, torch.where(s64 == code, D, LOW_D)),
            )
            pred_sel = torch.where(
                d_lt_l,
                torch.where(l_lt_u, u_pred, l_pred),
                torch.where(d_lt_u, u_pred, d_idx),
            )
            # no-d branch (":372-378"): l < u => U else L
            dcode = torch.where(has_d, dcode, torch.where(l_lt_u, U_DIR, L_DIR))
            pred_sel = torch.where(has_d, pred_sel, torch.where(l_lt_u, u_pred, l_pred))
            is_base = is_left & (left == 0)[:, None]
            dcode = torch.where(is_base, U_DIR, dcode)
            pred_sel = torch.where(is_base, minp, pred_sel)
            packed[:, i] = torch.where(in_band, pred_sel * 16 + dcode, 0)

        rmax = m_row.max(1, keepdim=True).values
        bsp[:, i] = ws_i + torch.where(m_row == rmax, kcol, -1).max(1).values
        m[:, i] = m_row
        y[:, i] = y_row
        lefts[:, i] = left
        rights[:, i] = right
        wss[:, i] = ws_i

    cand = (n - 2,) + tuple(dg.sink_rows)
    cand_right = rights[:, list(cand)]
    cols = (cand_right - 1 - wss[:, list(cand)]).clamp(0, W - 1).long()
    vals = [m[:, c, :].gather(1, cols[:, k, None])[:, 0] for k, c in enumerate(cand)]
    score, bidx = _first_best(vals, list(range(len(cand))))
    last_row = torch.tensor(cand, dtype=_I32, device=dev)[bidx.long()]
    last_col_abs = cand_right.gather(1, bidx.long()[:, None])[:, 0] - 1
    return (score, last_row, last_col_abs, packed, packed_x, packed_y, lefts, rights,
            wss, over)


# ---------------------------------------------------------------------------
# mode 3 - affine-gap local POA, full matrix (gap_local_poa.rs:8-129)
# ---------------------------------------------------------------------------


def x_chain_band_plain(c, x_left, left, right, o, e, clamped=False, ws=None):
    """The in-row (M, X) recurrence of a band [left, right) from its left
    state, as K4 solves it (K5's is the band [0, Lp) from x = 0; the
    kernel's c~[0] = 0 there gives the same x[1] = g; K6's is K4's on a
    window: ``ws`` int32[B], the window start, makes the W columns of
    ``c`` the absolute columns ws .. ws + W - 1, so the band is cut at the
    window's end and ``left == 0`` stays the read's column 0).

    With g = max(o + e, e), x[left] = x_left and, in the band,
    x[j+1] = max(x[j] + g, c~[j] + o + e), c~[left] = -inf where left = 0
    (m[0] = x_left there), else c~[j] = c[j]; m[j] = max(c[j], x[j])
    (m[left] = x_left where left = 0).  The fast form is a prefix maximum,

        x[j] = j g + max(x_left - left g, max_{left <= k < j} w[k]),
        w[k] = c~[k] + o + e - (k + 1) g;

    the clamped form (``clamped``) applies the maps x -> max(x + g, b)
    one column at a time, every value clamped to NEG as the reference's
    map scan clamps.  ``c`` int32[B, W]; ``x_left``, ``left``, ``right``
    int32[B].  Returns (m_row, x_row) int32[B, W], NEG outside the band.
    """
    B, W = c.shape
    g = max(o + e, e)
    dev = c.device
    j = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    if ws is not None:
        j = j + ws.long()[:, None]
    lc, rc = left.long()[:, None], right.long()[:, None]
    in_band = (j >= lc) & (j < rc)
    c64, xl = c.long(), x_left.long()[:, None]
    ct = torch.where((j == lc) & (lc == 0), -(1 << 62), c64)   # c~
    if clamped:
        x = torch.full((B, W), NEG, dtype=torch.int64, device=dev)
        cur = xl.expand(B, 1).clone()
        for k in range(W):
            kk = j[:, k : k + 1]
            x[:, k : k + 1] = torch.where(kk == lc, xl, cur)
            nxt = torch.maximum(torch.maximum(x[:, k : k + 1] + g, ct[:, k : k + 1] + o + e),
                                torch.full_like(cur, NEG))
            cur = torch.where(kk >= lc, nxt, cur)
    else:
        w = torch.where(in_band, ct + (o + e) - (j + 1) * g, -(1 << 62))
        pre = torch.cummax(w, dim=1).values
        pre = torch.cat([torch.full((B, 1), -(1 << 62), dtype=torch.int64, device=dev),
                         pre[:, :-1]], 1)
        x = j * g + torch.maximum(pre, xl - lc * g)
    m = torch.where(j == lc, torch.where(lc == 0, xl, torch.maximum(c64, xl)),
                    torch.maximum(c64, x))
    return (torch.where(in_band, m, NEG).to(_I32), torch.where(in_band, x, NEG).to(_I32))


def fill_gap_local_plain(dg, table, seq, L, o, e, chain=False):
    """Mode-3 fill for a read batch, as a torch row loop.

    Scores as (seq[j], lnz[i]), the transposed table of
    gap_local_poa.rs:57,137.  Returns (best_val[B], best_i[B], best_j[B],
    packed, packed_x, packed_y int32[B, n, Lp]).  ``chain`` solves each
    row's (M, X) recurrence as K5 does (:func:`x_chain_band_plain` on
    [0, Lp) from x = 0: True, the prefix-max chain; "clamped", the clamped
    chain) instead of the reference's 2x2 map scan; the outputs are the
    same.
    """
    h = dg.host()
    n = dg.n
    B, Lp = seq.shape
    dev = seq.device
    tT = table.to(dev, _I32).T
    s64 = seq.long()
    L = L.to(_I32)
    jcol = torch.arange(Lp, dtype=_I32, device=dev)[None, :]
    valid = jcol < L[:, None]
    is_left = (jcol == 0).expand(B, Lp)
    border0 = (jcol == 0) | ~valid
    neg = torch.full((B, Lp), NEG, dtype=_I32, device=dev)
    zero2 = torch.zeros((B, 2), dtype=_I32, device=dev)
    zb = torch.zeros(B, dtype=_I32, device=dev)
    full_lp = torch.full_like(zb, Lp)

    m = torch.zeros((B, n, Lp), dtype=_I32, device=dev)
    y = torch.zeros((B, n, Lp), dtype=_I32, device=dev)
    packed = torch.zeros((B, n, Lp), dtype=_I32, device=dev)
    packed_x = torch.zeros((B, n, Lp), dtype=_I32, device=dev)
    packed_y = torch.zeros((B, n, Lp), dtype=_I32, device=dev)
    best_val = torch.zeros(B, dtype=_I32, device=dev)
    best_i = torch.zeros(B, dtype=_I32, device=dev)
    best_j = torch.zeros(B, dtype=_I32, device=dev)

    for i in range(1, n - 1):   # row 0 is all zero and all 'O'
        code = int(h["codes"][i])
        sub = tT[code][s64]
        if bool(h["node_start"][i]):
            # first-best quirk: the running max starts at 0 / index 0
            # (gap_local_poa.rs:131-187); padding slots read NEG at index 0
            preds = _row_preds(h, i)
            d_pre, d_arg = _first_best([_shift_right(m[:, p, :]) for p in preds], preds)
            um_pre, um_arg = _first_best([m[:, p, :] for p in preds], preds)
            uy_pre, uy_arg = _first_best([y[:, p, :] for p in preds], preds)
            um_pre = um_pre + o
            d_val = torch.clamp(d_pre, min=0) + sub
            d_idx = torch.where(d_pre > 0, d_arg, 0)
            um_s = torch.clamp(um_pre, min=0)
            uy_s = torch.clamp(uy_pre, min=0)
            from_m = um_s > uy_s                           # ties => Y (":166-171")
            y_row = torch.maximum(um_s, uy_s) + e
            u_idx = torch.where(
                from_m, torch.where(um_pre > 0, um_arg, 0), torch.where(uy_pre > 0, uy_arg, 0)
            )
            py_code = torch.where(from_m, M_DIR, Y_DIR)
        else:
            # non-start rows (":56-73"): plain i-1; ties => M
            m_up, y_up = m[:, i - 1, :], y[:, i - 1, :]
            d_val = _shift_right(m_up) + sub
            d_idx = u_idx = i - 1
            from_y = y_up > m_up + o                       # strict => Y
            y_row = torch.maximum(m_up + o, y_up) + e
            py_code = torch.where(from_y, Y_DIR, M_DIR)

        c = torch.clamp(torch.maximum(d_val, y_row), min=0)
        if chain:
            m_row, x_row = x_chain_band_plain(c, zb, zb, full_lp, o, e, clamped=chain == "clamped")
        else:
            m_row, x_row = _affine_row_scan(c, zero2, is_left, valid, o, e)
        m_row = torch.where(border0, 0, m_row)
        x_row = torch.where(border0, 0, x_row)
        y_row = torch.where(border0, 0, y_row)

        # path_x (":40-54"): X iff x[j-1] > m[j-1] + o (ties => M)
        stay_x = _shift_right(x_row) > _shift_right(m_row) + o
        packed_x[:, i] = torch.where(border0, 0, i * 16 + torch.where(stay_x, X_DIR, M_DIR))
        packed_y[:, i] = torch.where(border0, 0, u_idx * 16 + py_code)

        # M directions with zero floor (":96-110"); tie order D >= U >= L
        all_neg = (d_val < 0) & (y_row < 0) & (x_row < 0)
        d_ge_u = d_val >= y_row
        dirD = d_ge_u & (d_val >= x_row)
        dirU = ~d_ge_u & (y_row >= x_row)
        dcode = torch.where(
            dirD, torch.where(seq == code, D, LOW_D), torch.where(dirU, U_DIR, L_DIR)
        )
        pred_sel = torch.where(dirD, d_idx, torch.where(dirU, u_idx, i))
        packed[:, i] = torch.where(all_neg | border0, O, pred_sel * 16 + dcode)

        # global best, strict > in row-major scan order (":111-117")
        row_masked = torch.where(valid, m_row, neg)
        rmax = row_masked.max(1).values
        rarg = torch.where(row_masked == rmax[:, None], jcol, Lp).min(1).values
        upd = rmax > best_val
        best_val = torch.where(upd, rmax, best_val)
        best_i = best_i.masked_fill(upd, i)
        best_j = torch.where(upd, rarg, best_j)

        m[:, i] = m_row
        y[:, i] = y_row
    return best_val, best_i, best_j, packed, packed_x, packed_y


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def fill_gap_global_best(dg, table, seq, L, bta, o, e):
    """Mode-2 fill: the CUDA kernel for CUDA tensors, the plain torch
    version for CPU tensors.  Returns the eight outputs of
    :func:`fill_gap_global_plain`."""
    if seq.is_cuda:
        return cuda_poa_gap_global.fill_gap_global_cuda(dg, table, seq, L, bta, o, e)
    return fill_gap_global_plain(dg, table, seq, L, bta, o, e)


def fill_gap_global_windowed_best(dg, table, seq, L, bta, o, e, W):
    """Windowed mode-2 fill: the CUDA kernel for CUDA tensors, the plain
    torch version for CPU tensors."""
    if seq.is_cuda:
        return cuda_poa_gap_global_win.fill_gap_global_win_cuda(
            dg, table, seq, L, bta, o, e, W
        )
    return fill_gap_global_windowed_plain(dg, table, seq, L, bta, o, e, W)


def fill_gap_local_best(dg, table, seq, L, o, e):
    """Mode-3 fill: the CUDA kernel for CUDA tensors, the plain torch
    version for CPU tensors.  Returns the six outputs of
    :func:`fill_gap_local_plain`."""
    if seq.is_cuda:
        return cuda_poa_gap_local.fill_gap_local_cuda(dg, table, seq, L, o, e)
    return fill_gap_local_plain(dg, table, seq, L, o, e)


def fill_gap_global_long(dg, table, seq, L, bta, bta_max, o, e, W=None, fits=None):
    """Mode-2 fill for long reads: ``poa_engine.ladder`` over the windowed
    and the full-width fill.  Returns (W, (score, last_row, last_col_abs,
    packed, packed_x, packed_y, lefts, rights, ws | None)), or (W, None)
    where ``fits`` stopped the ladder."""
    return ladder(
        2, dg.n, seq.shape[1], bta_max,
        lambda w: fill_gap_global_windowed_best(dg, table, seq, L, bta, o, e, w),
        lambda: fill_gap_global_best(dg, table, seq, L, bta, o, e), W, fits,
    )
