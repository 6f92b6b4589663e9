"""Windowed O(W)-lane long-read fill for pathwise mode 4.

Counterpart of ``recgraph_tpu/ops/pathwise_window.py``: ``_rmin``
(``:65-79``), ``fill_pathwise_win_plain`` (the torch row loop of
``_fill_pathwise_win``, ``:82-259``), ``fill_pathwise_win_best`` (a
CUDA tensor launches ``cuda_pathwise_win``, a CPU tensor runs the plain
version) and ``_final_column_win`` (``:262-270``).

The reference's pathwise DP is full width (pathwise_alignment.rs:16);
this fill stores only W columns per (read, row), centred on the
predecessor rows' best-scoring positions and pulled right to cover
column L - rmin[i], and accumulates a sound exit bound R: every cell
that a successor row's shifted window strands, and each row's
right-edge cell, contributes ``value - smax * column``.  Any alignment
that leaves the window scores at most R + smax * (L - 1); the caller
accepts a read whose windowed best strictly beats that bound, doubles W
for the rest, and reruns what still fails at full width.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scoring import GAP
from . import cuda_pathwise_win
from .poa_engine import NEG

_I32 = torch.int32
OFF = 1 << 16   # the clamp floor of the replayed value (V - Gw >= -OFF)


def _rmin(dg) -> np.ndarray:
    """min over on-lanes of the path length remaining AFTER row i.

    The pathwise analogue of the reference's r-values (utils.rs
    set_r_values): a global alignment on lane p must sit at column
    >= L - remaining(p, i) at row i, so the window must cover it.
    """
    on = dg.host()["paths_on"]                             # [n, P]
    pos = np.cumsum(on, axis=0)                            # rows of p <= i
    totals = on.sum(axis=0)[None, :]
    rrem = np.where(on, totals - pos, 1 << 28)
    r = rrem.min(axis=1)
    return np.minimum(r, 1 << 27).astype(np.int32)


def rmin_tensor(dg) -> torch.Tensor:
    """:func:`_rmin` as an int32[n] tensor on the graph's device."""
    return dg.cached("_rmin", lambda: torch.from_numpy(_rmin(dg)).to(dg.device))


def win_replay_table_plain(Ar, shift, sub, gap, Gw, at0):
    """The per-group table K10's chain warps build (``csrc/pathwise_win.cu``)
    from the group's rep row ``Ar`` int32[..., W] (the rep's plane at the
    group's pred row, in the pred row's window) and ``shift`` int[...] =
    ws - ws[pred]: (src, add, floor) int32[..., W] such that every lane q
    of the group fills

        row_q[k] = floor[k] if src[k] < 0 else max(Aq[src[k]] + add[k], floor[k])

    with Aq its own plane at that pred row, unshifted: src is already
    shifted into the pred row's window (-1 where it falls outside) and
    the clamp ``V - Gw >= -OFF`` of :func:`fill_pathwise_win_plain` is the
    floor Gw[k] - OFF.  ``sub`` is sm(code_i, read code at ws + k), ``gap``
    the node's gap, ``Gw`` the window-local gap sums and ``at0`` where
    ws + k == 0 (all [..., W], broadcast against Ar)."""
    W = Ar.shape[-1]
    sub, Gw, at0 = (t.expand(Ar.shape) for t in (sub, Gw, at0))
    kcol = torch.arange(W, device=Ar.device)
    idx = shift[..., None] + kcol
    ok = (idx >= 0) & (idx < W)
    okm1 = (idx >= 1) & (idx <= W)
    Ar_al = torch.where(ok, Ar.gather(-1, idx.clamp(0, W - 1).long()), NEG)
    Ar_sh = torch.where(okm1, Ar.gather(-1, (idx - 1).clamp(0, W - 1).long()), NEG)
    d = Ar_sh + sub
    u = Ar_al + gap
    x = torch.where(at0, u, torch.maximum(d, u)) - Gw
    rep_row = Gw + torch.cummax(x, dim=-1).values
    dirD = rep_row == d
    nonL = dirD | (rep_row == u) | at0 | (kcol == 0)
    kk = torch.cummax(torch.where(nonL, kcol, -1), dim=-1).values.long()
    formD = (dirD & ~at0).gather(-1, kk)
    src = idx.gather(-1, kk) - formD.to(idx.dtype)
    src = torch.where((src >= 0) & (src < W), src, -1)
    add = torch.where(formD, sub.gather(-1, kk), gap) + Gw - Gw.gather(-1, kk)
    return src.to(_I32), add.to(_I32), (Gw - OFF).to(_I32)


def fill_pathwise_win_plain(dg, table, seq, L, W, rmin):
    """Windowed mode-4 (global) fill, as a torch row loop.

    seq: int32[B, Lp] ('$'-prefixed); L int32[B]; W the window width
    (8 <= W <= Lp); rmin int32[n] (:func:`rmin_tensor`).  Returns

      Aw    int32[B, P, n, W]  windowed per-path absolute scores
      ws    int32[B, n]        per-row window starts (multiples of 8)
      bound int32[B]           R + smax * (L - 1): the most any
                               alignment that leaves the window can score

    The same group-rep semantics as ``pathwise_engine.fill_pathwise_plain``
    (tie order mx == d, mx == u, else L; off-path lanes 0, columns past
    the read NEG).  The replay restarts at the window's first lane too,
    and the replayed value is clamped to ``V - Gw >= -OFF`` with Gw the
    window-local gap sum, as the JAX engine's packed chain clamps it.
    """
    return _fill_win_rows(dg, table, seq, L, W, rmin, False)


def fill_pathwise_win_via_table(dg, table, seq, L, W, rmin):
    """:func:`fill_pathwise_win_plain` with every row replayed from
    :func:`win_replay_table_plain`'s (src, add, floor) table, as K10
    replays it; the same outputs, cell for cell."""
    return _fill_win_rows(dg, table, seq, L, W, rmin, True)


def _fill_win_rows(dg, table, seq, L, W, rmin, via_table):
    h = dg.host()
    n, P = dg.n, dg.paths_number
    B, Lp = seq.shape
    if not 8 <= W <= Lp:
        raise ValueError(f"window width {W} outside [8, {Lp}]")
    dev = seq.device
    tab = table.to(dev, _I32)
    tab_h = tab.cpu().numpy()
    s64 = seq.long()
    L = L.to(_I32)
    rmin_h = rmin.cpu().numpy()
    kcol = torch.arange(W, dtype=_I32, device=dev)
    gseq_full = tab[s64, GAP]                              # [B, Lp]
    smax = max(int(tab_h.max()), 0)
    qdiag = torch.arange(P, device=dev)
    pred = dg.pred_of.long().clamp(min=0)
    rep = dg.rep_of.long().clamp(min=0)

    A = torch.zeros((B, P, n, W), dtype=_I32, device=dev)
    wss = torch.zeros((B, n), dtype=_I32, device=dev)
    bsp = torch.zeros((B, n), dtype=_I32, device=dev)
    # row 0: all paths advance with sm(seq[j], '-') gaps, window at 0;
    # its right-edge cell can L-exit right
    G0 = torch.cumsum(gseq_full[:, :W], 1, dtype=_I32)
    row0 = G0 - G0[:, :1]
    A[:, :, 0, :] = row0[:, None, :]
    R = torch.where(W - 1 < L, row0[:, W - 1] - smax * (W - 1), NEG)

    for i in range(1, n - 1):
        code = int(h["codes"][i])
        gap_i = int(tab_h[code, GAP])
        on = dg.paths_on[i]                                # [P]
        p_i, r_i = pred[i], rep[i]

        # adaptive window: centred on the pred rows' best positions, but
        # covering column L - remaining with W/8 to spare on the right
        pred_bsp = bsp[:, p_i]                             # [B, P]
        ms = torch.where(on, pred_bsp, 1 << 28).min(1).values
        me = torch.where(on, pred_bsp, 0).max(1).values
        center = (ms + me) // 2 + 1
        right_target = torch.maximum(me + 2, L - int(rmin_h[i]) + 2) + W // 8
        ws_i = torch.clamp(torch.maximum(center - W // 2, right_target - W), min=0)
        ws_i = (ws_i // 8) * 8                             # [B]
        jabs = ws_i[:, None] + kcol                        # [B, W]
        in_read = jabs < L[:, None]
        s_w = s64.gather(1, jabs.clamp(max=Lp - 1).long())
        gseq_w = tab[s_w, GAP]
        subrow = tab[code][s_w][:, None, :]                # [B, 1, W]

        # pred windows, realigned to this row's window
        Aq = A[:, qdiag, p_i]                              # [B, P, W]
        Ar = A[:, r_i, p_i]
        ws_p = wss[:, p_i]                                 # [B, P]
        idx = (ws_i[:, None] - ws_p)[:, :, None] + kcol    # [B, P, W]
        ok = (idx >= 0) & (idx < W)
        idx_c = idx.clamp(0, W - 1).long()
        Aq_al = torch.where(ok, Aq.gather(2, idx_c), NEG)
        Ar_al = torch.where(ok, Ar.gather(2, idx_c), NEG)
        okm1 = (idx >= 1) & (idx <= W)
        idx_m1 = (idx - 1).clamp(0, W - 1).long()
        Aq_sh = torch.where(okm1, Aq.gather(2, idx_m1), NEG)
        Ar_sh = torch.where(okm1, Ar.gather(2, idx_m1), NEG)

        # exit bound: pred cells whose U/D moves land outside this row's
        # window (left of it, or at/after its last column)
        jabs_p = ws_p[:, :, None] + kcol                   # [B, P, W]
        wlo = ws_i[:, None, None]
        stranded = ((jabs_p < wlo) | (jabs_p >= wlo + W - 1)) & on[None, :, None] & (
            jabs_p < L[:, None, None]
        )
        R = torch.maximum(R, torch.where(stranded, Aq - smax * jabs_p, NEG).amax(dim=(1, 2)))

        at0 = (jabs == 0)[:, None, :]                      # [B, 1, W]
        Gw = torch.cumsum(gseq_w, 1, dtype=_I32)[:, None, :]   # window-local
        if via_table:
            src, add, floor = win_replay_table_plain(Ar, ws_i[:, None] - ws_p, subrow, gap_i,
                                                     Gw, at0)
            got = torch.maximum(Aq.gather(2, src.clamp(min=0).long()) + add, floor)
            row = torch.where(src < 0, floor, got)
        else:
            row = _replay_row(Aq_al, Aq_sh, Ar_al, Ar_sh, subrow, gap_i, Gw, at0, kcol)
        row = torch.where(on[None, :, None], row, 0)
        row = torch.where(in_read[:, None, :], row, NEG)

        # best-scoring position: rightmost max over on-lanes
        rowv = torch.where(on[None, :, None], row, NEG).amax(1)
        rowv = torch.where(in_read, rowv, NEG)
        rmax = rowv.max(1, keepdim=True).values
        bsp_i = ws_i + torch.where(rowv == rmax, kcol, -1).max(1).values

        # this row's right-edge cell can exit right via an in-row L move
        edge = torch.where(in_read & (kcol == W - 1), rowv - smax * jabs, NEG)
        R = torch.maximum(R, edge.max(1).values)

        A[:, :, i, :] = row
        wss[:, i] = ws_i
        bsp[:, i] = bsp_i
    return A, wss, R + smax * (L - 1)


def _replay_row(Aq_al, Aq_sh, Ar_al, Ar_sh, subrow, gap_i, Gw, at0, kcol):
    """A row's cells of every lane [B, P, W]: its group rep's (max,+)
    chain over the window, then each lane's replay of the rep's moves
    from its own realigned pred window (the XLA engine's form)."""
    d_r = Ar_sh + subrow
    u_r = Ar_al + gap_i
    Achain = torch.where(at0, Ar_al + gap_i, torch.maximum(d_r, u_r))
    rep_row = Gw + torch.cummax(Achain - Gw, dim=2).values
    dirD = rep_row == d_r
    dirU = ~dirD & (rep_row == u_r)
    # the window's first lane restarts the replay too
    nonL = dirD | dirU | at0 | (kcol == 0)

    V = torch.where(dirD, Aq_sh + subrow, Aq_al + gap_i)
    V = torch.where(at0, Aq_al + gap_i, V)
    Vc = torch.clamp(V - Gw, min=-OFF)
    kidx = torch.cummax(torch.where(nonL, kcol, -1), dim=2).values.long()
    return Gw + Vc.gather(2, kidx)


def fill_pathwise_win_best(dg, table, seq, L, W, rmin):
    """Windowed mode-4 fill: the CUDA kernel for CUDA tensors, the plain
    torch version for CPU tensors."""
    if seq.is_cuda:
        return cuda_pathwise_win.fill_pathwise_win_cuda(dg, table, seq, L, W, rmin)
    return fill_pathwise_win_plain(dg, table, seq, L, W, rmin)


def _final_column_win(Aw, ws, L):
    """Aw[:, :, :, L-1 - ws] per read where in-window, else NEG."""
    B, P, n, W = Aw.shape
    rel = (L.long()[:, None] - 1) - ws.long()              # [B, n]
    okc = (rel >= 0) & (rel < W)
    idx = rel.clamp(0, W - 1)[:, None, :, None].expand(B, P, n, 1)
    col = Aw.gather(3, idx)[..., 0]                        # [B, P, n]
    return torch.where(okc[:, None, :], col, NEG)
