"""Windowed O(W)-lane long-read fills for recombination mode 8 (the opt-in
``RECGRAPH_REC_WINDOW=1`` route of ``recombination_engine.run_batch_walks``).

Counterpart of ``recgraph_tpu/ops/recombination_window.py``:

- ``fill_pathwise_rev_win_plain`` ports ``_fill_pathwise_rev_win``
  (``:67-262``) as a torch row loop; ``fill_pathwise_rev_win_best``: a
  CUDA tensor launches the hand-written kernel S2
  (``cuda_pathwise_rev_win``, the reverse form of K10's kernel), a CPU
  tensor runs the plain version;
- ``full_from_win`` (``:265-276``) and ``composite_bound`` (``:279-295``).

The forward matrix of mode 8 is mode 4's, so its windowed fill is
``pathwise_window.fill_pathwise_win_best`` (K10) unchanged.  The reverse
fill mirrors it over the reverse graph: rows n-2..1 read their successor
rows, the rep chains are suffix (max,+) scans, each row's window sits
left of the centre of its successors' best positions (leftmost best),
and the exit account collects the successor cells a window strands and
each row's left-edge cell, normalised by ``smax * (L - 1 - column)``:

    any suffix alignment that leaves the windows scores at most
    rev(k, j) <= Rr + smax * (L - 1 - j).

``composite_bound`` extends the exit guard to the split objective
fwd(i, j) + rec + rev(k, j + 1); the caller accepts a read whose
windowed best strictly beats it, doubles W for the rest, and reruns what
still fails at full width.  Mode 9 has no windowed route: its endings
make the exit bound vacuous.
"""

from __future__ import annotations

import torch

from ..scoring import GAP, SENTINEL
from . import cuda_pathwise_rev_win
from .poa_engine import NEG

_I32 = torch.int32
OFF = 1 << 16   # the clamp floor of the replayed value (V - Gs >= -OFF)


def _suffix_cummax(x):
    return torch.cummax(x.flip(-1), dim=-1).values.flip(-1)


def rev_win_replay_table_plain(Ar, shift, sub, gap, Gs, jabs, L):
    """The per-group table S2's chain warps build (``csrc/pathwise_win.cu``)
    from the group's rep row ``Ar`` int32[..., W] (the rep's plane at the
    group's successor row, in that row's window) and ``shift`` int[...] =
    ws - ws[succ]: (src, add, floor) int32[..., W] such that every lane q
    of the group fills

        row_q[k] = floor[k] if src[k] < 0 else max(Aq[src[k]] + add[k], floor[k])

    with Aq its source plane at that row, unshifted.  ``sub`` is
    sm(code_i, reverse read code at ws + k), ``Gs`` the read's suffix gap
    sums at ws + k, ``jabs`` = ws + k and ``L`` the read lengths (all
    broadcast against Ar).  With x[k] the rep's candidate minus Gs[k], a
    column moves D or U iff x[k] reaches the max of x over [k, W): the
    nearest such column at or after k is the first position of that
    max, one scan of (x, W - 1 - k) keys; column L - 1 restarts."""
    W = Ar.shape[-1]
    sub, Gs, jabs = (t.expand(Ar.shape) for t in (sub, Gs, jabs))
    kcol = torch.arange(W, device=Ar.device)
    L = L.long()
    idx = shift[..., None] + kcol

    def at(ix):
        return torch.where((ix >= 0) & (ix < W), Ar.gather(-1, ix.clamp(0, W - 1)), NEG)

    d, u = at(idx + 1) + sub, at(idx) + gap
    last = jabs == L - 1
    a = torch.where(last, u, torch.where(jabs < L, torch.maximum(d, u), NEG))
    key = (a - Gs).long() * (1 << 32) + (W - 1 - kcol)
    key = torch.cummax(key.flip(-1), dim=-1).values.flip(-1)
    kk = W - 1 - torch.remainder(key, 1 << 32)
    rcol = L - 1 - (jabs - kcol)                           # column L - 1 in the window
    kk = torch.where((kcol <= rcol) & (kk > rcol), rcol, kk)
    formD = (kk != rcol) & (d.gather(-1, kk) >= u.gather(-1, kk))
    src = idx.gather(-1, kk) + formD.long()
    src = torch.where((src >= 0) & (src < W), src, -1)
    add = torch.where(formD, sub.gather(-1, kk), gap) + Gs - Gs.gather(-1, kk)
    return src.to(_I32), add.to(_I32), (Gs - OFF).to(_I32)


def fill_pathwise_rev_win_plain(dgr, table, seq, L, W, via_table=False):
    """Windowed mode-8 reverse fill over the reverse graph ``dgr``, as a
    torch row loop.

    ``seq`` is the forward '$'-prefixed read int32[B, Lp]; L int32[B]; W
    the window width (8 <= W; W may pass Lp).  Returns

      Awr  int32[B, P, n, W]  windowed reverse scores (off-path and
                              constant-0 lanes 0, column 0 0, columns
                              past the read NEG; row 0 all 0, row n-1
                              the suffix gap chain on path 0's plane)
      wsr  int32[B, n]        each row's window start (a multiple of 8)
      Rr   int32[B]           the normalised exit account

    Each row's rep lanes run the suffix (max,+) chain over the window
    (restart at column L - 1 from the successor's column L - 1 plus the
    gap, and at the window's last lane); every lane replays its rep's
    moves from the nearest non-L column at or after j, the value clamped
    to ``V - Gs >= -OFF`` with Gs the read's suffix gap sums, as the JAX
    engine's packed chain clamps it.  ``via_table`` replays every row
    from :func:`rev_win_replay_table_plain`'s table, as S2 replays it: the
    same outputs, cell for cell.
    """
    h = dgr.host()
    n, P = dgr.n, dgr.paths_number
    B, Lp = seq.shape
    if W < 8:
        raise ValueError(f"window width {W} below 8")
    dev = seq.device
    tab = table.to(dev, _I32)
    tab_h = tab.cpu().numpy()
    L = L.to(dev).long()
    kcol = torch.arange(W, device=dev)
    jfull = torch.arange(Lp, device=dev)
    rev = torch.where(jfull[None, :] == (L - 1)[:, None], SENTINEL,
                      torch.roll(seq, -1, dims=1)).long()
    in_read_full = jfull[None, :] < L[:, None]
    gseq = torch.where(in_read_full, tab[rev, GAP], 0)
    Gs_full = torch.cumsum(gseq.flip(1), 1, dtype=_I32).flip(1)   # suffix sums
    smax = max(int(tab_h.max()), 0)
    hi = max(Lp - W, 0)

    def window(arr, ws):
        """arr [B, Lp] at columns ws + k (clipped to Lp - 1) -> [B, W]."""
        return arr.gather(1, (ws[:, None] + kcol).clamp(max=Lp - 1))

    pred = dgr.pred_of.long()
    rep = dgr.rep_of.long().clamp(min=0)
    p_safe = pred.clamp(min=0)
    qsrc = dgr.qsrc_of.long() if dgr.qsrc_of is not None else \
        torch.arange(P, device=dev).expand(n, P)
    q_safe = qsrc.clamp(min=0)

    A = torch.zeros((B, P, n, W), dtype=_I32, device=dev)
    wss = torch.zeros((B, n), dtype=torch.long, device=dev)
    bsp = torch.zeros((B, n), dtype=torch.long, device=dev)
    # row n-1: the suffix gap chain on every lane, window at the right end
    ws_n1 = ((L - W).div(8, rounding_mode="floor") * 8).clamp(0, hi)
    jabs0 = ws_n1[:, None] + kcol
    rn1 = torch.where((jabs0 > 0) & (jabs0 < L[:, None]), window(Gs_full, ws_n1), 0)
    rn1 = torch.where(jabs0 >= L[:, None], NEG, rn1)
    A[:, :, n - 1, :] = rn1[:, None, :]
    wss[:, n - 1] = ws_n1
    bsp[:, n - 1] = L - 1
    # row n-1's left-edge cell can exit left
    Rr = torch.where(ws_n1 > 0, rn1[:, 0] - smax * (L - 1 - ws_n1), NEG)

    for i in range(n - 2, 0, -1):
        code = int(h["codes"][i])
        gap_i = int(tab_h[code, GAP])
        on = dgr.paths_on[i]                                # [P]
        p_i = p_safe[i]

        # the window: left of the centre of the successors' best
        # positions, keeping W/8 to spare left of the leftmost
        pred_bsp = bsp[:, p_i]                              # [B, P]
        ms = torch.where(on, pred_bsp, 1 << 28).min(1).values
        me = torch.where(on, pred_bsp, 0).max(1).values
        center = (ms + me).div(2, rounding_mode="floor") - 1
        left_target = torch.minimum(ms - 2, center) - W // 8
        ws_i = torch.minimum(center - W // 2, left_target).clamp(0, hi)
        ws_i = ws_i.div(8, rounding_mode="floor") * 8       # [B]
        jabs = ws_i[:, None] + kcol                         # [B, W]
        in_read = jabs < L[:, None]
        is_last = (jabs == (L - 1)[:, None])[:, None, :]
        Gs_w = window(Gs_full, ws_i)[:, None, :]            # [B, 1, W]
        subrow = tab[code][window(rev, ws_i)][:, None, :]

        # successor windows, realigned to this row's
        Aq = A[:, q_safe[i], p_i]                           # [B, P, W]
        Ar = A[:, rep[i], p_i]
        ws_p = wss[:, p_i]                                  # [B, P]
        idx = (ws_i[:, None] - ws_p)[:, :, None] + kcol     # [B, P, W]

        def at(X, ix):
            ok = (ix >= 0) & (ix < W)
            return torch.where(ok, X.gather(2, ix.clamp(0, W - 1)), NEG)

        Aq_al, Ar_al = at(Aq, idx), at(Ar, idx)
        Aq_sh, Ar_sh = at(Aq, idx + 1), at(Ar, idx + 1)     # the D read: column j + 1

        # exit account: successor cells whose moves land outside this
        # row's window
        jabs_p = ws_p[:, :, None] + kcol                    # [B, P, W]
        wlo = ws_i[:, None, None]
        stranded = ((jabs_p <= wlo) | (jabs_p >= wlo + W)) & on[None, :, None] & (
            jabs_p >= 1) & (jabs_p < L[:, None, None])
        norm = torch.where(stranded, Aq - smax * (L[:, None, None] - 1 - jabs_p), NEG)
        Rr = torch.maximum(Rr, norm.amax(dim=(1, 2)))

        # rep lanes: the suffix (max,+) chain; column L - 1 restarts from
        # the successor's column L - 1 plus the gap (= Ar_al + gap there)
        d_r = Ar_sh + subrow
        u_r = Ar_al + gap_i
        Achain = torch.where(is_last, u_r, torch.maximum(d_r, u_r))
        Achain = torch.where(in_read[:, None, :], Achain, NEG)
        rep_row = Gs_w + _suffix_cummax(Achain - Gs_w)
        dirD = rep_row == d_r
        dirU = ~dirD & (rep_row == u_r)
        # the window's last lane restarts the replay (chains crossing it
        # are lost: an underestimate the guard covers)
        nonL = dirD | dirU | is_last | (kcol == W - 1)

        # every lane replays its rep's moves from the nearest non-L
        # column at or after j
        if via_table:
            src, add, floor = rev_win_replay_table_plain(
                Ar, ws_i[:, None] - ws_p, subrow, gap_i, Gs_w, jabs[:, None, :], L[:, None, None])
            got = torch.maximum(Aq.gather(2, src.clamp(min=0).long()) + add, floor)
            row = torch.where(src < 0, floor, got)
        else:
            V = torch.where(dirD & ~is_last, Aq_sh + subrow, Aq_al + gap_i)
            Vc = torch.clamp(V - Gs_w, min=-OFF)
            kidx = (-_suffix_cummax(torch.where(nonL, -kcol, -W))).clamp(0, W - 1)
            row = Gs_w + Vc.gather(2, kidx)
        row = torch.where((on & (qsrc[i] >= 0))[None, :, None], row, 0)
        row = torch.where(in_read[:, None, :], row, NEG)
        row = torch.where((jabs == 0)[:, None, :], 0, row)  # column 0 is 0

        # best position: the leftmost max over on-lanes at column >= 1
        rowv = torch.where(on[None, :, None], row, NEG).amax(1)
        rowv = torch.where(in_read & (jabs >= 1), rowv, NEG)
        bsp_i = ws_i + rowv.argmax(1)   # torch's argmax: the first max

        # the row's left-edge cell can exit left via in-row moves
        edge = torch.where((jabs >= 1) & in_read & (kcol == 0),
                           rowv - smax * (L[:, None] - 1 - jabs), NEG)
        Rr = torch.maximum(Rr, edge.amax(1))

        A[:, :, i, :] = row
        wss[:, i] = ws_i
        bsp[:, i] = bsp_i
    # row n-1: only the alpha plane keeps the chain (the reference's
    # delta quirk)
    A[:, 1:, n - 1, :] = 0
    return A, wss.to(_I32), Rr.to(_I32)


def fill_pathwise_rev_win_best(dgr, table, seq, L, W):
    """Windowed mode-8 reverse fill: the S2 kernel for CUDA tensors, the
    plain torch version for CPU tensors; any other device raises."""
    if seq.is_cuda:
        return cuda_pathwise_rev_win.fill_pathwise_rev_win_cuda(dgr, table, seq, L, W)
    if seq.device.type != "cpu":
        raise ValueError(f"reverse window fill: no kernel for {seq.device.type} tensors")
    return fill_pathwise_rev_win_plain(dgr, table, seq, L, W)


def full_from_win(Xw, ws, fill, Lp):
    """Windowed [B, n, W] with starts ws [B, n] -> full width [B, n, Lp],
    ``fill`` (a scalar) outside the windows."""
    B, n, W = Xw.shape
    idx = torch.arange(Lp, device=Xw.device)[None, None, :] - ws.long()[:, :, None]
    ok = (idx >= 0) & (idx < W)
    v = Xw.gather(2, idx.clamp(0, W - 1))
    return torch.where(ok, v, torch.as_tensor(fill, dtype=Xw.dtype, device=Xw.device))


def composite_bound(F, G, Rf, Rr, L, smax):
    """Upper bound on any mode-8 candidate that touches an out-of-window
    cell: f32[B].  F/G int32[B, Lp]: the exact windowed per-column maxima
    of the forward / reverse matrices over the interior rows (NEG where
    no window covers the column); Rf/Rr int32[B] the normalised exit
    accounts; ``smax`` the table's largest score (at least 0)."""
    B, Lp = F.shape
    j = torch.arange(Lp, device=F.device)[None, :]
    L = L.long()[:, None]
    in_f = (j < L - 1) & (j >= 1)
    Gp1 = torch.roll(G, -1, dims=1)                         # G(j + 1)
    Gp1[:, -1] = NEG
    t1 = (Rf[:, None] + smax * j) + Gp1
    t2 = F + (Rr[:, None] + smax * (L - 2 - j))
    both = Rf + Rr + smax * (L[:, 0] - 1)
    t = torch.where(in_f, torch.maximum(t1, t2), NEG)
    return torch.maximum(t.amax(1), both).to(torch.float32)
