"""On-device traceback for POA modes 0-3.

Counterpart of ``recgraph_tpu/ops/traceback_engine.py:45-222``
(``walk_poa``, ``pack_walk32``, ``unpack_walk``, ``compact_walk``,
``max_walk_steps``).  The JAX walk is an XLA ``while_loop``; here it is a
host-driven loop of batched torch ops on the planes' device, so only the
compact walk crosses to the host:

    dirs  int32[B, W]   direction code per loop iteration (HOLE = no step)
    rows  int32[B, W]   graph row at each step (before the move)
    steps int32[B]      emitted step count
    stop_row/stop_col   where the walk terminated ('O' cell)

Moves are in ABSOLUTE read columns: D/L decrement the column, D/U move
to the packed predecessor row.  The gap chains of modes 2/3, windowed
planes (long reads) and the in-walk band check are ported.
``walk_local_scores`` ports the mode-1 walk over score planes that
goes with the scores-only fill (``tools/pallas_poa_v3.py:212``).
"""

from __future__ import annotations

import numpy as np
import torch

HOLE = 31   # non-emitting loop iterations write this code; compacted on host
CHAIN_FLAG = 16  # set on steps emitted inside an X/Y gap chain
O, D, LOW_D, L_DIR, U_DIR, X_DIR, Y_DIR = range(7)  # poa_engine's codes (it imports this module)

# walks end on every lane long before max_steps; testing for that costs
# a device sync, so it is tested every CHECK_EVERY iterations (only the
# returned iteration count changes, never the walk)
CHECK_EVERY = 64


def pack_walk32(dirs, rows):
    """One int32 (row << 5 | dir) per step for the device->host copy."""
    return (rows << 5) | dirs


def unpack_walk(pk):
    pk = np.asarray(pk).astype(np.int32)
    return pk & 31, pk >> 5


def compact_walk(dirs_b, rows_b, ns):
    """Strip HOLE columns from one read's walk and cut it to its step
    count."""
    keep = dirs_b != HOLE
    d = np.ascontiguousarray(dirs_b[keep][:ns])
    r = np.ascontiguousarray(rows_b[keep][:ns])
    return d, r


def walk_poa(packed, last_row, last_col_abs, max_steps, band=None, ws=None,
             packed_x=None, packed_y=None):
    """Walk int32[B, n, W] packed planes back from (last_row, last_col).

    ``packed_x``/``packed_y`` (modes 2/3) turn on the gap chains: an L
    step onto an 'X' cell of packed_x enters an X chain that moves left
    while packed_x says 'X'; a U step onto a 'Y' cell of packed_y enters
    a Y chain that moves to packed_y's predecessor while it says 'Y'.
    Chain-interior steps carry ``CHAIN_FLAG``.

    ``ws`` int32[B, n] (windowed planes): cell (row, col) is stored at
    lane col - ws[row]; lanes outside [0, W) read 0 (= O), as a
    full-width plane's out-of-band cells do.

    ``band`` (lefts int32[B, n], rights int32[B, n], seq_len int32[B])
    runs the band-exhaustion check inside the walk, as
    native/gaf_emit.cpp:375-429 replays it: the first decisive cell
    wins; accept at row 0 or at (col 0 with left 0), fail at a band
    border that is not the read border; chain-interior cells are
    skipped.

    Returns (dirs, rows, steps, stop_row, stop_col, band_ok | None,
    query_start, iterations); query_start = stop_col - lefts[stop_row]
    (stop_col without ``band``).
    """
    B, n, W = packed.shape
    dev = packed.device
    gap = packed_x is not None
    planes = [packed.reshape(B, n * W)]
    if gap:
        planes += [packed_x.reshape(B, n * W), packed_y.reshape(B, n * W)]
    row = last_row.long()
    col = last_col_abs.long()
    ws64 = None if ws is None else ws.long()
    chain = torch.zeros(B, dtype=torch.int32, device=dev)   # 0 none, 1 X, 2 Y
    k = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    verdict = torch.zeros(B, dtype=torch.int32, device=dev)
    dirs = torch.full((B, max_steps), -1, dtype=torch.int32, device=dev)
    rows = torch.zeros((B, max_steps), dtype=torch.int32, device=dev)
    it = 0
    while it < max_steps:
        if it % CHECK_EVERY == 0 and bool(done.all()):
            break
        if ws64 is None:
            idx, inside = row * W + col, None
        else:
            rel = col - ws64.gather(1, row[:, None])[:, 0]
            inside = (rel >= 0) & (rel < W)
            idx = row * W + rel.clamp(0, W - 1)
        cells = [pl.gather(1, idx[:, None])[:, 0] for pl in planes]
        if inside is not None:
            cells = [torch.where(inside, cl, 0) for cl in cells]
        c = cells[0]
        dir_ = c & 15
        dispatch = chain == 0
        is_o = dispatch & (dir_ == O)
        done_new = done | is_o
        live = dispatch & ~done_new
        is_d = live & ((dir_ == D) | (dir_ == LOW_D))
        is_l = live & (dir_ == L_DIR)
        is_u = live & (dir_ == U_DIR)
        if gap:
            cx, cy = cells[1], cells[2]
            px_is_x = (cx & 15) == X_DIR
            py_is_y = (cy & 15) == Y_DIR
            enter_x = is_l & px_is_x
            enter_y = is_u & py_is_y
            x_cont = (chain == 1) & px_is_x
            y_cont = (chain == 2) & py_is_y
            x_exit = (chain == 1) & ~px_is_x
            y_exit = (chain == 2) & ~py_is_y
            is_l = is_l & ~enter_x
            is_u = is_u & ~enter_y
            code = torch.where(is_d, dir_, 0)
            code = torch.where(is_l | enter_x, L_DIR, code)
            code = torch.where(is_u | enter_y, U_DIR, code)
            code = torch.where(x_cont, L_DIR + CHAIN_FLAG, code)
            code = torch.where(y_cont, U_DIR + CHAIN_FLAG, code)
            move_col = is_d | is_l | enter_x | x_cont
            to_pred = is_d | is_u
            to_ypred = enter_y | y_cont
        else:
            code = dir_
            move_col = is_d | is_l
            to_pred = is_d | is_u
            to_ypred = None
        emit = ~done & (move_col | to_pred | (to_ypred if gap else False))
        dirs[:, it] = torch.where(emit, code, HOLE)
        rows[:, it] = torch.where(emit, row, 0)
        if band is not None:
            lefts, rights, seq_len = band
            at_step = emit | (is_o & ~done)
            if gap:
                at_step = at_step & ((is_o & ~done) | ((code & CHAIN_FLAG) == 0))
            left = lefts.gather(1, row[:, None])[:, 0]
            right = rights.gather(1, row[:, None])[:, 0]
            jrel = col - left
            acc = (row == 0) | ((jrel == 0) & (left == 0))
            fail = ((jrel == 0) & (left != 0)) | (
                (jrel == right - left - 1) & (right != seq_len)
            )
            new_v = torch.where(acc, 1, torch.where(fail, 2, 0))
            verdict = torch.where(
                (verdict == 0) & at_step & (new_v != 0), new_v, verdict
            )
        col = col - move_col.long()
        row = torch.where(to_pred, (c >> 4).long(), row)
        if gap:
            row = torch.where(to_ypred, (cells[2] >> 4).long(), row)
            chain = torch.where(enter_x, 1, torch.where(enter_y, 2, chain))
            chain = torch.where(x_exit | y_exit, 0, chain)
        k = k + emit.to(torch.int32)
        done = done_new
        it += 1
    row32, col32 = row.to(torch.int32), col.to(torch.int32)
    if band is None:
        return dirs, rows, k, row32, col32, None, col32, it
    qstart = col32 - band[0].gather(1, row[:, None])[:, 0]
    return dirs, rows, k, row32, col32, verdict != 2, qstart, it


def walk_local_scores(m, seq, table, node_start, codes, pred_idx, best_i, best_j,
                      max_steps):
    """Mode-1 walk over score planes (the scores-only fill, K16), re-deriving
    each step's direction from the scores.

    Port of ``tools/pallas_poa_v3.py:212 walk_local_scores`` (an XLA
    ``fori_loop`` there, a host-driven loop of batched torch ops on the
    planes' device here).  ``m`` int32[n_pad, B, Lp] (read axis 1), as
    ``poa_variants.fill_local_scores`` returns it; ``pred_idx``
    int32[n, Pm] with -1 padding.  Each step recomputes the fill's d, u
    and l with its tie rules, including the start-row first-best quirk
    (local_poa.rs:257-293), so the walk equals ``walk_poa``'s over the
    packed planes.  A lane stops at row 0, column 0 or an all-negative
    cell.  Returns (dirs int32[B, max_steps] (-1 past the last step),
    rows int32[B, max_steps] (0 past it), steps, row, col).  Once every
    lane has stopped nothing changes, so the loop ends there (tested
    every CHECK_EVERY iterations).
    """
    n_pad, B, Lp = m.shape
    dev = m.device
    i32 = torch.int32
    NEG = -(1 << 28)                    # poa_engine.NEG
    mf = m.reshape(-1)                  # cell (i, b, j) at i * B * Lp + b * Lp + j
    base = torch.arange(B, device=dev, dtype=torch.long) * Lp
    tab = table.to(dev, i32)
    tT = tab.t()
    s64 = seq.long()
    gap = 5                             # scoring.GAP
    node_start = node_start.to(dev).bool()
    codes = codes.to(dev).long()
    pred_idx = pred_idx.to(dev, i32)
    Pm = pred_idx.shape[1]
    neg = torch.tensor(NEG, dtype=i32, device=dev)

    def at(i, j):
        v = mf[i.long() * (B * Lp) + base + j.clamp(min=0).long()]
        return torch.where(j >= 0, v, neg)

    row, col = best_i.to(i32).clone(), best_j.to(i32).clone()
    k = torch.zeros(B, dtype=i32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    dirs = torch.full((B, max_steps), -1, dtype=i32, device=dev)
    rows = torch.zeros((B, max_steps), dtype=i32, device=dev)
    bidx = torch.arange(B, device=dev)
    for it in range(max_steps):
        if it % CHECK_EVERY == 0 and bool(done.all()):
            break
        border = (row == 0) | (col == 0)
        active = ~done & ~border
        r64 = row.long()
        is_start = node_start[r64]
        code_i = codes[r64]
        seq_j = s64.gather(1, col.clamp(min=0).long()[:, None])[:, 0]
        sub = tT[code_i, seq_j]
        gnode = tT[code_i, gap]
        gseq = tab[seq_j, gap]

        d_pre = torch.full((B,), NEG, dtype=i32, device=dev)
        u_pre = d_pre.clone()
        d_arg = torch.zeros(B, dtype=i32, device=dev)
        u_arg = d_arg.clone()
        prow = pred_idx[r64]                                  # [B, Pm]
        for p in range(Pm):
            pidx = prow[:, p]
            ok = pidx >= 0
            ps = pidx.clamp(min=0)
            pv = torch.where(pidx == 0, 0, at(ps, col))
            upd = ok & (pv > u_pre)
            u_arg = torch.where(upd, pidx, u_arg)
            u_pre = torch.where(upd, pv, u_pre)
            pv_sh = torch.where(pidx == 0, torch.where(col >= 1, 0, neg), at(ps, col - 1))
            upd = ok & (pv_sh > d_pre)
            d_arg = torch.where(upd, pidx, d_arg)
            d_pre = torch.where(upd, pv_sh, d_pre)

        d_val = torch.where(is_start, d_pre.clamp(min=0), d_pre) + sub
        u_val = torch.where(is_start, u_pre.clamp(min=0), u_pre) + gnode
        d_idx = torch.where(is_start, torch.where(d_pre > 0, d_arg, 0), row - 1)
        u_idx = torch.where(is_start, torch.where(u_pre > 0, u_arg, 0), row - 1)
        l_val = at(row, col - 1) + gseq

        all_neg = (d_val < 0) & (u_val < 0) & (l_val < 0)
        d_ge_u = d_val >= u_val
        dirD = d_ge_u & (d_val >= l_val)
        dirU = ~d_ge_u & (u_val >= l_val)
        code = torch.where(dirD, torch.where(seq_j == code_i, D, LOW_D),
                           torch.where(dirU, U_DIR, L_DIR)).to(i32)

        emit = active & ~all_neg
        done = done | border | all_neg
        kk = k.long().clamp(max=max_steps - 1)
        dirs[bidx, kk] = torch.where(emit, code, dirs[bidx, kk])
        rows[bidx, kk] = torch.where(emit, row, rows[bidx, kk])
        row = torch.where(emit & (dirD | dirU), torch.where(dirD, d_idx, u_idx), row).to(i32)
        col = torch.where(emit & ~dirU, col - 1, col)
        k = k + emit.to(i32)
    return dirs, rows, k, row, col


def max_walk_steps(n: int, Lp: int) -> int:
    # every emit strictly decreases row or col
    return 2 * (n + Lp) + 8
