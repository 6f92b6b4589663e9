"""POA fills for modes 0 and 1, the dispatchers, and the walk pipeline of modes 0-3.

Counterpart of ``recgraph_tpu/ops/poa_engine.py``:

- constants ``NEG``, the direction codes and ``_DIRS`` (``:36, 80-83``);
- ``fill_global_plain`` ports ``_fill_global`` (``:149-297``),
  ``fill_global_windowed_plain`` ports ``_fill_global_windowed``
  (``:300-480``) and ``fill_local_plain`` ports ``_fill_local``
  (``:553-643``), as torch row loops.  They are what the CPU path runs
  and what the CUDA kernels are held against on the card;
- ``fill_*_best`` (``:700-780``): a CUDA tensor launches the
  hand-written kernel, a CPU tensor runs the plain version;
  ``ladder`` is the long-read W ladder of modes 0 and 2 (``:481-545``),
  ``fill_global_long`` its mode-0 call;
- ``WalkState``, ``run_batch_walks``, ``_dispatch_walks`` and
  ``_drain_walks`` (``:897-1103``) for modes 0-3 (the fills of modes 2
  and 3 are in ``poa_gap_engine``).

Both fills return the XLA engine's layout: packed int32[B, n, Lp] with
``pred * 16 + dir`` per cell and row n-1 zero.  In the row recurrence the
in-row "left" dependency is the (max,+) prefix scan

    m[j] = max(A[j], m[j-1] + gap) = G[j] + cummax_{k<=j}(A[k] - G[k]),

with G the running sum of the gap scores.
"""

from __future__ import annotations

import torch

from .. import scoring
from ..metrics import phase
from . import cuda_poa_global, cuda_poa_global_win, cuda_poa_local, traceback_engine
from .encode import encode_read_aux, encode_reads, poa_device_graph

NEG = -(1 << 28)  # -inf stand-in that survives a few additions in int32

# direction codes: reference bitfield_path.rs:3-15 plus the mode-2 'u'
_DIRS = "ODdLUXYMu"
O, D, LOW_D, L_DIR, U_DIR, X_DIR, Y_DIR, M_DIR, LOW_U = range(9)

LONG_READ_LP = 1024     # modes 0/2: reads at least this long (padded) use windowed rows
GAP = scoring.GAP       # the '-' code of the scoring table
_I32 = torch.int32


def _first_best(vals, preds):
    """First strict maximum over ``vals`` (a list of [B, Lp] tensors, one
    per predecessor in ascending order): (best, pred index)."""
    best = vals[0]
    arg = torch.full_like(best, preds[0])
    for v, p in zip(vals[1:], preds[1:]):
        upd = v > best
        best = torch.where(upd, v, best)
        arg = arg.masked_fill(upd, p)
    return best, arg


def _shift_right(x):
    """x[..., j-1] at column j, NEG at column 0."""
    out = torch.roll(x, 1, dims=-1)
    out[..., 0] = NEG
    return out


def _row_preds(h, i):
    return [int(p) for p, ok in zip(h["pred_idx"][i], h["pred_mask"][i]) if ok]


# ---------------------------------------------------------------------------
# mode 0 - global POA, linear gap, adaptive band (global_abpoa.rs:260-427)
# ---------------------------------------------------------------------------


def fill_global_plain(dg, table, seq, L, bta):
    """Banded global POA fill for a read batch, as a torch row loop.

    seq: int32[B, Lp] ('$'-prefixed, N-padded); L, bta: int32[B].
    Returns (score[B], last_row[B], last_col_abs[B],
             packed int32[B, n, Lp], lefts int32[B, n], rights int32[B, n]).
    """
    return _fill_global_rows(dg, table, seq, L, bta, seq.shape[1], False)[:6]


def fill_global_windowed_plain(dg, table, seq, L, bta, W):
    """Mode-0 fill with W-column windowed rows (long reads), as a torch
    row loop: the port of ``_fill_global_windowed`` (poa_engine.py:300-480).

    Row i keeps the columns [ws_i, ws_i + W) with ws_i = (left // 8) * 8;
    a read whose band outgrows its window sets ``over``.  Returns
    (score, last_row, last_col_abs, packed int32[B, n, W], lefts, rights,
     ws int32[B, n], over bool[B]).
    """
    return _fill_global_rows(dg, table, seq, L, bta, W, True)


def _fill_global_rows(dg, table, seq, L, bta, W, windowed):
    """The mode-0 row loop over W stored columns per row.

    Full width is the window [0, Lp): ``windowed=False`` pins ws_i to 0
    and W to Lp, and the recurrence is the same.  The score table ``m``
    is one [B, n, W] tensor updated in place.
    """
    h = dg.host()
    n = dg.n
    B, Lp = seq.shape
    dev = seq.device
    tab = table.to(dev, _I32)
    tab_h = tab.cpu().numpy()
    L = L.to(_I32)
    bta = bta.to(_I32)
    kcol = torch.arange(W, dtype=_I32, device=dev)[None, :]
    neg = torch.full((B, W), NEG, dtype=_I32, device=dev)
    zb = torch.zeros(B, dtype=_I32, device=dev)

    m = torch.zeros((B, n, W), dtype=_I32, device=dev)
    packed = torch.zeros((B, n, W), dtype=_I32, device=dev)
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
        gnode = int(tab_h[code, GAP])

        # --- adaptive band (utils.rs:17-72) ---
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
        jabs = ws_i[:, None] + kcol                # absolute column per lane
        lc, rc = left[:, None], right[:, None]
        in_band = (lc <= jabs) & (jabs < rc)
        is_left = jabs == lc
        s64 = seq.gather(1, jabs.clamp(max=Lp - 1).long()).long()
        gseq = tab[s64, GAP]                       # sm(seq[j], '-')
        sub = tab[code][s64]

        # --- U / D candidates: first best over predecessors, their
        # windows realigned to this row's ---
        if preds:
            u_list, d_list = [], []
            for p in preds:
                mp = m[:, p, :]
                idx = (ws_i - wss[:, p])[:, None] + kcol
                lp, rp = lefts[:, p, None], rights[:, p, None]
                u_ok = (idx >= 0) & (idx < W) & (lp <= jabs) & (jabs < rp)
                d_ok = (idx >= 1) & (idx <= W) & (lp < jabs) & (jabs <= rp)
                u_list.append(torch.where(u_ok, mp.gather(1, idx.clamp(0, W - 1).long()), NEG))
                d_list.append(
                    torch.where(d_ok, mp.gather(1, (idx - 1).clamp(0, W - 1).long()), NEG)
                )
            u_best, u_pred = _first_best(u_list, preds)
            d_best, d_pred = _first_best(d_list, preds)
        else:
            u_best = d_best = neg
            u_pred = d_pred = torch.zeros_like(neg)
        has_u = u_best > NEG // 2
        u_val = torch.where(has_u, u_best + gnode, gnode * (i + jabs))
        u_pred = torch.where(has_u, u_pred, minp)
        has_d = d_best > NEG // 2
        d_val = torch.where(has_d, d_best + sub, (gnode * (i + left))[:, None])
        d_pred = torch.where(has_d, d_pred, minp)

        # --- chain restart values A and the (max,+) prefix scan ---
        A = torch.maximum(d_val, u_val)
        seq_left = seq.gather(1, left.clamp(max=Lp - 1).long()[:, None])[:, 0]
        l_fb = tab[seq_left.long(), GAP] * (i + left)          # ":85" j==0, left>0
        if i == 0:
            A = torch.where(jabs == 0, 0, neg)
        else:
            # j==0 && left==0 base case (":74-77"): m[min_pred][left] + gap
            lm = (lefts[:, minp] - wss[:, minp]).clamp(0, W - 1).long()[:, None]
            base0 = m[:, minp, :].gather(1, lm)[:, 0] + gnode
            left_rel = (left - ws_i).clamp(0, W - 1).long()[:, None]
            a_left = torch.where(
                left == 0, base0, torch.maximum(A.gather(1, left_rel)[:, 0], l_fb)
            )
            A = torch.where(is_left, a_left[:, None], A)
        A = torch.where(in_band, A, NEG)
        G = torch.cumsum(tab[GAP, s64] if i == 0 else gseq, 1, dtype=_I32)
        m_row = G + torch.cummax(A - G, dim=1).values
        m_row = torch.where(in_band, m_row, NEG)

        # --- rightmost in-band argmax => best_scoring_pos (":129-130") ---
        rmax = m_row.max(1, keepdim=True).values
        bsp_i = ws_i + torch.where(m_row == rmax, kcol, -1).max(1).values

        # --- directions (utils.rs:129-140, tie order D >= U >= L) ---
        l_val = _shift_right(m_row) + gseq
        l_val = torch.where(
            is_left, torch.where((left == 0)[:, None], NEG, l_fb[:, None]), l_val
        )
        if i == 0:
            dcode = torch.where(jabs == 0, O, L_DIR)
            pred_sel = 0
        else:
            l_pred = torch.where(jabs > lc, i, minp)
            d_ge_u = d_val >= u_val
            dirD = d_ge_u & (d_val >= l_val)
            dirU = ~d_ge_u & (u_val >= l_val)
            dcode = torch.where(
                dirD, torch.where(s64 == code, D, LOW_D),
                torch.where(dirU, U_DIR, L_DIR),
            )
            pred_sel = torch.where(dirD, d_pred, torch.where(dirU, u_pred, l_pred))
            is_base = is_left & (left == 0)[:, None]
            dcode = torch.where(is_base, U_DIR, dcode)
            pred_sel = torch.where(is_base, minp, pred_sel)
        packed[:, i] = torch.where(in_band, pred_sel * 16 + dcode, 0)

        m[:, i] = m_row
        lefts[:, i] = left
        rights[:, i] = right
        wss[:, i] = ws_i
        bsp[:, i] = bsp_i

    # final cell: best over F's preds, first strict max, row n-2 seeded
    # (global_abpoa.rs:397-405); rights >= 1, so right - 1 lies in the row
    cand = (n - 2,) + tuple(dg.sink_rows)
    cand_right = rights[:, list(cand)]                       # [B, S+1]
    cols = (cand_right - 1 - wss[:, list(cand)]).clamp(0, W - 1).long()
    vals = [m[:, c, :].gather(1, cols[:, k, None])[:, 0] for k, c in enumerate(cand)]
    score, bidx = _first_best(vals, list(range(len(cand))))
    cand_t = torch.tensor(cand, dtype=_I32, device=dev)
    last_row = cand_t[bidx.long()]
    last_col_abs = cand_right.gather(1, bidx.long()[:, None])[:, 0] - 1
    return score, last_row, last_col_abs, packed, lefts, rights, wss, over


# ---------------------------------------------------------------------------
# mode 1 - local POA, full matrix (local_poa.rs:181-255)
# ---------------------------------------------------------------------------


def fill_local_plain(dg, table, seq, L):
    """Local POA fill for a read batch, as a torch row loop.

    Returns (best_val[B], best_i[B], best_j[B], packed int32[B, n, Lp]).
    The scalar local kernel scores as (seq[j], lnz[i]) and ('-', lnz[i])
    (local_poa.rs:202-221): the table is transposed against the global
    modes, which matters for the asymmetric HOXD70.
    """
    return fill_local_plain_planes(dg, table, seq, L)[:4]


def fill_local_plain_planes(dg, table, seq, L):
    """:func:`fill_local_plain`'s four outputs and its score plane m
    int32[B, n, Lp]: row 0 and column 0 zero, NEG past each read's end,
    row n-1 zero (the scores-only fill's output, ``poa_variants``)."""
    h = dg.host()
    n = dg.n
    B, Lp = seq.shape
    dev = seq.device
    tab = table.to(dev, _I32)
    tT = tab.T
    tT_h = tT.cpu().numpy()
    s64 = seq.long()
    L = L.to(_I32)
    jcol = torch.arange(Lp, dtype=_I32, device=dev)[None, :]
    gseq = tab[s64, GAP]
    G = torch.cumsum(gseq, 1, dtype=_I32)
    SUBT = tT[:, s64]                          # [7, B, Lp]
    valid = jcol < L[:, None]
    neg = torch.full((B, Lp), NEG, dtype=_I32, device=dev)

    m = torch.zeros((B, n, Lp), dtype=_I32, device=dev)
    packed = torch.zeros((B, n, Lp), dtype=_I32, device=dev)
    best_val = torch.zeros(B, dtype=_I32, device=dev)
    best_i = torch.zeros(B, dtype=_I32, device=dev)
    best_j = torch.zeros(B, dtype=_I32, device=dev)
    border0 = (jcol == 0) | ~valid

    for i in range(n - 1):
        code = int(h["codes"][i])
        is_start = bool(h["node_start"][i])
        preds = _row_preds(h, i)
        gnode = int(tT_h[code, GAP])
        mvals = [m[:, p, :] for p in preds] or [neg]
        pidx = preds or [0]

        # first-best quirk: the running max starts at 0 / index 0 on
        # node-start rows (local_poa.rs:257-293)
        d_pre, d_arg = _first_best([_shift_right(v) for v in mvals], pidx)
        u_pre, u_arg = _first_best(mvals, pidx)
        if is_start:
            d_val = torch.clamp(d_pre, min=0) + SUBT[code]
            d_idx = torch.where(d_pre > 0, d_arg, 0)
            u_val = torch.clamp(u_pre, min=0) + gnode
            u_idx = torch.where(u_pre > 0, u_arg, 0)
        else:
            d_val = d_pre + SUBT[code]
            u_val = u_pre + gnode
            d_idx = u_idx = i - 1

        if i == 0:
            m_row = torch.zeros_like(neg)
        else:
            A = torch.clamp(torch.maximum(d_val, u_val), min=0)
            A = torch.where(jcol == 0, 0, A)
            m_row = G + torch.cummax(A - G, dim=1).values
            m_row = torch.where(valid, m_row, NEG)
            m_row[:, 0] = 0

        # directions, zero floor (local_poa.rs:222-233)
        l_val = _shift_right(m_row) + gseq
        all_neg = (d_val < 0) & (u_val < 0) & (l_val < 0)
        d_ge_u = d_val >= u_val
        dirD = d_ge_u & (d_val >= l_val)
        dirU = ~d_ge_u & (u_val >= l_val)
        dcode = torch.where(
            dirD, torch.where(seq == code, D, LOW_D), torch.where(dirU, U_DIR, L_DIR)
        )
        pred_sel = torch.where(dirD, d_idx, torch.where(dirU, u_idx, i))
        off = all_neg | border0 if i > 0 else torch.ones_like(all_neg)
        packed[:, i] = torch.where(off, O, pred_sel * 16 + dcode)

        # global best, strict > in row-major scan order (local_poa.rs:240-244)
        row_masked = torch.where(valid, m_row, NEG)
        rmax = row_masked.max(1).values
        rarg = torch.where(row_masked == rmax[:, None], jcol, Lp).min(1).values
        upd = rmax > best_val
        best_val = torch.where(upd, rmax, best_val)
        best_i = best_i.masked_fill(upd, i)
        best_j = torch.where(upd, rarg, best_j)

        m[:, i] = m_row
    return best_val, best_i, best_j, packed, m


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def fill_global_best(dg, table, seq, L, bta):
    """Mode-0 fill: the CUDA kernel for CUDA tensors, the plain torch
    version for CPU tensors.  Returns the six outputs of
    :func:`fill_global_plain`."""
    if seq.is_cuda:
        return cuda_poa_global.fill_global_cuda(dg, table, seq, L, bta)
    return fill_global_plain(dg, table, seq, L, bta)


def fill_global_windowed_best(dg, table, seq, L, bta, W):
    """Windowed mode-0 fill: the CUDA kernel for CUDA tensors, the plain
    torch version for CPU tensors."""
    if seq.is_cuda:
        return cuda_poa_global_win.fill_global_win_cuda(dg, table, seq, L, bta, W)
    return fill_global_windowed_plain(dg, table, seq, L, bta, W)


def fill_local_best(dg, table, seq, L):
    """Mode-1 fill: the CUDA kernel for CUDA tensors, the plain torch
    version for CPU tensors.  Returns the four outputs of
    :func:`fill_local_plain`."""
    if seq.is_cuda:
        return cuda_poa_local.fill_local_cuda(dg, table, seq, L)
    return fill_local_plain(dg, table, seq, L)


# the widest window that fitted, per (mode, graph rows): the next ladder
# of that mode on that graph starts there
_long_w_hint: dict[tuple[int, int], int] = {}


def ladder_start(mode, n, bta_max):
    """First window width of a long-read ladder: the hint of (mode, n),
    or the smallest power of two from 256 up that covers 2 * bta + 64
    columns (poa_engine.py:498-502)."""
    W = _long_w_hint.get((mode, n), 0)
    if W == 0:
        W = 256
        while W < 2 * bta_max + 64:
            W *= 2
    return W


def ladder(mode, n, Lp, bta_max, fill_win, fill_full, W=None, fits=None):
    """The long-read W ladder of modes 0 and 2 (poa_engine.py:481-545,
    poa_gap_engine.py:476-548).

    From ``W`` (default :func:`ladder_start`) it runs ``fill_win(W)`` and
    doubles W while any read overflows its window (the fill's last
    output, ``over``); at W >= Lp it runs ``fill_full()``.  Returns (W,
    outputs + (ws,)) without ``over``; ws is None at full width.  When
    ``fits(W)`` is false for a rung, it stops before filling that rung
    and returns (W, None), so that the caller can split the batch.
    """
    if W is None:
        W = ladder_start(mode, n, bta_max)
    while True:
        if fits is not None and not fits(min(W, Lp)):
            return W, None
        if W >= Lp:
            W, out = Lp, fill_full() + (None,)
            break
        out = fill_win(W)
        if not bool(out[-1].any()):
            out = out[:-1]
            break
        del out  # free this rung's planes before the next one allocates
        W *= 2
    _long_w_hint[(mode, n)] = max(W, _long_w_hint.get((mode, n), 0))
    return W, out


def fill_global_long(dg, table, seq, L, bta, bta_max, W=None, fits=None):
    """Mode-0 fill for long reads: :func:`ladder` over the windowed and
    the full-width fill.  Returns (W, (score, last_row, last_col_abs,
    packed[B, n, W], lefts, rights, ws | None)), or (W, None) where
    ``fits`` stopped the ladder."""
    return ladder(
        0, dg.n, seq.shape[1], bta_max,
        lambda w: fill_global_windowed_best(dg, table, seq, L, bta, w),
        lambda: fill_global_best(dg, table, seq, L, bta), W, fits,
    )


# ---------------------------------------------------------------------------
# device-traceback batch path (compact walks instead of packed planes)
# ---------------------------------------------------------------------------


class WalkState:
    """Per-read result with a compact device walk (no packed planes).

    GAF emission goes through the native walk emitter
    (csrc/host/gaf_emit.cpp: gaf_emit_poa_walk).
    """

    __slots__ = (
        "mode", "score", "last_row", "last_col_abs", "stop_row",
        "query_start", "dirs", "rows", "band_check_ok",
    )

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


# bytes of device memory one chunk may hold in planes and scratch
CHUNK_BYTES = {"cuda": 8 << 30, "cpu": 256 << 20}


def plane_width(mode: int, n: int, Lp: int, bta_max: int) -> int:
    """Columns each fill stores per row: the long-read ladder's first
    window for modes 0/2 at Lp >= LONG_READ_LP, else Lp."""
    if mode in (0, 2) and Lp >= LONG_READ_LP:
        return min(Lp, ladder_start(mode, n, bta_max))
    return Lp


def read_bytes(mode: int, n: int, Lp: int, W: int) -> int:
    """Device bytes one read holds while its chunk is filled and walked:
    the planes the fill writes and its score scratch, 4 bytes each per
    stored cell of W columns (modes 0/1: packed + m; modes 2/3: three
    planes + m + y), the per-row band arrays and the walk buffers."""
    planes = 2 if mode in (0, 1) else 5
    steps = traceback_engine.max_walk_steps(n, Lp)
    return 4 * (planes * n * W + 5 * n + 2 * steps)


def chunk_reads(mode: int, n: int, Lp: int, bta_max: int, device) -> int:
    """Reads per chunk within the device's byte budget, at the width the
    fill stores first (:func:`plane_width`).  A ladder rung that widens
    past the budget splits the chunk (:func:`_fill_walk`)."""
    W = plane_width(mode, n, Lp, bta_max)
    return max(1, CHUNK_BYTES[torch.device(device).type] // read_bytes(mode, n, Lp, W))


def run_batch_walks(mode, sequences, g, sm, o, e, btas, device):
    """Modes 0-3 with on-device traceback; returns list[WalkState].

    Large corpora run as a depth-2 pipeline over read chunks: chunk k+1
    is dispatched before chunk k is drained.  Every chunk has one padded
    Lp (the corpus maximum).  Each chunk is sized when it is dispatched,
    so a ladder that climbed in one chunk sizes the next at its new
    window; the last chunk holds what is left, unpadded (no kernel needs
    a fixed batch).
    """
    if mode not in (0, 1, 2, 3):
        raise ValueError(f"POA modes are 0-3, got {mode}")
    device = torch.device(device)
    pad_to = max(len(s) for s in sequences)
    Lp = (pad_to + 7) // 8 * 8
    out, pending, c = [], None, 0
    while c < len(sequences) or pending is not None:
        nxt = None
        if c < len(sequences):
            ckr = chunk_reads(mode, g.n, Lp, max(btas), device)
            with phase("dispatch"):
                nxt = _dispatch_walks(mode, sequences[c : c + ckr], g, sm, o, e,
                                      btas[c : c + ckr], device, pad_to=pad_to)
            c += ckr
        if pending is not None:
            out.extend(_drain_walks(mode, *pending))
        pending = nxt
    return out


def _dispatch_walks(mode, sequences, g, sm, o, e, btas, device, pad_to=None):
    """Device-side fill + walk for one chunk; no host transfers."""
    dg = poa_device_graph(g, device)
    table = torch.as_tensor(sm.table, dtype=_I32).to(device)
    with phase("encode"):
        seq, L = encode_reads(sequences, pad_to=pad_to, device=device)
        bta = encode_read_aux(btas, device) if mode in (0, 2) else None
    W = traceback_engine.max_walk_steps(dg.n, seq.shape[1])
    scal, dirs, rows, it = _fill_walk(mode, dg, table, seq, L, bta, max(btas), o, e, W)
    dev = dict(scal=scal, dirs=dirs, rows=rows, it=it, W=W, device=device)
    return sequences, dev


def _fill_walk(mode, dg, table, seq, L, bta, bta_max, o, e, max_steps, W=None):
    """Fill and walk one batch: (scal int32[8, B], dirs, rows, iterations).

    Long reads in modes 0/2 climb the W ladder from ``W``.  A rung whose
    planes would pass the chunk budget (:func:`read_bytes`) splits the
    batch into parts that fit, each of which climbs on from that rung,
    so a chunk sized for the first rung never outgrows the budget.
    """
    from . import poa_gap_engine  # it imports this module

    B, Lp = seq.shape
    long = mode in (0, 2) and Lp >= LONG_READ_LP
    ws = px = py = None
    with phase("fill"):
        if long:
            budget = CHUNK_BYTES[seq.device.type]
            fits = lambda w: B == 1 or B * read_bytes(mode, dg.n, Lp, w) <= budget  # noqa: E731
            if mode == 0:
                W, out = fill_global_long(dg, table, seq, L, bta, bta_max, W, fits)
            else:
                W, out = poa_gap_engine.fill_gap_global_long(
                    dg, table, seq, L, bta, bta_max, o, e, W, fits
                )
        elif mode == 0:
            out = fill_global_best(dg, table, seq, L, bta)
        elif mode == 1:
            out = fill_local_best(dg, table, seq, L)
        elif mode == 2:
            out = poa_gap_engine.fill_gap_global_best(dg, table, seq, L, bta, o, e)
        else:
            out = poa_gap_engine.fill_gap_local_best(dg, table, seq, L, o, e)
    if out is None:
        n_parts = -(-B // max(1, budget // read_bytes(mode, dg.n, Lp, min(W, Lp))))
        size = -(-B // n_parts)
        parts = [
            _fill_walk(mode, dg, table, seq[k : k + size], L[k : k + size],
                       bta[k : k + size], bta_max, o, e, max_steps, W)
            for k in range(0, B, size)
        ]
        return (torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts]),
                torch.cat([p[2] for p in parts]), max(p[3] for p in parts))
    if long:
        *out, ws = out
    if mode in (0, 2):
        score, last_row, last_col, packed, *gap, lefts, rights = out
        band = (lefts, rights, L)
    else:
        score, last_row, last_col, packed, *gap = out
        band = None
    if gap:
        px, py = gap
    with phase("walk"):
        dirs, rows, steps, stop_row, stop_col, band_ok, qstart, it = (
            traceback_engine.walk_poa(
                packed, last_row, last_col, max_steps, band=band, ws=ws,
                packed_x=px, packed_y=py,
            )
        )
    ok = band_ok.to(_I32) if band_ok is not None else torch.ones_like(score)
    scal = torch.stack([score, last_row, last_col, steps, stop_row, stop_col, qstart, ok])
    return scal, dirs, rows, it


def _drain_walks(mode, sequences, dev):
    """Fetch one dispatched chunk and build WalkStates."""
    B = len(sequences)
    with phase("device_wait"):
        if dev["device"].type == "cuda":
            torch.cuda.synchronize(dev["device"])
    # only the used walk extent (bucketed) crosses to the host
    kmax = min(dev["W"], (dev["it"] + 63) // 64 * 64)
    with phase("fetch"):
        pk = traceback_engine.pack_walk32(
            dev["dirs"][:B, :kmax], dev["rows"][:B, :kmax]
        ).cpu().numpy()
        scal = dev["scal"][:, :B].cpu().numpy()
    (score, last_row, last_col, steps, stop_row, stop_col, qstart_a,
     band_ok_a) = scal
    dirs, rows = traceback_engine.unpack_walk(pk)
    banded = mode in (0, 2)
    states = []
    with phase("host_tb"):
        for b in range(B):
            d, r = traceback_engine.compact_walk(dirs[b], rows[b], int(steps[b]))
            states.append(
                WalkState(
                    mode=mode,
                    score=int(score[b]),
                    last_row=int(last_row[b]),
                    last_col_abs=int(last_col[b]),
                    stop_row=int(stop_row[b]),
                    query_start=int(qstart_a[b] if banded else stop_col[b]),
                    dirs=d,
                    rows=r,
                    band_check_ok=bool(band_ok_a[b]) if banded else True,
                )
            )
    return states
