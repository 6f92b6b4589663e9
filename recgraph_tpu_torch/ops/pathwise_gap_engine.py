"""Pathwise affine-gap modes 6/7: host metadata, the delta-form fill and
its dispatcher, endings, plane extraction, the walk and the batch driver.

Counterpart of ``recgraph_tpu/ops/pathwise_gap_engine.py``:

- ``RejectedGraph``, ``GapMeta`` and ``gap_meta`` (``:67-294``), without
  the ring fields: the CUDA fill reads predecessor rows straight from
  its output planes, which are the row history; ``lane_maps`` and
  ``GapTables`` are the flat int32 tables the kernel reads
  (``pallas_gap67_fill.pack_meta``, ``:807-844``), built once per graph
  and kept on the device, with ``chain_coefs``, the hard rows' lane
  coefficients of the CUDA column program (hub lanes first), and
  ``hard_cols_chain_plain``, that program run from them alone;
- ``fill_gap_plain`` ports ``_fill_gap`` (``:334-820``) as a torch row
  loop over rows 1..n-2 (``_fc_nonstart``, ``_fc_start``, ``_easy_row``,
  ``stage_hard_row`` and ``hard_cols_plain``, the plain version of
  ``pallas_gap67_hardrow.hard_cols_lc``); it is what the CPU path runs
  and what the CUDA kernels are held against on the card;
- ``fill_gap_device`` (``:823-883``): a CUDA tensor launches the
  hand-written fill (``cuda_gap67_fill``) for every graph, a CPU tensor
  runs the plain fill;
- ``final_gap_column``, ``extract_gap_planes`` and the two endings
  (``:913-937, 1039-1072``), vectorised over reads and rows;
- ``walk_gap`` ports ``_walk_gap`` (``:1205-1325``) as a host-driven
  loop of batched torch ops that stops once every read is done;
- ``count_to_source_table`` replaces the per-read ``_count_to_source``
  walk (``:1175-1192``) with one [n, P] table per graph;
- ``run_batch`` (``:1075-1172``): chunking, fill, endings, extraction,
  one walk loop over every chunk that fits ``WALK_BYTES``, and the lines.

The planes are the reference's alpha/delta-compressed matrices (dpm, x,
y) in delta form: the walk compares delta-form values directly and the
mask_q quirk leaks deltas between groups, so every plane cell is part
of the output contract (module docstring of the JAX engine).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graph.pathgraph import PathGraph
from ..metrics import phase
from ..scoring import ScoreMatrix
from . import cuda_gap67_fill, traceback_engine
from .encode import encode_reads, path_device_graph
from .pathwise_engine import WALK_BYTES, _cigar
from .poa_engine import CHUNK_BYTES

_I32 = torch.int32


# ---------------------------------------------------------------------------
# host metadata
# ---------------------------------------------------------------------------


class RejectedGraph(ValueError):
    """The reference itself rejects this graph (a predecessor block
    sharing no path with its node panics in pathwise_alignment_gap.rs's
    common-paths indexing).  Callers may route to the scalar oracle for
    EXACTLY this case (it raises the same way); any other error must
    propagate."""


@dataclass
class GapMeta:
    """Per-row static metadata of the fill (all numpy)."""

    n: int
    P: int
    maxb: int
    codes: np.ndarray          # int32[n]
    alphas: np.ndarray         # int32[n]
    node_start: np.ndarray     # bool[n]
    # easy-row program (interior columns)
    easy: np.ndarray           # bool[n]
    pr: np.ndarray             # int32[n]  predecessor row
    eap: np.ndarray            # int32[n]  predecessor alpha lane
    edelta: np.ndarray         # bool[n]   pred alpha outside common set
    emask: np.ndarray          # bool[n,P] common minus row alpha
    # first-column program for non-start rows (mode 6)
    fap: np.ndarray            # int32[n]  alphas[i-1]
    fcommon_ap: np.ndarray     # bool[n]   common[i-1-alpha]
    fmask: np.ndarray          # bool[n,P] (pn[i] & pn[i-1]) minus alpha
    # hard-row / node-start block program
    bvalid: np.ndarray         # bool[n,MB]
    bpred: np.ndarray          # int32[n,MB]
    bap: np.ndarray            # int32[n,MB] pred alpha
    btb: np.ndarray            # int32[n,MB] written ("temp alpha") lane
    bdelta: np.ndarray         # bool[n,MB]  pred alpha outside common
    bcase1: np.ndarray         # bool[n,MB]  rep case (ap in common)
    bmask: np.ndarray          # bool[n,MB,P] common minus tb
    bmaskq: np.ndarray         # bool[n,MB,P] common minus alpha (mask_q quirk)
    bfirst: np.ndarray         # bool[n,MB]  first slot with this tb
    bfixmem: np.ndarray        # bool[n,MB,P] final members minus tb (fixup)
    # hard-row last-writer owner maps: each block's per-column writes hit
    # maskb|{tb}, later blocks overwrite earlier ones, so a lane's final
    # value is its owning (last-writing) block's formula
    bown: np.ndarray           # bool[n,MB,P] lane owned by block s
    bfire: np.ndarray          # bool[n,MB]  fixup fires (valid&first&tb!=ai)
    bisa: np.ndarray           # bool[n,MB]  the fire block whose fixmem
                               #   contains the row alpha (at most one)
    bafter: np.ndarray         # bool[n,MB]  fire blocks ordered after it


def gap_meta(g: PathGraph) -> GapMeta:
    """Row classification and padded block metadata.

    Raises :class:`RejectedGraph` for graphs the reference itself
    rejects (a predecessor block sharing no path with the node).  Raises
    ValueError when the hard rows' owner maps are not one-hot or their
    fixup member sets overlap: the vectorised fixup of the column
    program (and of the JAX engine's) is exact only without either.
    """
    n, P = g.n, g.paths_number
    pn = g.paths_nodes
    alphas = np.asarray(g.alphas, dtype=np.int32)
    node_start = np.asarray(g.node_start, dtype=bool)
    codes = np.asarray(g.codes, dtype=np.int32)

    maxb = 1
    rows_blocks: list[list] = [[] for _ in range(n)]
    for i in range(1, n - 1):
        if node_start[i]:
            rows_blocks[i] = g.preds_and_paths(i)
            maxb = max(maxb, len(rows_blocks[i]))

    MB = maxb
    easy = np.zeros(n, dtype=bool)
    pr = np.zeros(n, dtype=np.int32)
    eap = np.zeros(n, dtype=np.int32)
    edelta = np.zeros(n, dtype=bool)
    emask = np.zeros((n, P), dtype=bool)
    fap = np.zeros(n, dtype=np.int32)
    fcommon_ap = np.zeros(n, dtype=bool)
    fmask = np.zeros((n, P), dtype=bool)
    bvalid = np.zeros((n, MB), dtype=bool)
    bpred = np.zeros((n, MB), dtype=np.int32)
    bap = np.zeros((n, MB), dtype=np.int32)
    btb = np.zeros((n, MB), dtype=np.int32)
    bdelta = np.zeros((n, MB), dtype=bool)
    bcase1 = np.zeros((n, MB), dtype=bool)
    bmask = np.zeros((n, MB, P), dtype=bool)
    bmaskq = np.zeros((n, MB, P), dtype=bool)
    bfirst = np.zeros((n, MB), dtype=bool)
    bfixmem = np.zeros((n, MB, P), dtype=bool)
    bown = np.zeros((n, MB, P), dtype=bool)
    bfire = np.zeros((n, MB), dtype=bool)
    bisa = np.zeros((n, MB), dtype=bool)
    bafter = np.zeros((n, MB), dtype=bool)

    for i in range(1, n - 1):
        ai = int(alphas[i])
        if not node_start[i]:
            common = pn[i] & pn[i - 1]
            ap = int(alphas[i - 1])
            easy[i] = True
            pr[i] = i - 1
            eap[i] = ap
            edelta[i] = not common[ap] if ap < P else True
            emask[i] = common.copy()
            emask[i, ai] = False
            fap[i] = ap
            fcommon_ap[i] = common[ap] if ap < P else False
            fmask[i] = emask[i]
            continue

        blocks = rows_blocks[i]
        members_of: dict[int, np.ndarray] = {}
        for s, (p, p_paths) in enumerate(blocks):
            common = pn[i] & p_paths
            if not common.any():
                raise RejectedGraph(f"empty common-paths set at row {i}")
            ap = int(alphas[p])
            case1 = ap < P and bool(common[ap])
            if case1:
                tb = ap
            else:
                tb = ai if common[ai] else int(np.flatnonzero(common)[0])
            bvalid[i, s] = True
            bpred[i, s] = p
            bap[i, s] = ap
            btb[i, s] = tb
            bdelta[i, s] = not case1
            bcase1[i, s] = case1
            bmask[i, s] = common.copy()
            bmask[i, s, tb] = False
            bmaskq[i, s] = common.copy()
            bmaskq[i, s, ai] = False
            if tb not in members_of:
                bfirst[i, s] = True
            members_of[tb] = common
        for s in range(len(blocks)):
            if bfirst[i, s]:
                m = members_of[int(btb[i, s])].copy()
                m[int(btb[i, s])] = False
                bfixmem[i, s] = m

        if len(blocks) == 1:
            p, p_paths = blocks[0]
            common = pn[i] & p_paths
            ap = int(alphas[p])
            if ap < P and (
                (common[ap] and ap == ai) or (not common[ap] and common[ai])
            ):
                easy[i] = True
                pr[i] = p
                eap[i] = ap
                edelta[i] = not common[ap]
                emask[i] = common.copy()
                emask[i, ai] = False

        ownid = np.full(P, -1, dtype=np.int64)
        saw_sa = False
        for s in range(len(blocks)):
            wset = bmask[i, s].copy()
            wset[int(btb[i, s])] = True
            ownid[wset] = s
            fire = bool(bfirst[i, s]) and int(btb[i, s]) != ai
            bfire[i, s] = fire
            if fire:
                bafter[i, s] = saw_sa
                if bfixmem[i, s, ai]:
                    bisa[i, s] = True
                    saw_sa = True
        bown[i] = ownid[None, :] == np.arange(MB)[:, None]

    if not ((bown.sum(axis=1) <= 1).all() and (bfixmem.sum(axis=1) <= 1).all()):
        raise ValueError("modes 6/7: hard-row owner maps not one-hot or fixup member "
                         "sets overlap; the column program would not be exact")
    return GapMeta(
        n=n, P=P, maxb=MB, codes=codes, alphas=alphas, node_start=node_start,
        easy=easy, pr=pr, eap=eap, edelta=edelta, emask=emask,
        fap=fap, fcommon_ap=fcommon_ap, fmask=fmask,
        bvalid=bvalid, bpred=bpred, bap=bap, btb=btb, bdelta=bdelta,
        bcase1=bcase1, bmask=bmask, bmaskq=bmaskq, bfirst=bfirst,
        bfixmem=bfixmem, bown=bown, bfire=bfire, bisa=bisa, bafter=bafter,
    )


def lane_maps(meta: GapMeta) -> np.ndarray:
    """The hard rows' owner-collapsed lane maps, int32[n, 4, P]: the
    owning block of each lane (-1 none), whether the lane is its owner's
    tb lane, the fire block whose fixup members hold the lane (-1 none)
    and whether the lane is a firing block's tb lane
    (``pathwise_gap_engine.py:609-627``)."""
    own = meta.bown
    own_any = own.any(axis=1)
    own_id = np.where(own_any, own.argmax(axis=1), -1)
    tb_of_own = np.take_along_axis(meta.btb, np.maximum(own_id, 0), axis=1)
    lanes = np.arange(meta.P)[None, :]
    hot = own_any & (tb_of_own == lanes)
    fix = meta.bfixmem
    fix_id = np.where(fix.any(axis=1), fix.argmax(axis=1), -1)
    hotl = (meta.bfire[:, :, None] & (meta.btb[:, :, None] == lanes[None])).any(axis=1)
    return np.stack([own_id, hot, fix_id, hotl], axis=1).astype(np.int32)


# row flags (GapTables.rows[:, 2]) and block flags (GapTables.blocks[..., 3]),
# the bits of pallas_gap67_fill.pack_meta
F_EASY, F_START, F_EDELTA, F_FCAP = 1, 2, 4, 8
BF_VALID, BF_DELTA, BF_CASE1, BF_FIRST, BF_FIRE, BF_ISA, BF_AFTER = 1, 2, 4, 8, 16, 32, 64
# lane-coefficient flags (chain_coefs' slots[3]): the owner's tb lane is not
# the row alpha, the lane is its owner's tb lane, the lane is a firing
# block's tb lane, and the ``after`` flag of the block its fixup reads
CF_ND, CF_HOT, CF_HOTL, CF_AFTER = 1, 2, 4, 8


def chain_coefs(own, hot, fix, hotl, tb, nd, fire, isa, after, ai):
    """The lane coefficients of one hard row's column program (K12 on the
    card), from its lane maps ``own, hot, fix, hotl`` int[P], block
    scalars ``tb, nd, fire, isa, after`` int[MB] and row alpha ``ai``, as
    ``hard_cols_plain`` takes them: (slots int32[4, P], hubs, alpha
    slot, isa slot).

    The hubs are the row alpha and the tb lanes of the blocks that own a
    lane or fire: the only lanes whose values other lanes read.  Slots
    hold the hubs first (ascending), then every other lane; per slot,
    slots[0] is its path, [1] the slot of its owner's tb lane (-1 when no
    block owns it), [2] the slot whose pre-fixup value its fixup reads
    (itself for a firing block's tb lane, the tb lane of the firing block
    whose fixup members hold it, else -1) and [3] its CF_* flags.  The
    isa slot is the tb lane of the firing block whose fixup members hold
    the row alpha (-1 none)."""
    own, hot, fix, hotl = (np.asarray(a, dtype=np.int64) for a in (own, hot, fix, hotl))
    tb, nd_b, fire, isa, after = (np.asarray(a, dtype=np.int64)
                                  for a in (tb, nd, fire, isa, after))
    P = own.shape[0]
    hubs = sorted({int(ai)} | set(tb[np.unique(own[own >= 0])].tolist())
                  | set(tb[fire != 0].tolist()))
    hub_set = set(hubs)
    path = np.array(hubs + [q for q in range(P) if q not in hub_set], dtype=np.int64)
    slot = np.empty(P, dtype=np.int64)
    slot[path] = np.arange(P)
    o = own[path]
    oc = np.maximum(o, 0)
    tbs = np.where(o >= 0, slot[tb[oc]], -1)
    nd = (o >= 0) & (nd_b[oc] != 0)
    hotl_ = hotl[path] != 0
    after_of_tb = np.zeros(P, dtype=np.int64)      # the after flag of the firing block on each tb lane
    fired = np.flatnonzero(fire)
    after_of_tb[tb[fired]] = after[fired]
    f = fix[path]
    fc = np.maximum(f, 0)
    fixf = (f >= 0) & (fire[fc] != 0)
    fxs = np.where(hotl_, np.arange(P), np.where(fixf, slot[tb[fc]], -1))
    aft = np.where(hotl_, after_of_tb[path], fixf & (after[fc] != 0))
    flags = (nd * CF_ND + (hot[path] != 0) * CF_HOT + hotl_ * CF_HOTL
             + (aft != 0) * CF_AFTER)
    sa = np.flatnonzero(isa)
    isa_slot = int(slot[tb[sa[0]]]) if sa.size else -1
    slots = np.stack([path, tbs, fxs, flags]).astype(np.int32)
    return slots, len(hubs), int(slot[ai]), isa_slot


def chain_tables(meta: GapMeta, lanes: np.ndarray):
    """``chain_coefs`` of every hard row: (slots int32[n, 4, P], hub
    rows int32[n, 3] = hubs, alpha slot, isa slot); zeros on easy rows."""
    n, P = meta.n, meta.P
    slots = np.zeros((n, 4, P), dtype=np.int32)
    hub = np.zeros((n, 3), dtype=np.int32)
    for i in range(1, n - 1):
        if meta.easy[i]:
            continue
        ai = int(meta.alphas[i])
        slots[i], *h = chain_coefs(*lanes[i], meta.btb[i], meta.btb[i] != ai, meta.bfire[i],
                                   meta.bisa[i], meta.bafter[i], ai)
        hub[i] = h
    return slots, hub


@dataclass(frozen=True, eq=False)
class GapTables:
    """One graph's fill metadata as flat int32 tensors on one device.

    rows      int32[n, 10]     code, alpha, row flags, pr, eap, fap, and
                               for hard rows hubs, alpha slot, isa slot
                               (``chain_coefs``), 0
    lanemask  int32[n, P]      emask | fmask << 1
    blocks    int32[n, MB, 4]  pred, pred alpha, tb, block flags
    blockmask int32[n, MB, P]  bmask | bmaskq << 1 | bfixmem << 2
    lanes     int32[n, 4, P]   ``lane_maps``
    chain     int32[n, 4, P]   the hard rows' ``chain_coefs`` slots
    """

    meta: GapMeta
    rows: torch.Tensor
    lanemask: torch.Tensor
    blocks: torch.Tensor
    blockmask: torch.Tensor
    lanes: torch.Tensor
    chain: torch.Tensor
    hard_rows: int


def build_gap_tables(meta: GapMeta, device) -> GapTables:
    m = meta
    i32 = lambda a: np.asarray(a, dtype=np.int32)  # noqa: E731
    flags = (i32(m.easy) * F_EASY + i32(m.node_start) * F_START
             + i32(m.edelta) * F_EDELTA + i32(m.fcommon_ap) * F_FCAP)
    lanes = lane_maps(m)
    chain, hub = chain_tables(m, lanes)
    rows = np.concatenate([np.stack([m.codes, m.alphas, flags, m.pr, m.eap, m.fap], axis=1),
                           hub, np.zeros((m.n, 1), np.int32)], axis=1)
    bflags = (i32(m.bvalid) * BF_VALID + i32(m.bdelta) * BF_DELTA + i32(m.bcase1) * BF_CASE1
              + i32(m.bfirst) * BF_FIRST + i32(m.bfire) * BF_FIRE + i32(m.bisa) * BF_ISA
              + i32(m.bafter) * BF_AFTER)
    blocks = np.stack([m.bpred, m.bap, m.btb, bflags], axis=2)
    lanemask = i32(m.emask) | (i32(m.fmask) << 1)
    blockmask = i32(m.bmask) | (i32(m.bmaskq) << 1) | (i32(m.bfixmem) << 2)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)  # noqa: E731
    return GapTables(meta=m, rows=t(rows), lanemask=t(lanemask), blocks=t(blocks),
                     blockmask=t(blockmask), lanes=t(lanes), chain=t(chain),
                     hard_rows=int((~m.easy[1 : m.n - 1]).sum()))


def gap_tables(g: PathGraph, device) -> GapTables:
    """``build_gap_tables(gap_meta(g))``, cached on the graph per device
    (the metadata once per graph)."""
    cache = g.__dict__.setdefault("_torch_gap_tables", {})
    dev = torch.device(device)
    tabs = cache.get(str(dev))
    if tabs is None:
        meta = cache.get("meta")
        if meta is None:
            meta = cache["meta"] = gap_meta(g)
        tabs = cache[str(dev)] = build_gap_tables(meta, dev)
    return tabs


# ---------------------------------------------------------------------------
# the plain fill
# ---------------------------------------------------------------------------


def _lane(v, a: int):
    """v[:, a] with the lane clamped into [0, P-1], as the JAX engine's
    dynamic_slice reads it (``_lane``, :297-305); v is [B, P, ...]."""
    return v[:, min(a, v.shape[1] - 1)]


def _fc_nonstart(Xp0, i, ai, ap, cap, maskc, o, e):
    """The first column of a non-start row (gap.rs:35-75; JAX :368-383).
    Xp0: int32[B, P], column 0 of row i-1's x plane."""
    P = Xp0.shape[1]
    xp_ai = _lane(Xp0, ai)
    xp_ap = _lane(Xp0, ap)
    if i == 1:
        x_ai = torch.full_like(xp_ai, o + e)
    else:
        x_ai = xp_ai + e if cap else xp_ai + xp_ap + e
    xm = Xp0 if cap else Xp0 - xp_ai[:, None]
    x0 = torch.where(maskc[None, :], xm, 0)
    if ai < P:
        x0[:, ai] = x_ai
    return x0


def _fc_start(X, i, ai, m, bmask, bfix, o, e):
    """The first column of a node-start row with its insertion-order
    fixup (gap.rs:76-147; JAX :385-412)."""
    B, P = X.shape[1], X.shape[2]
    x0 = torch.zeros((B, P), dtype=_I32, device=X.device)
    for s in np.flatnonzero(m.bvalid[i]):
        p, tb, ap = int(m.bpred[i, s]), int(m.btb[i, s]), int(m.bap[i, s])
        Xp0 = X[p, :, :, 0]
        xp_tb = Xp0[:, tb]
        d_s = int(m.bdelta[i, s])
        x_tb = torch.full_like(xp_tb, o + e) if p == 0 else xp_tb + d_s * _lane(Xp0, ap) + e
        x0 = torch.where(bmask[s][None, :], Xp0 - d_s * xp_tb[:, None], x0)
        x0[:, tb] = x_tb
    for s in np.flatnonzero(m.bfire[i]):
        tb = int(m.btb[i, s])
        va = x0[:, tb] - x0[:, ai]
        x0[:, tb] = va
        x0 = torch.where(bfix[s][None, :], x0 + va[:, None], x0)
    return x0


def _easy_row(pD, pY, ai, ap, d, mask, x0, sub, o, e, jcol):
    """The closed-form row (oracle ``_fill_row_vec``; JAX ``easy_row``,
    :414-506): the alpha lane's (max,+) chain, then every mask lane
    replays its cell from the latest inject column.  pD/pY: the pred
    row's planes int32[B, P, Lp]; returns (Drow, Xrow, Yrow)."""
    B, P, Lp = pD.shape
    pD_ap, pD_ai = _lane(pD, ap), _lane(pD, ai)
    pY_ap, pY_ai = _lane(pY, ap), _lane(pY, ai)
    u_y = pY_ap + d * pY_ai + e
    u_dpm = pD_ap + d * pD_ai + o + e
    usel = u_dpm >= u_y
    y_a = torch.where(usel, u_dpm, u_y)
    Ym = torch.where(usel[:, None, :], pD - d * pD_ai[:, None, :], pY - d * pY_ai[:, None, :])

    base = pD_ap + d * pD_ai
    d_col = torch.roll(base, 1, 1) + sub                # col 0 unused
    const = torch.maximum(d_col, y_a)
    x0_ai = _lane(x0, ai)
    q = const - e * jcol
    q[:, 0] = torch.maximum(x0_ai, x0_ai - o)
    M = torch.cummax(q, 1).values
    x_a = o + e * jcol + torch.roll(M, 1, 1)
    x_a[:, 0] = x0_ai
    dpm_a = torch.maximum(const, x_a)
    dpm_a[:, 0] = x0_ai
    lsel = dpm_a + o >= x_a                             # col t -> sel t+1
    dsel = torch.where(dpm_a == d_col, 0, torch.where(dpm_a == y_a, 1, 2))

    Dm_sh = torch.roll(pD - d * pD_ai[:, None, :], 1, 2)
    Cval = torch.where((dsel == 0)[:, None, :], Dm_sh, Ym)
    Cval[:, :, 0] = x0
    inject = torch.roll(lsel, 1, 1) & (torch.roll(dsel, 1, 1) != 2)
    inject[:, 1] = lsel[:, 0]
    inject[:, 0] = False
    src = torch.cummax(torch.where(inject, jcol, 0), 1).values
    gidx = (src - 1).clamp(min=0).long()[:, None, :].expand(B, P, Lp)
    x_m = torch.where((src == 0)[:, None, :], x0[:, :, None], Cval.gather(2, gidx))
    dpm_m = torch.where((dsel == 0)[:, None, :], Dm_sh,
                        torch.where((dsel == 1)[:, None, :], Ym, x_m))

    interior = (jcol >= 1)[None, None, :]
    lm = mask[None, :, None] & interior
    Yrow = torch.where(lm, Ym, 0)
    Xrow = torch.where(lm, x_m, torch.where(interior, 0, x0[:, :, None]))
    Drow = torch.where(lm, dpm_m, torch.where(interior, 0, x0[:, :, None]))
    if ai < P:
        Yrow[:, ai, 1:] = y_a[:, 1:]
        Xrow[:, ai, 1:] = x_a[:, 1:]
        Drow[:, ai, 1:] = dpm_a[:, 1:]
    return Drow, Xrow, Yrow


def stage_hard_row(tabs: GapTables, Dm, Y, i, sub, o, e):
    """The column-parallel staging of hard row ``i`` (JAX ``hard_row``,
    :529-580): every block's U/y pass and D candidates read pred rows
    only.  Dm/Y: the planes [n, B, P, Lp] with rows < i filled; sub:
    int32[B, Lp].  Returns the column program's inputs for columns
    1..Lp-1 — U, Dc int32[Lp-1, MB, B] (0 for invalid blocks), Dfd_own,
    Ypre int32[Lp-1, P, B] — and the row's fixed-up y plane
    int32[B, P, Lp] (column 0 set to 0)."""
    m = tabs.meta
    _, B, P, Lp = Dm.shape
    MB = m.maxb
    dev = Dm.device
    bm = tabs.blockmask[i]
    own = tabs.lanes[i, 0]
    ai = int(m.alphas[i])
    y_c = torch.zeros((B, P, Lp), dtype=_I32, device=dev)
    U = torch.zeros((MB, B, Lp), dtype=_I32, device=dev)
    Dc = torch.zeros((MB, B, Lp), dtype=_I32, device=dev)
    Dfd = torch.zeros((B, P, Lp), dtype=_I32, device=dev)
    for s in np.flatnonzero(m.bvalid[i]):
        p, tb, ap = int(m.bpred[i, s]), int(m.btb[i, s]), int(m.bap[i, s])
        d_s = int(m.bdelta[i, s])
        Dp, Yp = Dm[p], Y[p]
        yp_tb, yp_ap = Yp[:, tb], _lane(Yp, ap)
        dp_tb, dp_ap = Dp[:, tb], _lane(Dp, ap)
        u_y = yp_ap + d_s * yp_tb + e
        u_dpm = dp_ap + d_s * dp_tb + o + e
        usel = (u_dpm >= u_y)[:, None, :]
        maskb = (bm[s] & 1).bool()[None, :, None]
        elsemask = (bm[s] & (2 if m.bcase1[i, s] else 1)).bool()[None, :, None]
        y_c = torch.where(usel & maskb, Dp - d_s * dp_tb[:, None, :], y_c)
        y_c = torch.where(~usel & elsemask, Yp - d_s * yp_tb[:, None, :], y_c)
        u = torch.where(usel[:, 0, :], u_dpm, u_y)
        y_c[:, tb] = u
        Dp_sh = torch.roll(Dp, 1, 2)
        dsh_tb, dsh_ap = Dp_sh[:, tb], _lane(Dp_sh, ap)
        U[s] = u
        Dc[s] = dsh_ap + d_s * dsh_tb + sub
        Dfd = torch.where((own == int(s))[None, :, None], Dp_sh - d_s * dsh_tb[:, None, :], Dfd)
    # y's multi-alpha fixup reads only y (gap.rs:521-537); the column
    # program reads the PRE-fixup y, as the scalar program does
    y_fix = y_c.clone()
    for s in np.flatnonzero(m.bfire[i]):
        tb = int(m.btb[i, s])
        va = y_fix[:, tb] - y_fix[:, ai]
        y_fix[:, tb] = va
        y_fix = torch.where((bm[s] & 4).bool()[None, :, None], y_fix + va[:, None, :], y_fix)
    y_fix[:, :, 0] = 0
    cols = lambda a: a[..., 1:].permute(2, 0, 1).contiguous()  # noqa: E731
    return (U[:, :, 1:].permute(2, 0, 1).contiguous(), Dc[:, :, 1:].permute(2, 0, 1).contiguous(),
            cols(Dfd).transpose(1, 2).contiguous(), cols(y_c).transpose(1, 2).contiguous(), y_fix)


def hard_row_scalars(tabs: GapTables, i):
    """K12's per-block scalars for row ``i``: (tb, nd, fire, isa, after)
    int32[MB] on the tables' device, and the row alpha."""
    m = tabs.meta
    ai = int(m.alphas[i])
    blk = tabs.blocks[i]
    fl = blk[:, 3]
    tb = blk[:, 2].contiguous()
    bits = lambda b: ((fl & b) != 0).to(_I32)  # noqa: E731
    return (tb, (tb != ai).to(_I32), bits(BF_FIRE), bits(BF_ISA), bits(BF_AFTER)), ai


def hard_cols_plain(U, Dc, Dfd_own, Ypre, lc, x0, tb, nd, fire, isa, after, ai, o, e):
    """The hard-row column program (JAX ``col``, :648-695, against the
    owner-collapsed lane maps of ``pallas_gap67_hardrow.hard_cols_lc``,
    :38-165): carry x, d int32[P, B] over the columns.

    U, Dc: int32[C, MB, B]; Dfd_own, Ypre: int32[C, P, B]; lc:
    int32[4, P, B] (``lane_maps``); x0: int32[P, B]; tb, nd, fire, isa,
    after: int32[MB].  Returns xs, ds int32[C, P, B], the post-fixup x
    and d of each column.

    Each lane evaluates its owning block's scalar chain (the tb and
    alpha lanes of the previous column), as the kernel does; x and d
    travel stacked as one [2, P, B] state."""
    C, P, B = Ypre.shape
    dev = Ypre.device
    own, hot, fix, hotl = lc[0], lc[1] != 0, lc[2], lc[3] != 0
    owned = own >= 0
    hot_o = owned & hot
    ownc = own.clamp(min=0).long()
    tbl = tb.long()
    tb_o = tbl[ownc][None].expand(2, P, B)               # the owner's tb lane
    nd_o = nd[ownc]
    U_o = U.gather(1, ownc[None].expand(C, P, B))        # the owner's candidates
    Dc_o = Dc.gather(1, ownc[None].expand(C, P, B))
    oe = torch.tensor([e, o + e], dtype=_I32, device=dev).view(2, 1)
    # the fixup: the fire block holding each lane among its members, and
    # the fire block whose tb lane it is (fire tb lanes are distinct)
    infix = fix >= 0
    fixc = fix.clamp(min=0).long()[None].expand(2, P, B)
    tb_fire = torch.where(fire != 0, tbl, -1)
    firetb = (tb_fire[:, None] == torch.arange(P, device=dev)[None]).long().argmax(0)
    firetb = firetb[:, None].expand(P, B)[None].expand(2, P, B)
    isa_, after_, fire_ = (t[None, :, None] for t in (isa, after, fire))
    out = torch.empty((C, 2, P, B), dtype=_I32, device=dev)
    S = torch.stack([x0, x0])                            # x, d
    for c in range(C):
        S_ai = S[:, ai]                                  # [2, B]
        S_tb = S.gather(1, tb_o)                         # [2, P, B]
        Lxd = S_tb + nd_o * S_ai[:, None] + oe[:, :, None]   # l_x, l_dpm
        lsel = Lxd[1] >= Lxd[0]
        l_s = torch.where(lsel, Lxd[1], Lxd[0])
        mx = torch.maximum(torch.maximum(Dc_o[c], U_o[c]), l_s)
        is_d = mx == Dc_o[c]
        is_u = ~is_d & (mx == U_o[c])
        Sm = S - nd_o * S_tb
        xn = torch.where(owned, torch.where(hot_o, l_s, torch.where(lsel, Sm[1], Sm[0])), 0)
        dn = torch.where(is_d, Dfd_own[c], torch.where(is_u, Ypre[c], xn))
        dn = torch.where(owned, torch.where(hot_o, mx, dn), 0)
        # the multi-alpha fixup (gap.rs:521-537): one correction closes
        # the cascade, the member sets being disjoint
        N = torch.stack([xn, dn])
        va0 = N[:, tbl] - N[:, ai][:, None]              # [2, MB, B]
        va_adj = (va0 * isa_).sum(1, dtype=_I32)         # [2, B]
        va = (va0 - after_ * va_adj[:, None]) * fire_
        adds = torch.where(infix, va.gather(1, fixc), 0)
        S = torch.where(hotl, va.gather(1, firetb), N + adds)
        out[c] = S
    return out[:, 0], out[:, 1]


def chain_inputs(U, Dc, Dfd_own, Ypre, own):
    """The column program's two per-lane inputs from the staged ones (the
    arguments of ``hard_cols_plain``; own int[P, B], -1 none): V = max(Dc,
    U) of the lane's owner and W = Dfd_own where Dc >= U, else Ypre, both
    int32[C, P, B].  With them a lane's d is max(V, l) on its owner's tb
    lane and ``V >= l ? W : x`` elsewhere: the owner's D/U/L choice of
    ``hard_cols_plain`` (max(Dc, U, l) with Dc first, then U, on ties)."""
    C, P, B = Dfd_own.shape
    oc = own.clamp(min=0).long()[None].expand(C, P, B)
    Uo, Dco = U.gather(1, oc), Dc.gather(1, oc)
    return torch.maximum(Dco, Uo), torch.where(Dco >= Uo, Dfd_own, Ypre)


def hard_cols_chain_plain(V, W, slots, hubs, ai_slot, isa_slot, x0, o, e):
    """The hard-row column program from ``chain_coefs`` alone, as the CUDA
    kernel runs it: the hub slots [0, hubs) carry x and d column by
    column, reading the previous column and the pre-fixup values of other
    slots by slot; every other lane then follows from its own state and
    the hubs' values, its fixup adding the post-fixup value of its fix
    block's tb lane (a hub).  V, W: ``chain_inputs`` int32[C, P, B] per
    path; slots int32[4, P]; x0 int32[P, B].  Returns xs, ds int32[C, P,
    B] per path, equal to ``hard_cols_plain``'s."""
    C, P, B = V.shape
    path, tbs, fxs, fl = (slots[k].long() for k in range(4))
    col = lambda t: t[:, None]  # noqa: E731  [P] -> [P, 1]
    owned, fix, hub = col(tbs >= 0), col(fxs >= 0), col(torch.arange(P) < hubs)
    nd, aft = col((fl & CF_ND) != 0).to(_I32), col((fl & CF_AFTER) != 0).to(_I32)
    hot, hotl = col((fl & CF_HOT) != 0), col((fl & CF_HOTL) != 0)
    src_tb, src_fx = tbs.clamp(min=0), fxs.clamp(min=0)
    Vs, Ws = V[:, path], W[:, path]                     # slot order
    x = x0[path].clone()
    d = x.clone()
    out = torch.empty((C, 2, P, B), dtype=_I32, device=V.device)
    for c in range(C):
        sx, sd, ax, ad = x[src_tb], d[src_tb], x[ai_slot], d[ai_slot]
        lx = sx + nd * ax + e
        ld = sd + nd * ad + o + e
        lsel = ld >= lx
        l_ = torch.where(lsel, ld, lx)
        xv = torch.where(hot, l_, torch.where(lsel, d - nd * sd, x - nd * sx))
        dv = torch.where(hot, torch.maximum(Vs[c], l_), torch.where(Vs[c] >= l_, Ws[c], xv))
        xv, dv = torch.where(owned, xv, 0), torch.where(owned, dv, 0)
        # the hubs' fixup: a firing block's tb lane takes the correction,
        # a member of a firing block's fixup set adds it
        xai, dai = xv[ai_slot], dv[ai_slot]
        adj_x = xv[isa_slot] - xai if isa_slot >= 0 else 0
        adj_d = dv[isa_slot] - dai if isa_slot >= 0 else 0
        tx = xv[src_fx] - xai - aft * adj_x
        td = dv[src_fx] - dai - aft * adj_d
        xh = torch.where(hotl, tx, torch.where(fix, xv + tx, xv))
        dh = torch.where(hotl, td, torch.where(fix, dv + td, dv))
        # every other lane adds its fix block's tb lane's post-fixup value
        x = torch.where(hub, xh, torch.where(fix, xv + xh[src_fx], xv))
        d = torch.where(hub, dh, torch.where(fix, dv + dh[src_fx], dv))
        out[c, 0], out[c, 1] = x, d
    inv = torch.argsort(path)
    return out[:, 0, inv], out[:, 1, inv]


def _hard_row(tabs, Dm, Y, i, x0, sub, o, e):
    """A hard row (gap.rs:150-539): the staging, then the column
    program; returns (Drow, Xrow, Yrow)."""
    U, Dc, Dfd, Ypre, y_fix = stage_hard_row(tabs, Dm, Y, i, sub, o, e)
    (tb, nd, fire, isa, after), ai = hard_row_scalars(tabs, i)
    B = x0.shape[0]
    lc = tabs.lanes[i][:, :, None].expand(-1, -1, B)
    xs, ds = hard_cols_plain(U, Dc, Dfd, Ypre, lc, x0.t(), tb, nd, fire, isa, after, ai, o, e)
    Xrow = torch.cat([x0[:, :, None], xs.permute(2, 1, 0)], dim=2)
    Drow = torch.cat([x0[:, :, None], ds.permute(2, 1, 0)], dim=2)
    return Drow, Xrow, y_fix


def fill_gap_plain(tabs: GapTables, table, seq, o, e, semiglobal):
    """The delta-form fill as a torch row loop (JAX ``_fill_gap``).

    seq: int32[B, Lp] ('$'-prefixed, N-padded).  Returns (Dm, X, Y)
    int32[n, B, P, Lp]: row 0 holds the open+extend ladder on its alpha
    lane in Dm and Y (0 in X), row n-1 is 0, lanes no block writes are
    0, and column 0 of Y is 0."""
    m = tabs.meta
    n, P = m.n, m.P
    B, Lp = seq.shape
    dev = seq.device
    SUB = table.to(dev, _I32)[:, seq.long()]            # [7, B, Lp]
    jcol = torch.arange(Lp, dtype=_I32, device=dev)
    Dm = torch.zeros((n, B, P, Lp), dtype=_I32, device=dev)
    X = torch.zeros_like(Dm)
    Y = torch.zeros_like(Dm)
    ladder = (o + e * jcol) * (jcol >= 1)
    Dm[0, :, int(m.alphas[0])] = ladder
    Y[0, :, int(m.alphas[0])] = ladder
    lanemask = tabs.lanemask
    bm = tabs.blockmask
    for i in range(1, n - 1):
        ai = int(m.alphas[i])
        sub = SUB[int(m.codes[i])]
        if semiglobal:
            x0 = torch.zeros((B, P), dtype=_I32, device=dev)
        elif m.node_start[i]:
            x0 = _fc_start(X, i, ai, m, (bm[i] & 1).bool(), (bm[i] & 4).bool(), o, e)
        else:
            x0 = _fc_nonstart(X[i - 1, :, :, 0], i, ai, int(m.fap[i]), bool(m.fcommon_ap[i]),
                              (lanemask[i] & 2).bool(), o, e)
        if m.easy[i]:
            p = int(m.pr[i])
            Drow, Xrow, Yrow = _easy_row(Dm[p], Y[p], ai, int(m.eap[i]), int(m.edelta[i]),
                                         (lanemask[i] & 1).bool(), x0, sub, o, e, jcol)
        else:
            Drow, Xrow, Yrow = _hard_row(tabs, Dm, Y, i, x0, sub, o, e)
        Dm[i], X[i], Y[i] = Drow, Xrow, Yrow
    return Dm, X, Y


def fill_gap_device(g: PathGraph, sm: ScoreMatrix, seq, o: int, e: int, semiglobal: bool,
                    device=None):
    """The modes-6/7 fill of the encoded batch seq int32[B, Lp] on
    ``device`` (seq's device by default): the CUDA kernel (K11, with
    K12's column program in its hard rows) for every graph on a CUDA
    device, the plain torch fill on the CPU.  Returns (Dm, X, Y)
    int32[n, B, P, Lp]."""
    dev = torch.device(device) if device is not None else seq.device
    seq = seq.to(dev)
    tabs = gap_tables(g, dev)
    table = torch.as_tensor(np.asarray(sm.table), dtype=_I32).to(dev)
    if seq.is_cuda:
        return cuda_gap67_fill.fill_gap67_cuda(tabs, table, seq, o, e, semiglobal)
    return fill_gap_plain(tabs, table, seq, o, e, semiglobal)


# ---------------------------------------------------------------------------
# endings and plane extraction
# ---------------------------------------------------------------------------


def final_gap_column(Dm, L):
    """Dm[:, :, :, L-1] per read -> int32[B, n, P]."""
    n, B, P, _ = Dm.shape
    idx = (L.long() - 1)[None, :, None, None].expand(n, B, P, 1)
    return Dm.gather(3, idx)[..., 0].permute(1, 0, 2)


def _end_tables(g: PathGraph, device):
    """Per path: the last pred block of F covering it (-1 none) and that
    pred's alpha, for the mode-6 endings and the walk start; cached on
    the graph per device."""
    cache = g.__dict__.setdefault("_torch_gap_end", {})
    t = cache.get(str(device))
    if t is None:
        P = g.paths_number
        f_pred = np.full(P, -1, dtype=np.int64)
        for node, paths in g.preds_and_paths(g.n - 1):
            f_pred[paths] = node
        ap = np.where(f_pred >= 0, np.asarray(g.alphas)[np.maximum(f_pred, 0)], 0)
        t = cache[str(device)] = tuple(torch.from_numpy(a).to(device) for a in (f_pred, ap))
    return t


def _argmax_last(v):
    """Index of the maximum along the last axis, the LARGEST among ties
    (the JAX engine's ``max(range(P), key=(value, p))``)."""
    idx = torch.arange(v.shape[-1], device=v.device)
    return torch.where(v == v.max(-1, keepdim=True).values, idx, -1).max(-1).values


def endings_gap_global(finalcol, f_pred, f_ap):
    """``_endings_gap_global`` (:1039-1050) for a batch: the best path per
    read, int64[B].  Paths in no pred block of row n-1 score 0; a path
    in several blocks takes the last block's value."""
    B, n, P = finalcol.shape
    fc = finalcol.long()
    pidx = torch.arange(P, device=fc.device)
    rows = f_pred.clamp(min=0)
    own = fc[:, rows, pidx]                              # [B, P]
    alpha = fc[:, rows, f_ap]
    vals = torch.where(f_ap == pidx, own, own + alpha)
    vals = torch.where(f_pred >= 0, vals, 0)
    return _argmax_last(vals)


def endings_gap_semi(finalcol, alphas, on):
    """``_endings_gap_semi`` (:1053-1072) for a batch: (node, path)
    int64[B].  Per row, the paths on the node are rebased by the alpha
    lane and paths off it keep their raw delta (a leak the reference
    has); the best row is the first to reach the maximum."""
    B, n, P = finalcol.shape
    fc = finalcol[:, : n - 1].long()                     # rows 0..n-2
    al = alphas[: n - 1].long()
    a_val = fc.gather(2, al.clamp(max=P - 1)[None, :, None].expand(B, n - 1, 1))
    pidx = torch.arange(P, device=fc.device)
    rebase = on[: n - 1] & (pidx[None, :] != al[:, None])   # [n-1, P]
    absolute = torch.where(rebase[None], fc + a_val, fc)
    bpath = _argmax_last(absolute)                       # [B, n-1]
    best = absolute.max(-1).values
    ridx = torch.arange(n - 1, device=fc.device)
    node = torch.where(best == best.max(-1, keepdim=True).values, ridx, n).min(-1).values
    return node, bpath.gather(1, node[:, None])[:, 0]


def extract_gap_planes(Dm, X, Y, alphas, bp):
    """The four planes the walk reads, per read (JAX :913-930): dpm, x
    and y on the best path's lane and dpm on each row's alpha lane, each
    int32[B, n, Lp]."""
    n, B, P, Lp = Dm.shape
    bidx = torch.arange(B, device=Dm.device)
    bpl = bp.long()
    d_bp = Dm[:, bidx, bpl].transpose(0, 1)
    x_bp = X[:, bidx, bpl].transpose(0, 1)
    y_bp = Y[:, bidx, bpl].transpose(0, 1)
    ridx = torch.arange(n, device=Dm.device)
    d_al = Dm[ridx, :, alphas.long().clamp(max=P - 1)].transpose(0, 1)
    return d_bp.contiguous(), d_al.contiguous(), x_bp.contiguous(), y_bp.contiguous()


# ---------------------------------------------------------------------------
# the walk (mirrors the JAX engine's walk_gap_planes / _walk_gap)
# ---------------------------------------------------------------------------

# emitted codes, as pathwise_engine._cigar reads them (D->M, d->X, L->D, U->I)
_D, _LOWD, _L, _U = 1, 2, 3, 4


def walk_gap(dpm_bp, dpm_al, x_bp, y_bp, alphas, n_paths, bp, node_start, pred_of_bp,
             start_i, L, global_mode, max_steps):
    """Batched delta-form gap walk over the four planes (JAX
    ``_walk_gap``).  One phase applies per read per iteration (0 main
    dispatch, 1 U gap run, 2 L gap run, 3 trailing L, 4 trailing U in
    mode 6); phase changes may burn an iteration without emitting.
    Emission runs from the end back to the start.  The loop stops once
    every read is done or has failed (tested every ``CHECK_EVERY``
    iterations), or after ``max_steps``; ``err`` marks a read that left
    its best path, read an uncovered row or did not finish.

    Returns (dirs int32[B, max_steps], steps int32[B], stop row
    int32[B], err bool[B])."""
    B, n, Lp = dpm_bp.shape
    dev = dpm_bp.device
    dbf, daf = dpm_bp.reshape(B, n * Lp), dpm_al.reshape(B, n * Lp)
    xbf, ybf = x_bp.reshape(B, n * Lp), y_bp.reshape(B, n * Lp)
    al = alphas.long()
    bpl = bp.long()

    def at(flat, i, j):
        return flat.gather(1, (i * Lp + j).clamp(0, n * Lp - 1)[:, None])[:, 0]

    def abs_at(i, j):
        return at(dbf, i, j) + torch.where(al[i] != bpl, at(daf, i, j), 0)

    i = start_i.long()
    j = L.long() - 1
    z = torch.zeros(B, dtype=torch.long, device=dev)
    phase_, retained, k = z.clone(), z - 1, z.clone()
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    err = torch.zeros_like(done)
    dirs = torch.full((B, max_steps), -1, dtype=_I32, device=dev)
    for it in range(max_steps):
        if it % traceback_engine.CHECK_EVERY == 0 and bool((done | err).all()):
            break
        live = ~done & ~err
        is_start = node_start[i]
        pred_e = pred_of_bp.gather(1, i[:, None])[:, 0].long()
        covered = pred_e >= 0

        # phase 0: main loop
        p_main = live & (phase_ == 0)
        inner = (i > 0) & (j > 0)
        in_main = p_main & inner
        to_tail = p_main & ~inner
        zero_case = is_start & ~covered
        src_row = torch.where(is_start, pred_e.clamp(min=0), i - 1)
        d = torch.where(zero_case, 0, abs_at(src_row, j - 1))
        u = torch.where(zero_case, 0, abs_at(src_row, j))
        l_ = torch.where(zero_case, 0, abs_at(i, j - 1))
        mx = torch.maximum(torch.maximum(d, u), l_)
        is_d = mx == d
        is_u = ~is_d & (mx == u)
        curr = abs_at(i, j)
        code_main = torch.where(is_d, torch.where(curr < d, _LOWD, _D),
                                torch.where(is_u, _U, _L))
        bad_alpha = in_main & ((al[i] >= n_paths) | (~zero_case & (al[src_row] >= n_paths)))
        predecessor = torch.where(is_start & covered, pred_e, -1)
        step_i = torch.where(predecessor >= 0, predecessor, i - 1)

        # phase 1: U gap run (the predecessor is retained when no block
        # covers the path, output.rs:276-283)
        p_urun = live & (phase_ == 1)
        u_more = at(dbf, i, j) < at(ybf, i, j)
        p_new = torch.where(is_start, torch.where(covered, pred_e, retained), i - 1)
        u_err = p_urun & u_more & (p_new < 0)
        u_emit = p_urun & u_more & ~u_err

        # phase 2: L gap run
        p_lrun = live & (phase_ == 2)
        l_more = at(dbf, i, j) < at(xbf, i, j)
        l_emit = p_lrun & l_more

        # phases 3 and 4: trailing L, trailing U (mode 6)
        p_ltail = live & (phase_ == 3)
        lt_emit = p_ltail & (j > 0)
        p_utail = live & (phase_ == 4)
        ut_emit = p_utail & (i > 0)

        emit = in_main | u_emit | l_emit | lt_emit | ut_emit
        code = torch.where(in_main, code_main,
                           torch.where(u_emit, _U, torch.where(l_emit | lt_emit, _L, _U)))
        i_new = torch.where(in_main & (is_d | is_u), step_i, i)
        i_new = torch.where(u_emit, p_new.clamp(min=0), i_new)
        i_new = torch.where(ut_emit, i - 1, i_new)      # no-pred tail quirk
        j_dec = (in_main & (is_d | ~(is_d | is_u))) | l_emit | lt_emit
        j_new = torch.where(j_dec, j - 1, j)
        phase_new = torch.where(in_main, torch.where(is_d, 0, torch.where(is_u, 1, 2)), phase_)
        phase_new = torch.where(to_tail, 3, phase_new)
        phase_new = torch.where(p_urun & ~u_more, 0, phase_new)
        phase_new = torch.where(p_lrun & ~l_more, 0, phase_new)
        tail_done = p_ltail & (j == 0)
        phase_new = torch.where(tail_done & global_mode, 4, phase_new)
        done = done | (tail_done & (not global_mode)) | (p_utail & (i == 0))
        retained = torch.where(in_main & is_u, predecessor, retained)
        retained = torch.where(u_emit, p_new, retained)
        err = err | u_err | bad_alpha
        old = dirs.gather(1, k[:, None])[:, 0]
        dirs.scatter_(1, k[:, None], torch.where(emit, code, old).to(_I32)[:, None])
        k = k + emit.long()
        i, j, phase_ = i_new, j_new, phase_new
    return dirs, k.to(_I32), i.to(_I32), err | ~done


def count_to_source_table(g: PathGraph) -> np.ndarray:
    """Steps from (row, path) back to the source, int64[n, P]: the
    semiglobal tail node counts (output.rs:413-445), -1 where the walk
    leaves the path (the reference loops forever there)."""
    n, P = g.n, g.paths_number
    t = g.__dict__.get("_count_to_source")
    if t is None:
        t = np.full((n, P), -1, dtype=np.int64)
        t[0] = 0
        for i in range(1, n):
            if g.node_start[i]:
                for p, paths in g.preds_and_paths(i):
                    t[i, paths] = np.where(t[p, paths] >= 0, t[p, paths] + 1, -1)
                # paths in no block keep -1
            else:
                t[i] = np.where(t[i - 1] >= 0, t[i - 1] + 1, -1)
        g.__dict__["_count_to_source"] = t
    return t


_TAIL_ERR = "semiglobal tail left the best path (the reference loops forever on such inputs)"
_WALK_ERR = "gap traceback left the best path (the reference hangs/crashes on such inputs)"


def lines_from_walks(dirs, steps, stop_i, errs, bps, nodes, g, semiglobal):
    """The printed CIGAR lines of walked reads (JAX ``run_batch``,
    :1152-1171): mode 6 drops the last move (output.rs:304), mode 7
    adds ``(start end)`` node counts."""
    cts = count_to_source_table(g) if semiglobal else None
    out = []
    for b in range(len(bps)):
        if errs[b]:
            raise RuntimeError(_WALK_ERR)
        d_f = np.asarray(dirs[b, : int(steps[b])])[::-1]
        if semiglobal:
            starting = cts[int(stop_i[b]), bps[b]]
            final = cts[int(nodes[b]), bps[b]]
            if starting < 0 or final < 0:
                raise RuntimeError(_TAIL_ERR)
            out.append(f"{_cigar(d_f)}\t({starting} {final})")
        else:
            out.append(_cigar(d_f[:-1]))
    return out


# ---------------------------------------------------------------------------
# batch driver
# ---------------------------------------------------------------------------


def run_batch(mode: int, sequences, g: PathGraph, sm: ScoreMatrix, o: int, e: int, device,
              chunk_bytes=None) -> list[tuple[int, str]]:
    """Modes 6/7: [(best_path, printed line), ...] per read, matching the
    oracle's exec_gap_global / exec_gap_semiglobal.

    Fill chunks hold ``chunk_bytes`` (default ``CHUNK_BYTES[device]``)
    of the three planes; per chunk the fill, final column, endings and
    the walk's four planes, after which the full planes are freed.  One
    walk loop serves every chunk whose extracted planes fit
    ``WALK_BYTES``."""
    if mode not in (6, 7):
        raise ValueError(f"pathwise affine-gap modes are 6 and 7, got {mode}")
    device = torch.device(device)
    if chunk_bytes is None:
        chunk_bytes = CHUNK_BYTES[device.type]
    semiglobal = mode == 7
    gap_tables(g, device)             # RejectedGraph before any work
    dg = path_device_graph(g, device)
    n, P = g.n, g.paths_number
    Lp_all = max(len(s) for s in sequences)
    Lp = (Lp_all + 7) // 8 * 8        # the planes' width: encode_reads pads to a multiple of 8
    chunk = max(1, chunk_bytes // (3 * n * P * Lp * 4))
    walk_batch = max(1, WALK_BYTES[device.type] // (4 * n * Lp * 4))
    max_steps = 2 * (n + Lp_all) + 8
    f_pred, f_ap = _end_tables(g, device)
    alphas = torch.from_numpy(np.asarray(g.alphas, dtype=np.int64)).to(device)
    out: list[tuple[int, str]] = []
    pend: list = []   # (L, planes, bp, start_i, node)

    def flush():
        if not pend:
            return
        Ls, planes_l, bps, starts, nodes = zip(*pend)
        pend.clear()
        cat = lambda ts: torch.cat(ts) if len(ts) > 1 else ts[0]  # noqa: E731
        L, bp, start_i, node = (cat(t) for t in (Ls, bps, starts, nodes))
        planes = tuple(cat([p[q] for p in planes_l]) for q in range(4))
        del planes_l
        pred_of_bp = dg.pred_of.t()[bp]
        with phase("walk"):
            dirs, steps, stop_i, errs = walk_gap(
                *planes, alphas, P, bp, dg.node_start, pred_of_bp, start_i, L,
                not semiglobal, max_steps)
        del planes
        with phase("device_wait"):
            kmax = min(max_steps, (int(steps.max()) + 63) // 64 * 64)
        with phase("fetch"):
            dirs, steps, stop_i, errs = (t.cpu().numpy() for t in
                                         (dirs[:, :kmax], steps, stop_i, errs))
            bps, nodes = bp.cpu().numpy(), node.cpu().numpy()
        with phase("emit"):
            lines = lines_from_walks(dirs, steps, stop_i, errs, bps, nodes, g, semiglobal)
        out.extend((int(b), ln) for b, ln in zip(bps, lines))

    pend_reads = 0
    for c0 in range(0, len(sequences), chunk):
        chunk_seqs = sequences[c0 : c0 + chunk]
        with phase("encode"):
            seq, L = encode_reads(chunk_seqs, pad_to=Lp_all, device=device)
        with phase("fill"):
            Dm, X, Y = fill_gap_device(g, sm, seq, o, e, semiglobal)
        with phase("endings"):
            fc = final_gap_column(Dm, L)
            if semiglobal:
                node, bp = endings_gap_semi(fc, alphas, dg.paths_on)
                start_i = node
            else:
                bp = endings_gap_global(fc, f_pred, f_ap)
                node = torch.zeros_like(bp)
                start_i = f_pred[bp].clamp(min=0)
        with phase("dispatch"):
            planes = extract_gap_planes(Dm, X, Y, alphas, bp)
        del Dm, X, Y, fc
        pend.append((L, planes, bp, start_i, node))
        pend_reads += len(chunk_seqs)
        if pend_reads + chunk > walk_batch:
            flush()
            pend_reads = 0
    flush()
    return out
