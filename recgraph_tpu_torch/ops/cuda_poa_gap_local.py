"""Mode-3 fill on the GPU: wrapper of the CUDA kernel ``csrc/poa_gap_local.cu``.

Replaces ``recgraph_tpu/ops/pallas_gap_local.py:271 fill_gap_local_v2``.
Its plain version is ``poa_gap_engine.fill_gap_local_plain``; both
return (best_val, best_i, best_j, packed, packed_x, packed_y
int32[B, n, Lp]) and agree bit for bit for every sign of the penalties:
the kernel's prefix-max chain where it is exact, its clamped chain past
that (:func:`check_chain_range` picks).
``metrics.LAUNCHES["poa_gap_local"]`` counts the launches.

:func:`plan` lays out a launch (warps a read, columns a lane, register or
full form; one read a block) and :func:`stored_rows` picks the rows
whose m and y the kernel keeps in its device scratch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _kernels

KERNEL = "poa_gap_local"
SOURCE = "recgraph_tpu_torch/csrc/poa_gap_local.cu"
REPLACES = "recgraph_tpu/ops/pallas_gap_local.py:271"

CHAIN_COLS = (1, 3, 5, 7)      # columns a lane of the register form (odd: no bank conflicts)
WIDE_COLS = (5, 7)             # columns a lane of reads on several warps
FULL_COLS = 9                  # columns a lane of the full form
MAX_WARPS = 16                 # warps a read (GL_MAX_WARPS)
MAX_THREADS = 512              # the kernel's __launch_bounds__ (GL_THREADS)
MAX_SLOTS = 4095               # predecessor slots a row (12 bits in the kernel)
CHAIN_RANGE = 1 << 27          # (|o| + |e|) x Lp below this: the prefix-max chain is exact


@dataclass(frozen=True)
class Plan:
    warps: int    # warps a read (a block)
    cw: int       # columns a lane
    full: bool    # every row's m and y in the device scratch (windows)


def plan(B: int, Lp: int, sms: int) -> Plan:
    """The launch of K5 for B reads of width Lp on a card of ``sms`` SMs.

    - Up to 32 x 7 = 224 columns: one warp a read, the fewest columns a
      lane of ``CHAIN_COLS`` that cover the read (a block of one warp: a
      stretch chunk of 1,241 reads is resident at once on an H100).
    - Wider reads: one block a read of w warps at 5 columns a lane, else
      at 7, w the fewest that cover the read (at most ``MAX_WARPS``).
    - Past 16 warps x 224 columns: the full form, 16 warps at 9 columns a
      lane in windows, every row's m and y in the device scratch (9
      columns a lane spill registers in the register form, not here).
    """
    if Lp <= 32 * CHAIN_COLS[-1]:
        cw = next(c for c in CHAIN_COLS if 32 * c >= Lp)
        return Plan(1, cw, False)
    for cw in WIDE_COLS:
        w = -(-Lp // (32 * cw))
        if w <= MAX_WARPS:
            return Plan(w, cw, False)
    return Plan(MAX_WARPS, FULL_COLS, True)


def stored_rows(dg, full: bool = False, every_row: bool = False):
    """The rows whose scratch rows (m and y for K4 and K5, m for K2) a
    warp-layout fill writes to device memory, on the graph's device:
    (store_at int32[n], the scratch row each row is written to or -1;
    srow int32[n, Pm], the scratch row of each slot's predecessor that a
    row reads from the scratch, or -1; S, the scratch rows a read, at
    least 1).

    The register form keeps row i-1 in registers, so a row is stored iff
    a row that reads its predecessors (a start row of K2 and K5; with
    ``every_row``, any row: K4) lists it as a predecessor other than its
    row i-1; the full form stores every row (store_at[i] = i, srow = the
    slots' predecessors).  Cached on the graph.
    """
    def build():
        pidx = _kernels.graph_args(dg)[0]
        n = dg.n
        rows = torch.arange(n, dtype=torch.int32, device=pidx.device)
        if full:
            return rows, pidx, n
        reads = (torch.ones(n, dtype=torch.bool, device=pidx.device) if every_row
                 else dg.node_start.to(pidx.device))
        need = reads[:, None] & (pidx >= 0) & (pidx != rows[:, None] - 1)
        flag = torch.zeros(n, dtype=torch.bool, device=pidx.device)
        flag[pidx[need].long()] = True
        store_at = torch.where(flag, torch.cumsum(flag, 0, dtype=torch.int32) - 1, -1)
        srow = torch.where(need, store_at[pidx.clamp(min=0).long()], -1)
        return (store_at.to(torch.int32).contiguous(), srow.to(torch.int32).contiguous(),
                max(1, int(flag.sum())))

    return dg.cached(f"_warp_fill_rows_{int(bool(full))}_{int(bool(every_row))}", build)


def check_chain_range(o: int, e: int, Lp: int) -> bool:
    """Whether K5's prefix-max chain is exact: True while
    (|o| + |e|) x Lp < 2^27, else the wrapper takes the clamped chain.

    In mode 3, c >= 0, so x >= j g >= -(|o| + |e|) Lp and the composed
    maps' sums stay above that too: below 2^27 the reference's 2x2 map
    scan never clamps (its NEG entries stay below every real value) and
    the chain's (j + 1) g terms stay in int32.  Past it the clamped chain
    composes the maps x -> max(x + g, b) clamped to NEG, as the reference
    does."""
    return (abs(int(o)) + abs(int(e))) * int(Lp) < CHAIN_RANGE


def fill_gap_local_cuda(dg, table, seq, L, o, e, layout: Plan | None = None):
    """Launch the mode-3 fill for a read batch on the tensors' GPU
    (``layout``: a :class:`Plan` to force, else :func:`plan`'s)."""
    dev = seq.device
    B, Lp = seq.shape
    n = dg.n
    pidx, _, node_start = _kernels.check_inputs(KERNEL, dg, table, seq, L)
    if dg.max_preds > MAX_SLOTS:
        raise ValueError(f"{KERNEL}: {dg.max_preds} predecessor slots, at most {MAX_SLOTS}")
    pl = layout or plan(B, Lp, torch.cuda.get_device_properties(dev).multi_processor_count)
    store_at, srow, S = stored_rows(dg, pl.full)
    _kernels.check_tensors(KERNEL, dev, store_at=store_at, srow=srow)
    i32 = dict(dtype=torch.int32, device=dev)
    ms, ys = (torch.empty((B, S, Lp), **i32) for _ in range(2))   # the stored rows' m and y
    best_val, best_i, best_j = (torch.empty(B, **i32) for _ in range(3))
    packed, packed_x, packed_y = (torch.empty((B, n, Lp), **i32) for _ in range(3))
    _kernels.launch(
        KERNEL, (B, n, Lp, Lp), dev,
        seq, L, table, dg.codes, node_start, pidx, srow, store_at, B, n, dg.max_preds, Lp,
        int(o), int(e), pl.cw, pl.warps, int(pl.full), int(not check_chain_range(o, e, Lp)),
        S, ms, ys,
        best_val, best_i, best_j, packed, packed_x, packed_y,
    )
    return best_val, best_i, best_j, packed, packed_x, packed_y
