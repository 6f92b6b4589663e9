"""Windowed mode-4 fill on the GPU: wrapper of ``csrc/pathwise_win.cu``.

Replaces ``recgraph_tpu/ops/pallas_pathwise_win.py:409
fill_pathwise_win_pallas``, but computes what the XLA engine
``pathwise_window._fill_pathwise_win`` computes (a per-read, per-row
window start, not the Pallas kernel's tile-uniform one).  Its plain
version is ``pathwise_window.fill_pathwise_win_plain``; both return
(Aw int32[B, P, n, W], ws int32[B, n], bound int32[B]) and agree bit for
bit.  ``metrics.LAUNCHES["pathwise_win"]`` counts the launches and
``metrics.SHAPES`` records (reads, rows, Lp, W, paths).

:func:`plan` lays out a launch of one block a read: the threads a block
and whether the per-read scratch fits in shared memory.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _kernels, cuda_pathwise
from .encode import group_table

KERNEL = "pathwise_win"
SOURCE = "recgraph_tpu_torch/csrc/pathwise_win.cu"
REPLACES = "recgraph_tpu/ops/pallas_pathwise_win.py:409"

MAX_THREADS = 512           # the kernel's __launch_bounds__ (PWW_THREADS)
SMEM_MAX = 160 * 1024       # dynamic shared memory a block may take


@dataclass(frozen=True)
class Plan:
    threads: int       # threads a block
    smem: int          # dynamic shared memory a block, bytes
    smem_form: bool    # the per-read scratch in shared memory
    stride: int        # device scratch a block, bytes (0 in the shared-memory form)


def _a4(x: int) -> int:
    return (x + 3) // 4 * 4


def scratch_bytes(Lp: int, n: int, W: int, Gd: int, P: int) -> int:
    """The per-read scratch of K10 (``PwwScratch``): the read's gap
    prefix sums, each row's window start and best position, the row's
    floor, the (src, add) table of each of the Gd groups, the P lanes'
    staged source rows and their rows i-1 and i as int32, the read codes
    as bytes; each rounded up to 4 entries, a multiple of 16."""
    ints = _a4(Lp) + 2 * _a4(n) + _a4(W) * (1 + 2 * Gd + 3 * P)
    return (4 * ints + _a4(Lp) + 15) // 16 * 16


def plan(B: int, P: int, n: int, Lp: int, W: int, Gd: int, sms: int, per_sm,
         meta: int | None = None) -> Plan:
    """The launch of K10 for B reads of width Lp, windows of W columns, on
    a graph of n rows, P paths and Gd groups a row, on a card of ``sms``
    SMs, one block a read; ``per_sm(threads, smem, smem_form)`` gives the
    blocks an SM holds at once.

    - The scratch in shared memory while it fits in ``SMEM_MAX`` beside
      the row tables (``meta`` bytes, by default K10's
      ``cuda_pathwise.meta_bytes``), else in device memory.
    - Threads: one per four columns of the lanes (one per column when W
      is not a multiple of 4), 64 to ``MAX_THREADS``; a warp fewer while
      an SM could not hold its share of the blocks at once.
    """
    small = cuda_pathwise.meta_bytes(Gd, P) if meta is None else meta
    scratch = scratch_bytes(Lp, n, W, Gd, P)
    smem_form = small + scratch <= SMEM_MAX
    smem = small + scratch if smem_form else small
    items = P * (W // 4 if W % 4 == 0 else W)
    threads = min(MAX_THREADS, max(64, -(-items // 32) * 32))
    need = -(-B // sms)
    while threads > 64 and per_sm(threads, smem, smem_form) < need:
        threads -= 32
    return Plan(threads, smem, smem_form, 0 if smem_form else scratch)


def row_tables(dg):
    """int32[n, 1 + 2 Gd + P], each row's tables as K10 loads them (one
    int a lane): the node code with the row's group count (code | count
    << 8), the groups' reps and pred rows (``encode.group_table``'s grep
    and gpred) and each lane's group (pslot); cached on the graph."""
    def build():
        grep, gpred, pslot = group_table(dg)
        head = dg.codes.to(torch.int32) | (cuda_pathwise.group_counts(dg) << 8)
        return torch.cat([head[:, None], grep, gpred, pslot], 1).to(torch.int32).contiguous()

    return dg.cached("_win_row_tables", build)


_per_sm_cache: dict = {}


def launch_plan(dev, B, P, n, Lp, W, Gd, entry="rgt_pathwise_win_per_sm", meta=None) -> Plan:
    """:func:`plan` on ``dev``, the occupancy from ``entry`` (K10's, or
    S2's with its ``meta`` bytes of row tables)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def per_sm(threads, smem, smem_form):
        key = (entry, dev.index, threads, smem, smem_form)
        if key not in _per_sm_cache:
            with torch.cuda.device(dev):
                v = getattr(_kernels.load(), entry)(threads, smem, int(smem_form))
            _kernels.check(-v if v < 0 else 0, entry)
            _per_sm_cache[key] = v
        return _per_sm_cache[key]

    return plan(B, P, n, Lp, W, Gd, sms, per_sm, meta)


def fill_pathwise_win_cuda(dg, table, seq, L, W, rmin):
    """Launch the windowed pathwise fill (W columns per row) on the GPU."""
    dev = seq.device
    B, Lp = seq.shape
    n, P = dg.n, dg.paths_number
    Gd = group_table(dg)[0].shape[1]
    meta = row_tables(dg)
    _kernels.check_tensors(KERNEL, dev, seq=seq, L=L, table=table, meta=meta, rmin=rmin)
    if table.shape != (7, 7) or L.shape != (B,) or rmin.shape != (n,):
        raise ValueError(f"{KERNEL}: bad shapes table {tuple(table.shape)}, "
                         f"L {tuple(L.shape)}, rmin {tuple(rmin.shape)}")
    if not 8 <= W <= Lp:
        raise ValueError(f"{KERNEL}: window width {W} outside [8, {Lp}]")
    W = int(W)
    pl = launch_plan(dev, B, P, n, Lp, W, Gd)
    scratch = torch.empty(max(16, B * pl.stride), dtype=torch.uint8, device=dev)
    Aw = torch.empty((B, P, n, W), dtype=torch.int32, device=dev)
    ws = torch.empty((B, n), dtype=torch.int32, device=dev)
    bound = torch.empty(B, dtype=torch.int32, device=dev)
    _kernels.launch(
        KERNEL, (B, n, Lp, W, P), dev,
        seq, L, table, meta, rmin, B, n, P, Lp, Gd, W,
        pl.threads, pl.smem, int(pl.smem_form), scratch, pl.stride, Aw, ws, bound,
    )
    return Aw, ws, bound
