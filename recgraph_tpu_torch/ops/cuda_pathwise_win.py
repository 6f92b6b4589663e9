"""Windowed mode-4 fill on the GPU: wrapper of ``csrc/pathwise_win.cu``.

Replaces ``recgraph_tpu/ops/pallas_pathwise_win.py:409
fill_pathwise_win_pallas``, but computes what the XLA engine
``pathwise_window._fill_pathwise_win`` computes (a per-read, per-row
window start, not the Pallas kernel's tile-uniform one).  Its plain
version is ``pathwise_window.fill_pathwise_win_plain``; both return
(Aw int32[B, P, n, W], ws int32[B, n], bound int32[B]) and agree bit for
bit.  ``metrics.LAUNCHES["pathwise_win"]`` counts the launches and
``metrics.SHAPES`` records (reads, rows, Lp, W, paths).
"""

from __future__ import annotations

import torch

from . import _kernels
from .encode import group_table

KERNEL = "pathwise_win"
SOURCE = "recgraph_tpu_torch/csrc/pathwise_win.cu"
REPLACES = "recgraph_tpu/ops/pallas_pathwise_win.py:409"


def fill_pathwise_win_cuda(dg, table, seq, L, W, rmin):
    """Launch the windowed pathwise fill (W columns per row) on the GPU."""
    dev = seq.device
    B, Lp = seq.shape
    n, P = dg.n, dg.paths_number
    grep, gpred, pslot = group_table(dg)
    Gd = grep.shape[1]
    _kernels.check_tensors(KERNEL, dev, seq=seq, L=L, table=table, codes=dg.codes,
                           grep=grep, gpred=gpred, pslot=pslot, rmin=rmin)
    if table.shape != (7, 7) or L.shape != (B,) or rmin.shape != (n,):
        raise ValueError(f"{KERNEL}: bad shapes table {tuple(table.shape)}, "
                         f"L {tuple(L.shape)}, rmin {tuple(rmin.shape)}")
    if not 8 <= W <= Lp:
        raise ValueError(f"{KERNEL}: window width {W} outside [8, {Lp}]")
    i32 = dict(dtype=torch.int32, device=dev)
    gw = torch.empty((B, W), **i32)                # window-local gap sums
    kidx = torch.empty((B, Gd, W), **i32)          # per group: last non-L lane
    flag = torch.empty((B, Gd, W), **i32)          # per group: the rep moved D
    rowv = torch.empty((B, W), **i32)              # best on-lane value per lane
    bsp = torch.empty((B, n), **i32)               # best-scoring column per row
    Aw = torch.empty((B, P, n, W), **i32)
    ws = torch.empty((B, n), **i32)
    bound = torch.empty(B, **i32)
    _kernels.launch(
        KERNEL, (B, n, Lp, int(W), P), dev,
        seq, L, table, dg.codes, grep, gpred, pslot, rmin, B, n, P, Lp, Gd, int(W),
        gw, kidx, flag, rowv, bsp, Aw, ws, bound,
    )
    return Aw, ws, bound
