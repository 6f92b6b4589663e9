"""Windowed mode-2 fill on the GPU: wrapper of ``csrc/poa_gap_global_win.cu``.

Replaces ``recgraph_tpu/ops/pallas_gap_global_win.py:413
fill_gap_global_win``.  Its plain version is
``poa_gap_engine.fill_gap_global_windowed_plain``; both return (score,
last_row, last_col_abs, packed, packed_x, packed_y int32[B, n, W],
lefts, rights, ws int32[B, n], over bool[B]) and agree bit for bit.
``metrics.LAUNCHES["poa_gap_global_win"]`` counts the launches.
"""

from __future__ import annotations

import torch

from . import _kernels

KERNEL = "poa_gap_global_win"
SOURCE = "recgraph_tpu_torch/csrc/poa_gap_global_win.cu"
REPLACES = "recgraph_tpu/ops/pallas_gap_global_win.py:413"


def fill_gap_global_win_cuda(dg, table, seq, L, bta, o, e, W):
    """Launch the windowed mode-2 fill (W columns per row) on the GPU."""
    dev = seq.device
    B, Lp = seq.shape
    n = dg.n
    pidx, cand, _ = _kernels.check_inputs(KERNEL, dg, table, seq, L, bta)
    if W < 8:
        raise ValueError(f"{KERNEL}: window width {W} < 8")
    i32 = dict(dtype=torch.int32, device=dev)
    m, y = (torch.empty((B, n, W), **i32) for _ in range(2))    # m/y scratch
    bsp = torch.empty((B, n), **i32)
    score, last_row, last_col = (torch.empty(B, **i32) for _ in range(3))
    packed, packed_x, packed_y = (torch.empty((B, n, W), **i32) for _ in range(3))
    lefts, rights, wss = (torch.empty((B, n), **i32) for _ in range(3))
    over = torch.empty(B, dtype=torch.bool, device=dev)
    _kernels.launch(
        KERNEL, (B, n, Lp, int(W)), dev,
        seq, L, bta, table, dg.codes, pidx, dg.min_pred, dg.r_values,
        cand, int(cand.numel()), B, n, dg.max_preds, Lp, int(W), int(o), int(e), m, y,
        bsp, score, last_row, last_col, packed, packed_x, packed_y, lefts, rights,
        wss, over,
    )
    return (score, last_row, last_col, packed, packed_x, packed_y, lefts, rights,
            wss, over)
