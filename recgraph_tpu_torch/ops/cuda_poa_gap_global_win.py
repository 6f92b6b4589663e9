"""Windowed mode-2 fill on the GPU: wrapper of K6, the window form of the
CUDA kernel ``csrc/poa_gap_global.cu`` (K4's body).

Replaces ``recgraph_tpu/ops/pallas_gap_global_win.py:413
fill_gap_global_win``.  Its plain version is
``poa_gap_engine.fill_gap_global_windowed_plain``; both return (score,
last_row, last_col_abs, packed, packed_x, packed_y int32[B, n, W],
lefts, rights, ws int32[B, n], over bool[B]) and agree bit for bit for
every sign of the penalties: the prefix-max chain where it is exact, the
clamped chain past that (``cuda_poa_gap_global.check_chain_range``, on
the read width Lp: the chain runs on absolute columns).
``metrics.LAUNCHES["poa_gap_global_win"]`` counts the launches.

The launch layout is K4's over the W stored columns
(``cuda_poa_gap_local.plan(B, W, sms)``); the rows kept in the device
scratch [B, S, W] are K4's (``stored_rows(..., every_row=True)``), each
at its own window start.
"""

from __future__ import annotations

import torch

from . import _kernels
from .cuda_poa_gap_global import check_chain_range
from .cuda_poa_gap_local import MAX_SLOTS, Plan, plan, stored_rows

KERNEL = "poa_gap_global_win"
SOURCE = "recgraph_tpu_torch/csrc/poa_gap_global.cu"
REPLACES = "recgraph_tpu/ops/pallas_gap_global_win.py:413"


def fill_gap_global_win_cuda(dg, table, seq, L, bta, o, e, W, layout: Plan | None = None):
    """Launch the windowed mode-2 fill (W columns per row) on the GPU
    (``layout``: a :class:`~cuda_poa_gap_local.Plan` over W columns to
    force, else ``plan``'s)."""
    dev = seq.device
    B, Lp = seq.shape
    n = dg.n
    pidx, cand, _ = _kernels.check_inputs(KERNEL, dg, table, seq, L, bta)
    if W < 8:
        raise ValueError(f"{KERNEL}: window width {W} < 8")
    if dg.max_preds > MAX_SLOTS:
        raise ValueError(f"{KERNEL}: {dg.max_preds} predecessor slots, at most {MAX_SLOTS}")
    W = int(W)
    pl = layout or plan(B, W, torch.cuda.get_device_properties(dev).multi_processor_count)
    store_at, srow, S = stored_rows(dg, pl.full, every_row=True)
    _kernels.check_tensors(KERNEL, dev, store_at=store_at, srow=srow)
    i32 = dict(dtype=torch.int32, device=dev)
    ms, ys = (torch.empty((B, S, W), **i32) for _ in range(2))    # the stored rows' m and y
    bsp, mlast = torch.empty((2, B, n), **i32)   # each row's best column and m at right - 1
    score, last_row, last_col = (torch.empty(B, **i32) for _ in range(3))
    packed, packed_x, packed_y = (torch.empty((B, n, W), **i32) for _ in range(3))
    lefts, rights, wss = (torch.empty((B, n), **i32) for _ in range(3))
    over = torch.empty(B, dtype=torch.bool, device=dev)
    _kernels.launch(
        KERNEL, (B, n, Lp, W), dev,
        seq, L, bta, table, dg.codes, pidx, dg.min_pred, dg.r_values, cand, srow, store_at,
        int(cand.numel()), B, n, dg.max_preds, Lp, W, int(o), int(e), pl.cw, pl.warps,
        int(pl.full), int(not check_chain_range(o, e, n, Lp)), S, ms, ys, bsp, mlast,
        score, last_row, last_col, packed, packed_x, packed_y, lefts, rights, wss, over,
    )
    return (score, last_row, last_col, packed, packed_x, packed_y, lefts, rights,
            wss, over)
