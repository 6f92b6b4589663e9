"""Windowed mode-0 fill on the GPU: wrapper of K3, the window form of the
CUDA kernel ``csrc/poa_global.cu`` (K1's body).

Replaces ``recgraph_tpu/ops/pallas_poa_global_win.py:417 fill_global_win``.
Its plain version is ``poa_engine.fill_global_windowed_plain``; both
return (score, last_row, last_col_abs, packed int32[B, n, W], lefts,
rights, ws int32[B, n], over bool[B]) and agree bit for bit, on reads
that overflow their window too.
``metrics.LAUNCHES["poa_global_win"]`` counts the launches.

The launch layout is K1's over the W stored columns
(``cuda_poa_gap_local.plan(B, W, sms)``); the rows kept in the device
scratch [B, S, W] are K1's (``stored_rows(..., every_row=True)``), each
at its own window start, and the read's gap sums G (on absolute columns)
are kept in a scratch [B, Lp].
"""

from __future__ import annotations

import torch

from . import _kernels
from .cuda_poa_gap_local import MAX_SLOTS, Plan, plan, stored_rows

KERNEL = "poa_global_win"
SOURCE = "recgraph_tpu_torch/csrc/poa_global.cu"
REPLACES = "recgraph_tpu/ops/pallas_poa_global_win.py:417"


def fill_global_win_cuda(dg, table, seq, L, bta, W, layout: Plan | None = None):
    """Launch the windowed mode-0 fill (W columns per row) on the GPU
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
    ms = torch.empty((B, S, W), **i32)    # the stored rows' m
    gs = torch.empty((B, Lp), **i32)      # the read's gap sums G
    # each row's best column, m at its band start and m at right - 1
    bsp, mfirst, mlast = torch.empty((3, B, n), **i32)
    score, last_row, last_col = (torch.empty(B, **i32) for _ in range(3))
    packed = torch.empty((B, n, W), **i32)
    lefts, rights, wss = (torch.empty((B, n), **i32) for _ in range(3))
    over = torch.empty(B, dtype=torch.bool, device=dev)
    _kernels.launch(
        KERNEL, (B, n, Lp, W), dev,
        seq, L, bta, table, dg.codes, pidx, dg.min_pred, dg.r_values, cand, srow, store_at,
        int(cand.numel()), B, n, dg.max_preds, Lp, W, pl.cw, pl.warps, int(pl.full), S, ms, gs,
        bsp, mfirst, mlast, score, last_row, last_col, packed, lefts, rights, wss, over,
    )
    return score, last_row, last_col, packed, lefts, rights, wss, over
