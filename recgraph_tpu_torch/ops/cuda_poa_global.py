"""Mode-0 fill on the GPU: wrapper of the CUDA kernel ``csrc/poa_global.cu``
(K1; its window form K3 is ``cuda_poa_global_win``, its v1-layout form
K14 ``cuda_poa_variants.fill_global_v1_cuda``).

Replaces ``recgraph_tpu/ops/pallas_poa_global2.py:477 fill_global_v2``.
Its plain version is ``poa_engine.fill_global_plain``; both return
(score, last_row, last_col_abs, packed int32[B, n, Lp], lefts, rights)
and agree bit for bit, at any read length.
``metrics.LAUNCHES["poa_global"]`` counts the launches.

The launch layout is K5's (``cuda_poa_gap_local.plan``: warps a read,
columns a lane, register or full form; one read a block); the rows kept
in the device scratch are K4's, every predecessor of a row other than
its row i-1 (``cuda_poa_gap_local.stored_rows`` with ``every_row``), and
the full form keeps the read's gap sums G in one more scratch row.
"""

from __future__ import annotations

import torch

from . import _kernels
from .cuda_poa_gap_local import MAX_SLOTS, Plan, plan, stored_rows

KERNEL = "poa_global"
SOURCE = "recgraph_tpu_torch/csrc/poa_global.cu"
REPLACES = "recgraph_tpu/ops/pallas_poa_global2.py:477"


def fill_global_cuda(dg, table, seq, L, bta, layout: Plan | None = None):
    """Launch the mode-0 fill for a read batch on the tensors' GPU
    (``layout``: a :class:`~cuda_poa_gap_local.Plan` to force, else
    ``plan``'s)."""
    return fill_layout(KERNEL, dg, table, seq, L, bta, layout, v1=False)


def fill_layout(kernel, dg, table, seq, L, bta, layout: Plan | None, v1: bool):
    """Launch K1 (``v1`` false: packed [B, n, Lp]) or its v1-layout form
    K14 (packed [n, B, Lp + 8], each row's band in lanes Lp and Lp + 1)
    through the C entry of ``kernel``; the six outputs of
    :func:`fill_global_cuda` in that layout."""
    dev = seq.device
    B, Lp = seq.shape
    n = dg.n
    pidx, cand, _ = _kernels.check_inputs(kernel, dg, table, seq, L, bta)
    if dg.max_preds > MAX_SLOTS:
        raise ValueError(f"{kernel}: {dg.max_preds} predecessor slots, at most {MAX_SLOTS}")
    pl = layout or plan(B, Lp, torch.cuda.get_device_properties(dev).multi_processor_count)
    store_at, srow, S = stored_rows(dg, pl.full, every_row=True)
    _kernels.check_tensors(kernel, dev, store_at=store_at, srow=srow)
    S += int(pl.full)   # the full form keeps G, the read's gap sums, in one more row
    i32 = dict(dtype=torch.int32, device=dev)
    ms = torch.empty((B, S, Lp), **i32)   # the stored rows' m
    # each row's best column, m at its band start and m at right - 1
    bsp, mfirst, mlast = torch.empty((3, B, n), **i32)
    score, last_row, last_col = (torch.empty(B, **i32) for _ in range(3))
    packed = torch.empty((n, B, Lp + 8) if v1 else (B, n, Lp), **i32)
    lefts, rights = (torch.empty((B, n), **i32) for _ in range(2))
    _kernels.launch(
        kernel, (B, n, Lp, Lp), dev,
        seq, L, bta, table, dg.codes, pidx, dg.min_pred, dg.r_values, cand, srow, store_at,
        int(cand.numel()), B, n, dg.max_preds, Lp, pl.cw, pl.warps, int(pl.full), S, ms, bsp,
        mfirst, mlast, score, last_row, last_col, packed, lefts, rights,
    )
    return score, last_row, last_col, packed, lefts, rights
