"""Mode-2 fill on the GPU: wrapper of the CUDA kernel ``csrc/poa_gap_global.cu``.

Replaces ``recgraph_tpu/ops/pallas_gap_global.py:415 fill_gap_global_v2``.
Its plain version is ``poa_gap_engine.fill_gap_global_plain``; both
return (score, last_row, last_col_abs, packed, packed_x, packed_y
int32[B, n, Lp], lefts, rights) and agree bit for bit for every sign of
the penalties: the kernel's prefix-max chain where it is exact, its
clamped chain past that (:func:`check_chain_range` picks).
``metrics.LAUNCHES["poa_gap_global"]`` counts the launches.

The launch layout is K5's (``cuda_poa_gap_local.plan``: warps a read,
columns a lane, register or full form; one read a block); the rows kept
in the device scratch are every predecessor of a row other than its row
i-1 (``cuda_poa_gap_local.stored_rows`` with ``every_row``).  K6
(``cuda_poa_gap_global_win``) is the window form of the same kernel.
"""

from __future__ import annotations

import torch

from . import _kernels
from .cuda_poa_gap_local import MAX_SLOTS, Plan, plan, stored_rows

KERNEL = "poa_gap_global"
SOURCE = "recgraph_tpu_torch/csrc/poa_gap_global.cu"
REPLACES = "recgraph_tpu/ops/pallas_gap_global.py:415"
CHAIN_RANGE = 1 << 26     # (|o| + |e|) (2n + 2Lp + 2) below this: the prefix-max chain is exact


def check_chain_range(o: int, e: int, n: int, Lp: int) -> bool:
    """Whether K4's prefix-max chain is exact: True while
    (|o| + |e|) (2n + 2Lp + 2) < 2^26, else the wrapper takes the clamped
    chain.

    Every value of a row is at least the uncovered Y, 2o + e(minp + 1) + ej
    (minp < n, j < Lp), or a predecessor's m + o + e, so it stays above
    -(|o| + |e|) (2n + 2Lp + 2) over n rows, and so do x_left and the
    chain's (j - left) g terms: below 2^26 the reference's 2x2 map scan
    never clamps (its NEG entries stay below every real value) and the
    prefix maximum stays in int32.
    """
    return (abs(int(o)) + abs(int(e))) * (2 * int(n) + 2 * int(Lp) + 2) < CHAIN_RANGE


def fill_gap_global_cuda(dg, table, seq, L, bta, o, e, layout: Plan | None = None):
    """Launch the mode-2 fill for a read batch on the tensors' GPU
    (``layout``: a :class:`~cuda_poa_gap_local.Plan` to force, else
    ``plan``'s)."""
    dev = seq.device
    B, Lp = seq.shape
    n = dg.n
    pidx, cand, _ = _kernels.check_inputs(KERNEL, dg, table, seq, L, bta)
    if dg.max_preds > MAX_SLOTS:
        raise ValueError(f"{KERNEL}: {dg.max_preds} predecessor slots, at most {MAX_SLOTS}")
    pl = layout or plan(B, Lp, torch.cuda.get_device_properties(dev).multi_processor_count)
    store_at, srow, S = stored_rows(dg, pl.full, every_row=True)
    _kernels.check_tensors(KERNEL, dev, store_at=store_at, srow=srow)
    i32 = dict(dtype=torch.int32, device=dev)
    ms, ys = (torch.empty((B, S, Lp), **i32) for _ in range(2))   # the stored rows' m and y
    bsp, mlast = torch.empty((2, B, n), **i32)   # each row's best column and m at right - 1
    score, last_row, last_col = (torch.empty(B, **i32) for _ in range(3))
    packed, packed_x, packed_y = (torch.empty((B, n, Lp), **i32) for _ in range(3))
    lefts, rights = (torch.empty((B, n), **i32) for _ in range(2))
    _kernels.launch(
        KERNEL, (B, n, Lp, Lp), dev,
        seq, L, bta, table, dg.codes, pidx, dg.min_pred, dg.r_values, cand, srow, store_at,
        int(cand.numel()), B, n, dg.max_preds, Lp, int(o), int(e), pl.cw, pl.warps,
        int(pl.full), int(not check_chain_range(o, e, n, Lp)), S, ms, ys, bsp, mlast,
        score, last_row, last_col, packed, packed_x, packed_y, lefts, rights,
    )
    return score, last_row, last_col, packed, packed_x, packed_y, lefts, rights
