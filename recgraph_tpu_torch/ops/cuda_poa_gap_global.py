"""Mode-2 fill on the GPU: wrapper of the CUDA kernel ``csrc/poa_gap_global.cu``.

Replaces ``recgraph_tpu/ops/pallas_gap_global.py:415 fill_gap_global_v2``.
Its plain version is ``poa_gap_engine.fill_gap_global_plain``; both
return (score, last_row, last_col_abs, packed, packed_x, packed_y
int32[B, n, Lp], lefts, rights) and agree bit for bit for every sign of
the penalties.  ``metrics.LAUNCHES["poa_gap_global"]`` counts the launches.
"""

from __future__ import annotations

import torch

from . import _kernels

KERNEL = "poa_gap_global"
SOURCE = "recgraph_tpu_torch/csrc/poa_gap_global.cu"
REPLACES = "recgraph_tpu/ops/pallas_gap_global.py:415"


def fill_gap_global_cuda(dg, table, seq, L, bta, o, e):
    """Launch the mode-2 fill for a read batch on the tensors' GPU."""
    dev = seq.device
    B, Lp = seq.shape
    n = dg.n
    pidx, cand, _ = _kernels.check_inputs(KERNEL, dg, table, seq, L, bta)
    i32 = dict(dtype=torch.int32, device=dev)
    m, y = (torch.empty((B, n, Lp), **i32) for _ in range(2))   # m/y scratch
    bsp, wss = (torch.empty((B, n), **i32) for _ in range(2))
    score, last_row, last_col = (torch.empty(B, **i32) for _ in range(3))
    packed, packed_x, packed_y = (torch.empty((B, n, Lp), **i32) for _ in range(3))
    lefts, rights = (torch.empty((B, n), **i32) for _ in range(2))
    _kernels.launch(
        KERNEL, (B, n, Lp, Lp), dev,
        seq, L, bta, table, dg.codes, pidx, dg.min_pred, dg.r_values,
        cand, int(cand.numel()), B, n, dg.max_preds, Lp, int(o), int(e), m, y, bsp,
        score, last_row, last_col, packed, packed_x, packed_y, lefts, rights, wss,
    )
    return score, last_row, last_col, packed, packed_x, packed_y, lefts, rights
