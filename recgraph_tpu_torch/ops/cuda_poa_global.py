"""Mode-0 fill on the GPU: wrapper of the CUDA kernel ``csrc/poa_global.cu``.

Replaces ``recgraph_tpu/ops/pallas_poa_global2.py:477 fill_global_v2``.
Its plain version is ``poa_engine.fill_global_plain``; both return
(score, last_row, last_col_abs, packed int32[B, n, Lp], lefts, rights)
and agree bit for bit, at any read length.
``metrics.LAUNCHES["poa_global"]`` counts the launches.
"""

from __future__ import annotations

import torch

from . import _kernels

KERNEL = "poa_global"
SOURCE = "recgraph_tpu_torch/csrc/poa_global.cu"
REPLACES = "recgraph_tpu/ops/pallas_poa_global2.py:477"


def fill_global_cuda(dg, table, seq, L, bta):
    """Launch the mode-0 fill for a read batch on the tensors' GPU."""
    dev = seq.device
    B, Lp = seq.shape
    n = dg.n
    pidx, cand, _ = _kernels.check_inputs(KERNEL, dg, table, seq, L, bta)
    i32 = dict(dtype=torch.int32, device=dev)
    m = torch.empty((B, n, Lp), **i32)       # score scratch
    bsp = torch.empty((B, n), **i32)         # best column per row
    wss = torch.empty((B, n), **i32)         # window starts (all 0 here)
    score, last_row, last_col = (torch.empty(B, **i32) for _ in range(3))
    packed = torch.empty((B, n, Lp), **i32)
    lefts = torch.empty((B, n), **i32)
    rights = torch.empty((B, n), **i32)
    _kernels.launch(
        KERNEL, (B, n, Lp, Lp), dev,
        seq, L, bta, table, dg.codes, pidx, dg.min_pred, dg.r_values,
        cand, int(cand.numel()), B, n, dg.max_preds, Lp, m, bsp, score, last_row,
        last_col, packed, lefts, rights, wss,
    )
    return score, last_row, last_col, packed, lefts, rights
