"""Mode-3 fill on the GPU: wrapper of the CUDA kernel ``csrc/poa_gap_local.cu``.

Replaces ``recgraph_tpu/ops/pallas_gap_local.py:271 fill_gap_local_v2``.
Its plain version is ``poa_gap_engine.fill_gap_local_plain``; both
return (best_val, best_i, best_j, packed, packed_x, packed_y
int32[B, n, Lp]) and agree bit for bit for every sign of the penalties,
at any read length.  ``metrics.LAUNCHES["poa_gap_local"]`` counts the
launches.
"""

from __future__ import annotations

import torch

from . import _kernels

KERNEL = "poa_gap_local"
SOURCE = "recgraph_tpu_torch/csrc/poa_gap_local.cu"
REPLACES = "recgraph_tpu/ops/pallas_gap_local.py:271"


def fill_gap_local_cuda(dg, table, seq, L, o, e):
    """Launch the mode-3 fill for a read batch on the tensors' GPU."""
    dev = seq.device
    B, Lp = seq.shape
    n = dg.n
    pidx, _, node_start = _kernels.check_inputs(KERNEL, dg, table, seq, L)
    i32 = dict(dtype=torch.int32, device=dev)
    m, y = (torch.empty((B, n, Lp), **i32) for _ in range(2))   # m/y scratch
    best_val, best_i, best_j = (torch.empty(B, **i32) for _ in range(3))
    packed, packed_x, packed_y = (torch.empty((B, n, Lp), **i32) for _ in range(3))
    _kernels.launch(
        KERNEL, (B, n, Lp, Lp), dev,
        seq, L, table, dg.codes, node_start, pidx, B, n, dg.max_preds,
        Lp, int(o), int(e), m, y, best_val, best_i, best_j, packed, packed_x, packed_y,
    )
    return best_val, best_i, best_j, packed, packed_x, packed_y
