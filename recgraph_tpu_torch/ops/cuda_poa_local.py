"""Mode-1 fill on the GPU: wrapper of the CUDA kernel ``csrc/poa_local.cu``.

Replaces ``recgraph_tpu/ops/pallas_poa_v5.py:251 fill_local_v5``.  Its
plain version is ``poa_engine.fill_local_plain``; both return
(best_val, best_i, best_j, packed int32[B, n, Lp]) and agree bit for
bit, at any read length.  ``metrics.LAUNCHES["poa_local"]`` counts the
launches.
"""

from __future__ import annotations

import torch

from . import _kernels

KERNEL = "poa_local"
SOURCE = "recgraph_tpu_torch/csrc/poa_local.cu"
REPLACES = "recgraph_tpu/ops/pallas_poa_v5.py:251"


def fill_local_cuda(dg, table, seq, L):
    """Launch the mode-1 fill for a read batch on the tensors' GPU."""
    dev = seq.device
    B, Lp = seq.shape
    n = dg.n
    pidx, _, node_start = _kernels.check_inputs(KERNEL, dg, table, seq, L)
    i32 = dict(dtype=torch.int32, device=dev)
    m = torch.empty((B, n, Lp), **i32)       # score scratch
    best_val, best_i, best_j = (torch.empty(B, **i32) for _ in range(3))
    packed = torch.empty((B, n, Lp), **i32)
    _kernels.launch(
        KERNEL, (B, n, Lp, Lp), dev,
        seq, L, table, dg.codes, node_start, pidx, B, n, dg.max_preds,
        Lp, m, best_val, best_i, best_j, packed,
    )
    return best_val, best_i, best_j, packed
