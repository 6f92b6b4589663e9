"""Pathwise fill of modes 4/5 on the GPU: wrapper of ``csrc/pathwise.cu``.

Replaces ``recgraph_tpu/ops/pallas_pathwise.py:462 fill_pathwise_v1``
and, at any path count, its path-tiled variant
``recgraph_tpu/ops/pallas_pathwise_bigp.py:409 fill_pathwise_bigp``.
Its plain version is ``pathwise_engine.fill_pathwise_plain``; both
return A int32[B, P, n, Lp] and agree bit for bit.
``metrics.LAUNCHES["pathwise"]`` counts the launches and
``metrics.SHAPES`` records (reads, rows, Lp, Lp, paths).
"""

from __future__ import annotations

import torch

from . import _kernels
from .encode import group_table

KERNEL = "pathwise"
SOURCE = "recgraph_tpu_torch/csrc/pathwise.cu"
REPLACES = "recgraph_tpu/ops/pallas_pathwise.py:462"
REPLACES_BIGP = "recgraph_tpu/ops/pallas_pathwise_bigp.py:409"


def fill_pathwise_cuda(dg, table, seq, semiglobal):
    """Launch the dense pathwise fill on the GPU."""
    dev = seq.device
    B, Lp = seq.shape
    n, P = dg.n, dg.paths_number
    grep, gpred, pslot = group_table(dg)
    Gd = grep.shape[1]
    _kernels.check_tensors(KERNEL, dev, seq=seq, table=table, codes=dg.codes,
                           grep=grep, gpred=gpred, pslot=pslot)
    if table.shape != (7, 7):
        raise ValueError(f"{KERNEL}: bad table shape {tuple(table.shape)}")
    i32 = dict(dtype=torch.int32, device=dev)
    G = torch.empty((B, Lp), **i32)                # gap prefix sums
    kidx = torch.empty((B, Gd, Lp), **i32)         # per group: last non-L column
    flag = torch.empty((B, Gd, Lp), **i32)         # per group: the rep moved D
    A = torch.empty((B, P, n, Lp), **i32)
    _kernels.launch(
        KERNEL, (B, n, Lp, Lp, P), dev,
        seq, table, dg.codes, grep, gpred, pslot, B, n, P, Lp, Gd, int(bool(semiglobal)),
        G, kidx, flag, A,
    )
    return A
