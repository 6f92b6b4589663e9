"""Reverse pathwise fill of modes 8/9 on the GPU: wrapper of
``csrc/pathwise_rev.cu``.

Replaces ``recgraph_tpu/ops/pallas_pathwise.py:622 fill_pathwise_rev_v1``
and, at any path count, its path-tiled variant
``recgraph_tpu/ops/pallas_pathwise_bigp.py:512 fill_pathwise_rev_bigp``.
Its plain version is ``recombination_engine.fill_pathwise_rev_plain``;
both return W int32[B, P, n, Lp] and agree bit for bit, on the
delta-leak graphs too.  ``metrics.LAUNCHES["pathwise_rev"]`` counts the
launches and ``metrics.SHAPES`` records (reads, rows, Lp, Lp, paths).
The launch is laid out as K7's (``cuda_pathwise.plan``).
"""

from __future__ import annotations

import torch

from . import _kernels
from .cuda_pathwise import group_counts, launch_plan, scratch_tensor
from .encode import group_table

KERNEL = "pathwise_rev"
SOURCE = "recgraph_tpu_torch/csrc/pathwise_rev.cu"
REPLACES = "recgraph_tpu/ops/pallas_pathwise.py:622"
REPLACES_BIGP = "recgraph_tpu/ops/pallas_pathwise_bigp.py:512"


def fill_pathwise_rev_cuda(dgr, table, seq, L, mode8, cluster=None):
    """Launch the reverse pathwise fill on the GPU (``dgr``: the reverse
    graph's encoding, with ``qsrc_of``; ``cluster``: blocks a read, else
    ``cuda_pathwise.plan``'s choice)."""
    dev = seq.device
    B, Lp = seq.shape
    n, P = dgr.n, dgr.paths_number
    if dgr.qsrc_of is None:
        raise ValueError(f"{KERNEL}: needs the reverse graph (encode.rev_device_graph)")
    grep, gpred, pslot = group_table(dgr)
    gcount = group_counts(dgr)
    Gd = grep.shape[1]
    _kernels.check_tensors(KERNEL, dev, seq=seq, L=L, table=table, codes=dgr.codes,
                           grep=grep, gpred=gpred, pslot=pslot, qsrc=dgr.qsrc_of, gcount=gcount)
    if table.shape != (7, 7) or L.shape != (B,):
        raise ValueError(f"{KERNEL}: bad shapes table {tuple(table.shape)}, "
                         f"L {tuple(L.shape)} for B={B}")
    pl = launch_plan("rgt_pathwise_rev_per_sm", dev, B, P, Lp, Gd, cluster)
    scratch = scratch_tensor(pl, B, dev)
    A = torch.empty((B, P, n, Lp), dtype=torch.int32, device=dev)
    _kernels.launch(
        KERNEL, (B, n, Lp, Lp, P), dev,
        seq, L, table, dgr.codes, grep, gpred, pslot, dgr.qsrc_of, gcount, B, n, P, Lp, Gd,
        int(bool(mode8)), pl.cluster, pl.threads, pl.smem, int(pl.smem_form), pl.cw,
        scratch, pl.stride, A,
    )
    return A
