"""Delta-form fill of modes 6/7 on the GPU: wrapper of ``csrc/gap67_fill.cu``.

Replaces ``recgraph_tpu/ops/pallas_gap67_fill.py:671 fill_gap67_pallas``
for every graph: no packed-chain, path-count or memory gate.  Its hard
rows run K12's column program (``csrc/gap67_hardrow.cuh``).  Its plain
version is ``pathwise_gap_engine.fill_gap_plain``; both return (Dm, X,
Y) int32[n, B, P, Lp] and agree on every cell.
``metrics.LAUNCHES["gap67_fill"]`` counts the launches,
``metrics.SHAPES`` records (reads, rows, Lp, Lp, paths) and
``metrics.EVENTS["gap67_hard_rows"]`` the (read, hard row) pairs whose
column program ran inside the launches, as the kernel counts them
(reading the count waits for the launch to end).
"""

from __future__ import annotations

import torch

from .. import metrics
from . import _kernels

KERNEL = "gap67_fill"
SOURCE = "recgraph_tpu_torch/csrc/gap67_fill.cu"
REPLACES = "recgraph_tpu/ops/pallas_gap67_fill.py:671"


def fill_gap67_cuda(tabs, table, seq, o, e, semiglobal):
    """Launch the modes-6/7 fill on the GPU; ``tabs`` is the graph's
    ``pathwise_gap_engine.GapTables`` on the same device."""
    dev = seq.device
    B, Lp = seq.shape
    m = tabs.meta
    n, P, MB = m.n, m.P, m.maxb
    _kernels.check_tensors(KERNEL, dev, seq=seq, table=table, rows=tabs.rows,
                           lanemask=tabs.lanemask, blocks=tabs.blocks,
                           blockmask=tabs.blockmask, lanes=tabs.lanes)
    if table.shape != (7, 7):
        raise ValueError(f"{KERNEL}: bad table shape {tuple(table.shape)}")
    i32 = dict(dtype=torch.int32, device=dev)
    # per read: the easy rows' alpha-lane selectors (3 Lp) and the hard
    # rows' staging (U and Dc [MB, Lp], Dfd_own and Ypre [P, Lp])
    scratch = torch.empty((B, (3 + 2 * MB + 2 * P) * Lp), **i32)
    Dm, X, Y = (torch.empty((n, B, P, Lp), **i32) for _ in range(3))
    ran = torch.zeros(1, **i32)
    _kernels.launch(
        KERNEL, (B, n, Lp, Lp, P), dev,
        seq, table, tabs.rows, tabs.lanemask, tabs.blocks, tabs.blockmask, tabs.lanes,
        B, n, P, MB, Lp, int(o), int(e), int(bool(semiglobal)), scratch, Dm, X, Y, ran,
    )
    metrics.EVENTS["gap67_hard_rows"] += int(ran.item())
    return Dm, X, Y
