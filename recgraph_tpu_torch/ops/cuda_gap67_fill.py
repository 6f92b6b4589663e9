"""Delta-form fill of modes 6/7 on the GPU: wrapper of ``csrc/gap67_fill.cu``.

Replaces ``recgraph_tpu/ops/pallas_gap67_fill.py:671 fill_gap67_pallas``
for every graph: no packed-chain, path-count or memory gate.  Its hard
rows run K12's column program (``csrc/gap67_hardrow.cuh``).  Its plain
version is ``pathwise_gap_engine.fill_gap_plain``; both return (Dm, X,
Y) int32[n, B, P, Lp] and agree on every cell.
``metrics.LAUNCHES["gap67_fill"]`` counts the launches,
``metrics.SHAPES`` records (reads, rows, Lp, Lp, paths) and
``metrics.EVENTS["gap67_hard_rows"]`` the (read, hard row) pairs whose
column program ran inside the launches, as the kernel counts them on
the device (``metrics.device_counter``): the launch does not wait for
the kernel; ``metrics.flush_device_counters()`` does, and adds the
count into ``EVENTS``.
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
                           blockmask=tabs.blockmask, lanes=tabs.lanes, chain=tabs.chain)
    if table.shape != (7, 7):
        raise ValueError(f"{KERNEL}: bad table shape {tuple(table.shape)}")
    if Lp % 4:
        raise ValueError(f"{KERNEL}: the read width {Lp} is not a multiple of 4")
    i32 = dict(dtype=torch.int32, device=dev)
    # per read: the hard rows' column-program inputs V and W [P, Lp], y's
    # fixup corrections [MB, Lp] and the easy rows' selectors [Lp] (used
    # when shared memory cannot hold them)
    scratch = torch.empty((B, (2 * P + MB + 1) * Lp), **i32)
    Dm, X, Y = (torch.empty((n, B, P, Lp), **i32) for _ in range(3))
    _kernels.launch(
        KERNEL, (B, n, Lp, Lp, P), dev,
        seq, table, tabs.rows, tabs.lanemask, tabs.blocks, tabs.blockmask, tabs.lanes,
        tabs.chain, B, n, P, MB, Lp, int(o), int(e), int(bool(semiglobal)), scratch, Dm, X, Y,
        metrics.device_counter("gap67_hard_rows", dev),
    )
    return Dm, X, Y
