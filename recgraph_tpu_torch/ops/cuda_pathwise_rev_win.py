"""Windowed mode-8 reverse fill on the GPU (S2): wrapper of the reverse
form of K10's kernel in ``csrc/pathwise_win.cu``.

The port's own kernel: the JAX package computes this fill with XLA
(``recgraph_tpu/ops/recombination_window.py:67 _fill_pathwise_rev_win``),
not with a Pallas kernel.  Its plain version is
``recombination_window.fill_pathwise_rev_win_plain``; both return (Awr
int32[B, P, n, W], wsr int32[B, n], Rr int32[B]) and agree bit for bit,
on the delta-leak reverse graphs too.  ``metrics.LAUNCHES["pathwise_rev_win"]``
counts the launches and ``metrics.SHAPES`` records (reads, rows, Lp, W,
paths).  The launch is laid out as K10's (``cuda_pathwise_win.plan``,
one block a read), with S2's wider row tables.
"""

from __future__ import annotations

import torch

from . import _kernels, cuda_pathwise_win
from .encode import group_table

KERNEL = "pathwise_rev_win"
SOURCE = "recgraph_tpu_torch/csrc/pathwise_win.cu"
REPLACES = "recgraph_tpu/ops/recombination_window.py:67 (XLA, no TPU kernel)"


def meta_bytes(Gd: int, P: int) -> int:
    """The row tables a block stages one row ahead, twice: the node code
    with the row's group count, the Gd groups' reps and successor rows,
    and each lane's group, source plane and successor row for the window
    placement, padded to 4 ints."""
    return 2 * 4 * ((1 + 2 * Gd + 3 * P + 3) // 4 * 4)


def row_tables(dgr):
    """int32[n, 1 + 2 Gd + 3 P], each row's tables as S2 loads them: K10's
    (``cuda_pathwise_win.row_tables``) then ``qsrc_of`` and each lane's
    successor row where it is on the node (0 for a constant-0 lane, whose
    row the JAX engine reads as row 0), -1 off it; cached on the graph."""
    def build():
        lpred = torch.where(dgr.paths_on, dgr.pred_of.clamp(min=0), -1)
        return torch.cat([cuda_pathwise_win.row_tables(dgr), dgr.qsrc_of, lpred],
                         1).to(torch.int32).contiguous()

    return dgr.cached("_rev_win_row_tables", build)


def fill_pathwise_rev_win_cuda(dgr, table, seq, L, W):
    """Launch the windowed reverse fill (W columns per row) on the GPU
    (``dgr``: the reverse graph's encoding, with ``qsrc_of``)."""
    dev = seq.device
    B, Lp = seq.shape
    n, P = dgr.n, dgr.paths_number
    if dgr.qsrc_of is None:
        raise ValueError(f"{KERNEL}: needs the reverse graph (encode.rev_device_graph)")
    Gd = group_table(dgr)[0].shape[1]
    meta = row_tables(dgr)
    _kernels.check_tensors(KERNEL, dev, seq=seq, L=L, table=table, meta=meta)
    if table.shape != (7, 7) or L.shape != (B,):
        raise ValueError(f"{KERNEL}: bad shapes table {tuple(table.shape)}, "
                         f"L {tuple(L.shape)} for B={B}")
    if not 8 <= W <= Lp:
        raise ValueError(f"{KERNEL}: window width {W} outside [8, {Lp}]")
    W = int(W)
    pl = cuda_pathwise_win.launch_plan(dev, B, P, n, Lp, W, Gd, "rgt_pathwise_rev_win_per_sm",
                                       meta_bytes(Gd, P))
    scratch = torch.empty(max(16, B * pl.stride), dtype=torch.uint8, device=dev)
    Awr = torch.empty((B, P, n, W), dtype=torch.int32, device=dev)
    wsr = torch.empty((B, n), dtype=torch.int32, device=dev)
    Rr = torch.empty(B, dtype=torch.int32, device=dev)
    _kernels.launch(
        KERNEL, (B, n, Lp, W, P), dev,
        seq, L, table, meta, B, n, P, Lp, Gd, W,
        pl.threads, pl.smem, int(pl.smem_form), scratch, pl.stride, Awr, wsr, Rr,
    )
    return Awr, wsr, Rr
