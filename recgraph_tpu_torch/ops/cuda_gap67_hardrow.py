"""The modes-6/7 hard-row column program on the GPU on its own: wrapper
of ``csrc/gap67_hardrow.cu``.

Replaces ``recgraph_tpu/ops/pallas_gap67_hardrow.py:175 hard_cols_lc``.
The program itself (``csrc/gap67_hardrow.cuh``) runs inside K11's hard
rows (``cuda_gap67_fill``); the main path never launches this wrapper,
which exists so that the program can be held against its plain version,
``pathwise_gap_engine.hard_cols_plain``, on the same staged inputs.  It
takes and returns what the plain version does and counts its launches
in ``metrics.LAUNCHES["gap67_hardrow"]`` and shapes (reads, 1, columns
+ 1, columns + 1, paths) in ``metrics.SHAPES``.
"""

from __future__ import annotations

import torch

from . import _kernels

KERNEL = "gap67_hardrow"
SOURCE = "recgraph_tpu_torch/csrc/gap67_hardrow.cu"
REPLACES = "recgraph_tpu/ops/pallas_gap67_hardrow.py:175"


def hard_cols_cuda(U, Dc, Dfd_own, Ypre, lc, x0, tb, nd, fire, isa, after, ai, o, e):
    """Launch the column program: one warp per read.  Shapes as
    ``hard_cols_plain``: U, Dc int32[C, MB, B]; Dfd_own, Ypre
    int32[C, P, B]; lc int32[4, P, B]; x0 int32[P, B]; tb, nd, fire,
    isa, after int32[MB].  Returns xs, ds int32[C, P, B]."""
    dev = Ypre.device
    C, P, B = Ypre.shape
    MB = U.shape[1]
    per_read = lambda t: t.permute(2, 1, 0).contiguous()  # noqa: E731  [C, k, B] -> [B, k, C]
    Ub, Dcb, Dfb, Ypb = (per_read(t) for t in (U, Dc, Dfd_own, Ypre))
    lcb = lc.permute(2, 0, 1).contiguous()               # [B, 4, P]
    x0b = x0.t().contiguous()                            # [B, P]
    blk = torch.stack([tb, nd, fire, isa, after]).contiguous()   # [5, MB]
    _kernels.check_tensors(KERNEL, dev, U=Ub, Dc=Dcb, Dfd_own=Dfb, Ypre=Ypb, lc=lcb, x0=x0b,
                           blk=blk)
    if U.shape != (C, MB, B) or Dc.shape != U.shape or Dfd_own.shape != Ypre.shape \
            or lc.shape != (4, P, B) or x0.shape != (P, B) or blk.shape != (5, MB):
        raise ValueError(f"{KERNEL}: inconsistent shapes")
    if not 0 <= int(ai) < P:
        raise ValueError(f"{KERNEL}: row alpha {ai} outside 0..{P - 1}")
    xs = torch.empty((B, P, C), dtype=torch.int32, device=dev)
    ds = torch.empty_like(xs)
    _kernels.launch(KERNEL, (B, 1, C + 1, C + 1, P), dev, Ub, Dcb, Dfb, Ypb, lcb, x0b, blk,
                    B, MB, P, C, int(ai), int(o), int(e), xs, ds)
    return xs.permute(2, 1, 0), ds.permute(2, 1, 0)
