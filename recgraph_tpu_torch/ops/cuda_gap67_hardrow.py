"""The modes-6/7 hard-row column program on the GPU on its own: wrapper
of ``csrc/gap67_hardrow.cu``.

Replaces ``recgraph_tpu/ops/pallas_gap67_hardrow.py:175 hard_cols_lc``.
The program itself (``csrc/gap67_hardrow.cuh``) runs inside K11's hard
rows (``cuda_gap67_fill``); the main path never launches this wrapper,
which exists so that the program can be held against its plain version,
``pathwise_gap_engine.hard_cols_plain``, on the same staged inputs.
``hard_cols_cuda`` takes and returns what the plain version does;
``prepare`` lays its arguments out as the kernel reads them (each read's
lane coefficients, ``pathwise_gap_engine.chain_coefs``, on the host, and
its per-lane inputs V and W, ``chain_inputs``, with the columns padded
to a multiple of 4) and ``launch`` runs the kernel on them, so that a
timing can leave the host work out.  ``launch`` counts its launches in
``metrics.LAUNCHES["gap67_hardrow"]`` and shapes (reads, 1, columns + 1,
columns + 1, paths) in ``metrics.SHAPES``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels
from .pathwise_gap_engine import chain_coefs, chain_inputs

KERNEL = "gap67_hardrow"
SOURCE = "recgraph_tpu_torch/csrc/gap67_hardrow.cu"
REPLACES = "recgraph_tpu/ops/pallas_gap67_hardrow.py:175"


def prepare(U, Dc, Dfd_own, Ypre, lc, x0, tb, nd, fire, isa, after, ai, o, e):
    """The kernel's arguments from ``hard_cols_plain``'s (shapes as
    there: U, Dc int32[C, MB, B]; Dfd_own, Ypre int32[C, P, B]; lc
    int32[4, P, B]; x0 int32[P, B]; tb, nd, fire, isa, after int32[MB]):
    each read's lane coefficients, built on the host, and its V, W
    [P, Lp] with column c + 1 holding column c, Lp = C + 1 rounded up to
    a multiple of 4.  Returns the tuple ``launch`` takes."""
    dev = Ypre.device
    C, P, B = Ypre.shape
    MB = U.shape[1]
    _kernels.check_tensors(KERNEL, dev, U=U, Dc=Dc, Dfd_own=Dfd_own, Ypre=Ypre, lc=lc, x0=x0,
                           tb=tb, nd=nd, fire=fire, isa=isa, after=after)
    if U.shape != (C, MB, B) or Dc.shape != U.shape or Dfd_own.shape != Ypre.shape \
            or lc.shape != (4, P, B) or x0.shape != (P, B) \
            or any(t.shape != (MB,) for t in (tb, nd, fire, isa, after)):
        raise ValueError(f"{KERNEL}: inconsistent shapes")
    if not 0 <= int(ai) < P:
        raise ValueError(f"{KERNEL}: row alpha {ai} outside 0..{P - 1}")
    lc_h = lc.cpu().numpy()
    blk = [t.cpu().numpy() for t in (tb, nd, fire, isa, after)]
    slots = np.empty((B, 4, P), dtype=np.int32)
    hub = np.empty((B, 3), dtype=np.int32)
    built: dict = {}                      # reads with the same lane maps share one build
    for b in range(B):
        key = lc_h[:, :, b].tobytes()
        if key not in built:
            built[key] = chain_coefs(*lc_h[:, :, b], *blk, int(ai))
        slots[b], *hub[b] = built[key]
    Lp = (C + 4) // 4 * 4                 # column 0, then the C columns, padded
    i32 = dict(dtype=torch.int32, device=dev)
    V, W = (torch.zeros((B, P, Lp), **i32) for _ in range(2))
    for dst, src in zip((V, W), chain_inputs(U, Dc, Dfd_own, Ypre, lc[0])):
        dst[:, :, 1 : C + 1] = src.permute(2, 1, 0)
    return (V, W, torch.from_numpy(slots).to(dev), torch.from_numpy(hub).to(dev),
            x0.t().contiguous(), C, int(o), int(e))


def launch(V, W, slots, hub, x0, C, o, e):
    """Run the column program on ``prepare``'s arguments: one block per
    read.  Returns xs, ds int32[C, P, B] (views of the outputs)."""
    B, P, Lp = V.shape
    X, D = (torch.empty((B, P, Lp), dtype=torch.int32, device=V.device) for _ in range(2))
    _kernels.launch(KERNEL, (B, 1, C + 1, C + 1, P), V.device, V, W, slots, hub, x0,
                    B, P, Lp, o, e, X, D)
    return X[:, :, 1 : C + 1].permute(2, 1, 0), D[:, :, 1 : C + 1].permute(2, 1, 0)


def hard_cols_cuda(U, Dc, Dfd_own, Ypre, lc, x0, tb, nd, fire, isa, after, ai, o, e):
    """``launch(*prepare(...))``: the column program on
    ``hard_cols_plain``'s arguments, returning what it returns."""
    return launch(*prepare(U, Dc, Dfd_own, Ypre, lc, x0, tb, nd, fire, isa, after, ai, o, e))
