"""Mode-1 fill on the GPU: wrapper of the CUDA kernel ``csrc/poa_local.cu``
(K2; its rows-first forms K13, K15 and K17 and its scores-only form K16
are ``cuda_poa_variants.fill_local_v1_cuda``, ``fill_local_v2_cuda``,
``fill_local_v4_cuda`` and ``fill_local_scores_cuda``).

Replaces ``recgraph_tpu/ops/pallas_poa_v5.py:251 fill_local_v5``.  Its
plain version is ``poa_engine.fill_local_plain``; both return
(best_val, best_i, best_j, packed int32[B, n, Lp]) and agree bit for
bit, at any read length.  ``metrics.LAUNCHES["poa_local"]`` counts the
launches.

The launch layout and the rows kept in the device scratch are K5's
(``cuda_poa_gap_local.plan`` and ``stored_rows``): warps a read, columns
a lane, register or full form, one read a block; the far predecessors
of start rows.
"""

from __future__ import annotations

import torch

from . import _kernels
from .cuda_poa_gap_local import MAX_SLOTS, Plan, plan, stored_rows

KERNEL = "poa_local"
SOURCE = "recgraph_tpu_torch/csrc/poa_local.cu"
REPLACES = "recgraph_tpu/ops/pallas_poa_v5.py:251"


def fill_local_cuda(dg, table, seq, L, layout: Plan | None = None):
    """Launch the mode-1 fill for a read batch on the tensors' GPU
    (``layout``: a :class:`~cuda_poa_gap_local.Plan` to force, else
    ``plan``'s)."""
    return fill_layout(KERNEL, dg, table, seq, L, layout)


def fill_layout(kernel, dg, table, seq, L, layout: Plan | None = None, rows: int | None = None,
                i16: int | None = None, scores: bool = False):
    """Launch K2 (``rows`` None: packed int32[B, n, Lp]) or a rows-first
    form through the C entry of ``kernel``: [rows, B, Lp] with rows n-1 ..
    rows-1 zero, K13, K16 (the score plane m in place of packed) and K17
    (``i16`` None), or K15 (``i16`` 0: int32, else int16 with that many
    cells a store, :func:`~cuda_poa_variants.i16_store_cells`).  The four
    outputs of :func:`fill_local_cuda` in that layout.  ``scores`` (K16):
    every row is read back from the output, so the scratch holds only the
    full form's G row."""
    dev = seq.device
    B, Lp = seq.shape
    n = dg.n
    pidx, _, node_start = _kernels.check_inputs(kernel, dg, table, seq, L)
    if dg.max_preds > MAX_SLOTS:
        raise ValueError(f"{kernel}: {dg.max_preds} predecessor slots, at most {MAX_SLOTS}")
    pl = layout or plan(B, Lp, torch.cuda.get_device_properties(dev).multi_processor_count)
    store_at, srow, S = stored_rows(dg, pl.full)
    _kernels.check_tensors(kernel, dev, store_at=store_at, srow=srow)
    # the full form keeps G, the read's gap sums, in one more row
    S = 1 if scores else S + int(pl.full)
    i32 = dict(dtype=torch.int32, device=dev)
    ms = torch.empty((B, S, Lp), **i32)   # the stored rows' m
    best_val, best_i, best_j = (torch.empty(B, **i32) for _ in range(3))
    if rows is None:
        packed, form = torch.empty((B, n, Lp), **i32), ()
    else:
        dtype = torch.int16 if i16 else torch.int32
        packed = torch.empty((rows, B, Lp), dtype=dtype, device=dev)
        form = (rows,) if i16 is None else (rows, i16)
    _kernels.launch(
        kernel, (B, n, Lp, Lp), dev,
        seq, L, table, dg.codes, node_start, pidx, srow, store_at, B, n, dg.max_preds, Lp,
        *form, pl.cw, pl.warps, int(pl.full), S, ms, best_val, best_i, best_j, packed,
    )
    return best_val, best_i, best_j, packed
