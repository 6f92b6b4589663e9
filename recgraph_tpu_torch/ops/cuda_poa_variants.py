"""The superseded TPU generations of the mode-0/1 fills on the GPU.

Wrappers of K13, K15 and K17, the rows-first form of K2's kernel in
``csrc/poa_local.cu``, of K16, its scores-only form, and of K14, the
v1-layout form of K1's kernel in ``csrc/poa_global.cu``.  Each returns
what its TPU kernel returns, in its layout and element type, written by
the kernel itself:

| Kernel | Replaces | Returns |
| --- | --- | --- |
| K13 ``fill_local_v1_cuda`` | ``pallas_poa.py:217 fill_local`` | (best_val, best_i, best_j, packed int32[n, B, Lp]); K2's layout plan |
| K14 ``fill_global_v1_cuda`` | ``pallas_poa.py:537 fill_global`` | (score, last_row, last_col_abs, packed int32[n, B, Lp + 8]); lanes Lp, Lp + 1: band bounds; K1's layout plan |
| K15 ``fill_local_v2_cuda`` | ``pallas_poa_v2.py:182 fill_local_v2`` | (best_val, best_i, best_j, packed int32 or int16 [8 * ceil(n / 8), B, Lp]); K2's layout plan |
| K16 ``fill_local_scores_cuda`` | ``tools/pallas_poa_v3.py:137 fill_local_scores`` | (best_val, best_i, best_j, m int32[8 * ceil((n - 1) / 8), B, Lp]); no directions; K2's layout plan |
| K17 ``fill_local_v4_cuda`` | ``tools/pallas_poa_v4.py:218 fill_local_v4`` | (best_val, best_i, best_j, packed int32[8 * ceil((n - 1) / 8), B, Lp]); K2's layout plan |

Rows past n-2 are zero (K16, K17: none where (n - 1) % 8 == 0).  Their
plain versions are in ``poa_variants``.
The TPU kernels' gates and knobs are not ported: any predecessor span
(no ``RING``), any batch (no ``B % Bt``), and ``R`` only as it sets the
row padding.  ``metrics.LAUNCHES[<KERNEL>]`` counts each one's launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _kernels, cuda_poa_global, cuda_poa_local

R = 8   # rows per TPU grid step: only the row padding of K15-K17 keeps it


class Kernel(NamedTuple):
    KERNEL: str     # launch counter and C entry name (rgt_<KERNEL>_fill)
    SOURCE: str
    REPLACES: str


LOCAL_V1 = Kernel("poa_local_v1", cuda_poa_local.SOURCE, "recgraph_tpu/ops/pallas_poa.py:217")
GLOBAL_V1 = Kernel("poa_global_v1", cuda_poa_global.SOURCE,
                   "recgraph_tpu/ops/pallas_poa.py:537")
LOCAL_V2 = Kernel("poa_local_v2", cuda_poa_local.SOURCE,
                  "recgraph_tpu/ops/pallas_poa_v2.py:182")
LOCAL_SCORES = Kernel("poa_local_scores", cuda_poa_local.SOURCE, "tools/pallas_poa_v3.py:137")
LOCAL_V4 = Kernel("poa_local_v4", cuda_poa_local.SOURCE, "tools/pallas_poa_v4.py:218")

I16_MAX_ROWS = 2048      # pred * 16 + dir fits int16 below this many rows
I16_MAX_SCORE = 1 << 14  # |scores| the int16 TPU kernel keeps exact


def rows_v2(n: int) -> int:
    """K15's stored rows: R * ceil(n / R) (pallas_poa_v2.py:206-208)."""
    return -(-n // R) * R


def rows_v34(n: int) -> int:
    """K16's and K17's stored rows: R * ceil((n - 1) / R)."""
    return -(-(n - 1) // R) * R


def check_dtype(dtype, n: int, table, Lp: int) -> None:
    """K15's element type is int32 or int16.  Raise where int16 planes
    would not hold the values: n >= 2,048 rows, or the table's largest
    entry times Lp at 16k or more (pallas_poa_v2.py:32-33, 187-190)."""
    if dtype not in (torch.int32, torch.int16):
        raise ValueError(f"fill_local_v2: dtype must be int32 or int16, got {dtype}")
    top = int(table.abs().max())
    if dtype == torch.int16 and (n >= I16_MAX_ROWS or top * Lp >= I16_MAX_SCORE):
        raise ValueError(f"fill_local_v2: int16 planes need n < {I16_MAX_ROWS} and "
                         f"max |table| * Lp < {I16_MAX_SCORE}; got n = {n}, "
                         f"{top} * {Lp} = {top * Lp}")


def i16_store_cells(Lp: int) -> int:
    """The int16 cells K15 writes a store for rows of Lp cells: 8 (16
    bytes) where a row starts 16-byte aligned (Lp % 8 == 0), else 2 (4
    bytes) where Lp is even, else 1."""
    return 8 if Lp % 8 == 0 else 2 if Lp % 2 == 0 else 1


def fill_local_v1_cuda(dg, table, seq, L, layout=None):
    """K13: the mode-1 fill with packed int32[n, B, Lp] (``layout``: a
    ``cuda_poa_gap_local.Plan`` to force, else K2's)."""
    return cuda_poa_local.fill_layout(LOCAL_V1.KERNEL, dg, table, seq, L, layout, rows=dg.n)


def fill_local_v2_cuda(dg, table, seq, L, dtype=torch.int32, layout=None):
    """K15: the mode-1 fill with packed [rows_v2(n), B, Lp] of ``dtype``
    (int32, or int16 where :func:`check_dtype` passes; ``layout`` as K13's)."""
    check_dtype(dtype, dg.n, table, seq.shape[1])
    i16 = i16_store_cells(seq.shape[1]) if dtype == torch.int16 else 0
    return cuda_poa_local.fill_layout(LOCAL_V2.KERNEL, dg, table, seq, L, layout,
                                      rows=rows_v2(dg.n), i16=i16)


def fill_local_scores_cuda(dg, table, seq, L, layout=None):
    """K16: the mode-1 fill's score plane m int32[rows_v34(n), B, Lp]
    with no directions (``layout`` as K13's)."""
    return cuda_poa_local.fill_layout(LOCAL_SCORES.KERNEL, dg, table, seq, L, layout,
                                      rows=rows_v34(dg.n), scores=True)


def fill_local_v4_cuda(dg, table, seq, L, layout=None):
    """K17: the mode-1 fill with packed int32[rows_v34(n), B, Lp]
    (``layout`` as K13's)."""
    return cuda_poa_local.fill_layout(LOCAL_V4.KERNEL, dg, table, seq, L, layout,
                                      rows=rows_v34(dg.n))


def fill_global_v1_cuda(dg, table, seq, L, bta, layout=None):
    """K14: the mode-0 fill with packed int32[n, B, Lp + 8], each row's
    band bounds in lanes Lp and Lp + 1 (``layout``: a
    ``cuda_poa_gap_local.Plan`` to force, else K1's)."""
    return cuda_poa_global.fill_layout(GLOBAL_V1.KERNEL, dg, table, seq, L, bta, layout,
                                       v1=True)[:4]
