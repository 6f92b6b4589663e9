"""The superseded TPU generations of the mode-0/1 fills, in their layouts.

Counterparts, by name, of the JAX package's earlier fill kernels, which
only its kernel A/B tool (``tools/bench_kernel_ab.py``) and its tests
reach:

- ``fill_local_v1``     ``recgraph_tpu/ops/pallas_poa.py:217 fill_local`` (K13)
- ``fill_global_v1``    ``recgraph_tpu/ops/pallas_poa.py:537 fill_global`` (K14)
- ``fill_local_v2``     ``recgraph_tpu/ops/pallas_poa_v2.py:182 fill_local_v2`` (K15)
- ``fill_local_scores`` ``tools/pallas_poa_v3.py:137 fill_local_scores`` (K16)
- ``fill_local_v4``     ``tools/pallas_poa_v4.py:218 fill_local_v4`` (K17)

Each takes the port's ``PoaDeviceGraph``, table, seq and L (and bta) and
returns its JAX function's outputs in their shapes and dtypes.  K13, K15
and K17 compute ``poa_engine.fill_local_plain``'s function and K14
``fill_global_plain``'s; K16 is the local fill's score plane without
directions.  A CUDA tensor launches the kernel (``cuda_poa_variants``),
a CPU tensor runs the plain version here: the plain fill plus the layout
step (``*_layout``), which takes the plain fill's outputs so that a
caller holding them lays out every variant from one fill.
"""

from __future__ import annotations

import torch

from . import cuda_poa_variants as cv
from .poa_engine import fill_global_plain, fill_local_plain_planes

_I32 = torch.int32


def _rows_first(plane, n_store):
    """[B, n, Lp] -> [n_store, B, Lp]: rows past the plane's zero-padded
    or cut, as the TPU kernels store them."""
    B, n, Lp = plane.shape
    out = torch.zeros((n_store, B, Lp), dtype=plane.dtype, device=plane.device)
    k = min(n, n_store)
    out[:k] = plane[:, :k].transpose(0, 1)
    return out


# --- layouts of the plain fills' outputs ----------------------------------


def local_v1_layout(planes):
    """K13's outputs from ``fill_local_plain_planes``'s."""
    bv, bi, bj, packed, _ = planes
    return bv, bi, bj, _rows_first(packed, packed.shape[1])


def local_v2_layout(planes, dtype=_I32):
    """K15's outputs from ``fill_local_plain_planes``'s, packed cast to
    ``dtype`` (int16 only where ``cuda_poa_variants.check_dtype`` passes)."""
    bv, bi, bj, packed, _ = planes
    return bv, bi, bj, _rows_first(packed, cv.rows_v2(packed.shape[1])).to(dtype)


def local_scores_layout(planes):
    """K16's outputs from ``fill_local_plain_planes``'s."""
    bv, bi, bj, _, m = planes
    return bv, bi, bj, _rows_first(m, cv.rows_v34(m.shape[1]))


def local_v4_layout(planes):
    """K17's outputs from ``fill_local_plain_planes``'s."""
    bv, bi, bj, packed, _ = planes
    return bv, bi, bj, _rows_first(packed, cv.rows_v34(packed.shape[1]))


def global_v1_layout(out):
    """K14's outputs from ``fill_global_plain``'s: packed [n, B, Lp + 8]
    with lefts in lane Lp, rights in lane Lp + 1, the rest of the pad
    lanes zero (row n-1 is all zero: the plain fill leaves its bounds 0)."""
    score, last_row, last_col, packed, lefts, rights = out
    B, n, Lp = packed.shape
    pk = torch.zeros((n, B, Lp + 8), dtype=_I32, device=packed.device)
    pk[:, :, :Lp] = packed.transpose(0, 1)
    pk[:, :, Lp] = lefts.t()
    pk[:, :, Lp + 1] = rights.t()
    return score, last_row, last_col, pk


# --- plain versions --------------------------------------------------------


def fill_local_v1_plain(dg, table, seq, L):
    return local_v1_layout(fill_local_plain_planes(dg, table, seq, L))


def fill_local_v2_plain(dg, table, seq, L, dtype=_I32):
    cv.check_dtype(dtype, dg.n, table, seq.shape[1])
    return local_v2_layout(fill_local_plain_planes(dg, table, seq, L), dtype)


def fill_local_scores_plain(dg, table, seq, L):
    return local_scores_layout(fill_local_plain_planes(dg, table, seq, L))


def fill_local_v4_plain(dg, table, seq, L):
    return local_v4_layout(fill_local_plain_planes(dg, table, seq, L))


def fill_global_v1_plain(dg, table, seq, L, bta):
    return global_v1_layout(fill_global_plain(dg, table, seq, L, bta))


# --- dispatch: the kernel for CUDA tensors, the plain version for CPU ------


def fill_local_v1(dg, table, seq, L):
    """K13: (best_val, best_i, best_j, packed int32[n, B, Lp])."""
    if seq.is_cuda:
        return cv.fill_local_v1_cuda(dg, table, seq, L)
    return fill_local_v1_plain(dg, table, seq, L)


def fill_global_v1(dg, table, seq, L, bta):
    """K14: (score, last_row, last_col_abs, packed int32[n, B, Lp + 8])."""
    if seq.is_cuda:
        return cv.fill_global_v1_cuda(dg, table, seq, L, bta)
    return fill_global_v1_plain(dg, table, seq, L, bta)


def fill_local_v2(dg, table, seq, L, dtype=_I32):
    """K15: (best_val, best_i, best_j, packed [rows_v2(n), B, Lp] of
    ``dtype``, int32 or int16)."""
    if seq.is_cuda:
        return cv.fill_local_v2_cuda(dg, table, seq, L, dtype)
    return fill_local_v2_plain(dg, table, seq, L, dtype)


def fill_local_scores(dg, table, seq, L):
    """K16: (best_val, best_i, best_j, m int32[rows_v34(n), B, Lp]); the
    walk over m is ``traceback_engine.walk_local_scores``."""
    if seq.is_cuda:
        return cv.fill_local_scores_cuda(dg, table, seq, L)
    return fill_local_scores_plain(dg, table, seq, L)


def fill_local_v4(dg, table, seq, L):
    """K17: (best_val, best_i, best_j, packed int32[rows_v34(n), B, Lp])."""
    if seq.is_cuda:
        return cv.fill_local_v4_cuda(dg, table, seq, L)
    return fill_local_v4_plain(dg, table, seq, L)
