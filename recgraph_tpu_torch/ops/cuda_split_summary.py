"""Column summaries of the modes-8/9 split search on the GPU: wrapper of
``csrc/split_summary.cu`` (the port's own kernel S1).

No TPU kernel: it replaces the XLA function
``recgraph_tpu/ops/recombination_engine.py:478 _col_summary_fn``.  Its
plain version is ``recombination_engine.col_summary_plain``; both take
one (read, column) pair per entry of ``bidx``/``cols`` and return
(col_max f32[K], edge_any bool[K], flat_edge int32[K], flat_plain
int32[K]), equal bit for bit.  ``metrics.LAUNCHES["split_summary"]``
counts the launches and ``metrics.SHAPES`` records (reads, rows, Lp,
pairs, the graph's paths).
"""

from __future__ import annotations

import torch

from . import _kernels

KERNEL = "split_summary"
SOURCE = "recgraph_tpu_torch/csrc/split_summary.cu"
REPLACES = "recgraph_tpu/ops/recombination_engine.py:478 (XLA, no TPU kernel)"
MAX_ROWS = 46340   # flat indices i * I + k stay in int32


def col_summary_cuda(fmax, farg, vf, rmax, rarg, vr, geom, R, r, bidx, cols):
    """Launch one block per (read, column) pair.  ``geom``: the
    ``_SplitGeometry.tensors`` dict on the same device."""
    dev = fmax.device
    B, I, Lp = fmax.shape
    K = bidx.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"{KERNEL}: needs CUDA tensors, got {dev}")
    if not 1 <= I <= MAX_ROWS:
        raise ValueError(f"{KERNEL}: {I} interior rows (flat indices need I <= {MAX_ROWS})")
    want = dict(fmax=(fmax, torch.int32), farg=(farg, torch.int32), vf=(vf, torch.bool),
                rmax=(rmax, torch.int32), rarg=(rarg, torch.int32), vr=(vr, torch.bool),
                dfs=(geom["dfs"], torch.float32), dfe=(geom["dfe"], torch.float32),
                ids=(geom["ids"], torch.int32), fwe=(geom["fwe"], torch.bool),
                rve=(geom["rve"], torch.bool), bidx=(bidx, torch.int32),
                cols=(cols, torch.int32))
    for name, (t, dtype) in want.items():
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{KERNEL}: {name} must be a contiguous {dtype} tensor on {dev}, "
                             f"got {t.dtype} on {t.device}")
    for t in (farg, vf, rmax, rarg, vr):
        if t.shape != (B, I, Lp):
            raise ValueError(f"{KERNEL}: summaries of shape {tuple(t.shape)} != {(B, I, Lp)}")
    if cols.shape != (K,) or geom["dfs"].shape != (I,):
        raise ValueError(f"{KERNEL}: bad pair or geometry shapes")
    col_max = torch.empty(K, dtype=torch.float32, device=dev)
    edge_any, flat_edge, flat_plain = (torch.empty(K, dtype=torch.int32, device=dev)
                                       for _ in range(3))
    _kernels.launch(
        KERNEL, (B, I + 2, Lp, K, geom["paths"]), dev,
        fmax, farg, vf, rmax, rarg, vr, geom["dfs"], geom["dfe"], geom["ids"], geom["fwe"],
        geom["rve"], float(R), float(r), bidx, cols, K, I, Lp, geom["edge0"],
        col_max, edge_any, flat_edge, flat_plain,
    )
    return col_max, edge_any.bool(), flat_edge, flat_plain
