"""The modes-8/9 split search on the GPU: wrapper of
``csrc/split_summary.cu`` (the port's own kernel S1), with two entries.

No TPU kernel: S1 replaces the XLA function
``recgraph_tpu/ops/recombination_engine.py:478 _col_summary_fn`` and the
JAX engine's host-driven rounds of it (``:597 _run_split_guided``).

- :func:`col_summary_cuda`, the per-pair entry: one (read, column) pair
  per entry of ``bidx``/``cols``; returns (col_max f32[K], edge_any
  bool[K], flat_edge int64[K], flat_plain int64[K]), bit for bit those of
  its plain version ``recombination_engine.col_summary_plain``.
  ``metrics.LAUNCHES["split_summary"]`` counts its launches and
  ``metrics.SHAPES`` records (reads, rows, Lp, pairs, the graph's paths).
- :func:`split_guided_cuda`, the guided entry: a chunk's whole
  bound-guided search in one launch; returns int32[7, B], the rows
  (best f32 bits, taken, fen, rsn, fp, rp, col) that its plain version
  ``recombination_engine._run_split_guided`` returns, bit for bit.
  ``metrics.LAUNCHES["split_guided"]`` counts its launches,
  ``metrics.SHAPES`` records (reads, rows, Lp, blocks a read, paths),
  and the pairs it evaluated go to the device counter ``split_pairs``.

- :func:`column_ub_cuda`, the bound entry: the search's column bound
  ub f32[B, Lp], bit for bit ``recombination_engine._column_ub``;
  ``metrics.LAUNCHES["split_bound"]`` counts its launches and
  ``metrics.SHAPES`` records (reads, rows, Lp, Lp, paths).

They take the summaries of ``split_inputs`` (and the
``_SplitGeometry.tensors`` dict) on one CUDA device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import metrics
from . import _kernels

KERNEL = "split_summary"
GUIDED = "split_guided"
BOUND = "split_bound"
SOURCE = "recgraph_tpu_torch/csrc/split_summary.cu"
REPLACES = "recgraph_tpu/ops/recombination_engine.py:478 (XLA, no TPU kernel)"
REPLACES_GUIDED = ("recgraph_tpu/ops/recombination_engine.py:597 (host rounds of XLA, "
                   "no TPU kernel)")
REPLACES_BOUND = "recgraph_tpu/ops/recombination_engine.py:356 (XLA, no TPU kernel)"
WINDOW = 512                # rows a block stages at once (S1_WINDOW)
ROW_BYTES = 24              # one compacted row in shared memory
SMEM_MAX = 226 * 1024       # dynamic shared memory a block may take
FWD_TILE = 1024             # compacted forward rows a block holds
REV_TILE = 2048             # compacted reverse rows a block holds (at most)
WAVES = 32                  # blocks a read: this many times the card's share
MAX_BLOCKS = 64             # the most blocks a read


def f32_key(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving int32 key of f32 values: a < b as
    floats iff key(a) < key(b) as ints (-0.0 below +0.0); its own
    inverse on the bits."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(i >= 0, i, i ^ 0x7FFFFFFF)


KEY_NEG_INF = int(f32_key(torch.tensor([-math.inf]))[0])   # M_b before any column


def edge_key(edge0: int, I: int) -> int:
    """The kernel's pair key (i << 32) | k of the flat index
    ``edge0`` = i * I + k (-1 stays -1): pairs compare in 64 bits, so
    any number of interior rows works."""
    return -1 if edge0 < 0 else (edge0 // I) << 32 | (edge0 % I)


def tiles(I: int, rtile: int | None = None) -> tuple[int, int]:
    """(capf, capr): the compacted rows a block holds of each side.  A
    side's valid rows come in tiles of up to that many; the reverse
    side's tile (``rtile``, default every interior row up to
    ``REV_TILE``) is staged once per pair when it holds all of them,
    else again for each forward tile."""
    capr = rtile or min(REV_TILE, -(-I // 32) * 32)
    return FWD_TILE, max(WINDOW, min(capr, SMEM_MAX // ROW_BYTES - FWD_TILE))


def blocks_per_read(B: int, sms: int, per_sm: int) -> int:
    """Blocks a read: ``WAVES`` times the card's share of the chunk's
    reads (``per_sm`` blocks an SM, from the occupancy API), at most
    ``MAX_BLOCKS``.  A read's columns wait on each other only through
    M_b, so more blocks evaluate its next columns at once."""
    return max(1, min(MAX_BLOCKS, -(-WAVES * sms * max(per_sm, 1) // B)))


_per_sm_cache: dict = {}


def _per_sm(dev, capf: int, capr: int) -> int:
    key = (dev.index, capf, capr)
    if key not in _per_sm_cache:
        with torch.cuda.device(dev):
            v = _kernels.load().rgt_split_guided_per_sm(capf, capr)
        _kernels.check(-v if v < 0 else 0, GUIDED)
        _per_sm_cache[key] = v
    return _per_sm_cache[key]


def launch_blocks(dev, B: int, I: int, rtile: int | None = None) -> int:
    """The blocks a read :func:`split_guided_cuda` gives a chunk of B
    reads of I interior rows on ``dev``."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return blocks_per_read(B, sms, _per_sm(dev, *tiles(I, rtile)))


def masked_ub(ub: torch.Tensor, active: torch.Tensor, R) -> torch.Tensor:
    """ub - R f32[B, Lp] (in f32, as the plain search computes it), -inf
    where the column is inactive, column 0 and columns >= Lp - 1."""
    Lp = ub.shape[1]
    j = torch.arange(Lp, device=ub.device)
    keep = active & (j >= 1) & (j < Lp - 1)
    u = ub - torch.tensor(np.float32(R), device=ub.device)
    return torch.where(keep, u, torch.tensor(-math.inf, device=ub.device))


def column_order(u: torch.Tensor):
    """Each read's columns in falling ``u``, ties to the lower column:
    (ubs f32[B, Lp], order int32[B, Lp], ncand int32[B]), ncand the
    columns above -inf, which come first."""
    ubs, order = torch.sort(u, dim=1, descending=True, stable=True)
    ncand = (ubs > -math.inf).sum(1, dtype=torch.int32)
    return ubs.contiguous(), order.to(torch.int32).contiguous(), ncand


def _check(fmax, farg, vf, rmax, rarg, vr, geom, **more):
    dev = fmax.device
    if dev.type != "cuda":
        raise ValueError(f"{KERNEL}: needs CUDA tensors, got {dev}")
    B, I, Lp = fmax.shape
    if not 1 <= I < 1 << 31:
        raise ValueError(f"{KERNEL}: {I} interior rows")
    want = dict(fmax=(fmax, torch.int32), farg=(farg, torch.int32), vf=(vf, torch.bool),
                rmax=(rmax, torch.int32), rarg=(rarg, torch.int32), vr=(vr, torch.bool),
                dfs=(geom["dfs"], torch.float32), dfe=(geom["dfe"], torch.float32),
                ids=(geom["ids"], torch.int32), fwe=(geom["fwe"], torch.bool),
                rve=(geom["rve"], torch.bool), **more)
    for name, (t, dtype) in want.items():
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{KERNEL}: {name} must be a contiguous {dtype} tensor on {dev}, "
                             f"got {t.dtype} on {t.device}")
    for t in (farg, vf, rmax, rarg, vr):
        if t.shape != (B, I, Lp):
            raise ValueError(f"{KERNEL}: summaries of shape {tuple(t.shape)} != {(B, I, Lp)}")
    if geom["dfs"].shape != (I,):
        raise ValueError(f"{KERNEL}: geometry of {tuple(geom['dfs'].shape)} rows != {I}")
    return dev, B, I, Lp


def column_ub_cuda(fmax, vf, rmax, vr, wf, wr, paths):
    """ub f32[B, Lp]: ``_column_ub`` of the summaries with the sign
    weights wf/wr f32[4, I] (R folded in by the caller); ``paths`` (the
    graph's path count) goes with the launch shape."""
    dev = fmax.device
    B, I, Lp = fmax.shape
    if dev.type != "cuda":
        raise ValueError(f"{BOUND}: needs CUDA tensors, got {dev}")
    want = dict(fmax=(fmax, torch.int32), vf=(vf, torch.bool), rmax=(rmax, torch.int32),
                vr=(vr, torch.bool), wf=(wf, torch.float32), wr=(wr, torch.float32))
    for name, (t, dtype) in want.items():
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{BOUND}: {name} must be a contiguous {dtype} tensor on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if any(t.shape != (B, I, Lp) for t in (vf, rmax, vr)) or any(
            t.shape != (4, I) for t in (wf, wr)):
        raise ValueError(f"{BOUND}: bad shapes for summaries of {(B, I, Lp)}")
    ub = torch.empty((B, Lp), dtype=torch.float32, device=dev)
    _kernels.launch(BOUND, (B, I + 2, Lp, Lp, paths), dev, fmax, vf, rmax, vr, wf, wr, B, I,
                    Lp, ub)
    return ub


def col_summary_cuda(fmax, farg, vf, rmax, rarg, vr, geom, R, r, bidx, cols):
    """Launch one block per (read, column) pair.  ``geom``: the
    ``_SplitGeometry.tensors`` dict on the same device."""
    dev, B, I, Lp = _check(fmax, farg, vf, rmax, rarg, vr, geom,
                           bidx=(bidx, torch.int32), cols=(cols, torch.int32))
    K = bidx.shape[0]
    if cols.shape != (K,):
        raise ValueError(f"{KERNEL}: bad pair shapes {tuple(bidx.shape)}, {tuple(cols.shape)}")
    capf, capr = tiles(I)
    col_max = torch.empty(K, dtype=torch.float32, device=dev)
    edge_any = torch.empty(K, dtype=torch.int32, device=dev)
    flat_edge, flat_plain = (torch.empty(K, dtype=torch.int64, device=dev) for _ in range(2))
    _kernels.launch(
        KERNEL, (B, I + 2, Lp, K, geom["paths"]), dev,
        fmax, farg, vf, rmax, rarg, vr, geom["dfs"], geom["dfe"], geom["ids"], geom["fwe"],
        geom["rve"], float(R), float(r), bidx, cols, K, I, Lp, edge_key(geom["edge0"], I),
        capf, capr, col_max, edge_any, flat_edge, flat_plain,
    )
    return col_max, edge_any.bool(), flat_edge, flat_plain


def split_guided_cuda(inputs, geom, ub, active, init_best, R, r, blocks=None, rtile=None,
                      with_state=False):
    """The bound-guided search of a chunk in one launch.

    ``inputs``: the six summaries of ``split_inputs``; ``ub`` f32[B, Lp]
    of ``_column_ub`` (:func:`column_ub_cuda`; R not yet taken off);
    ``active`` bool[B, Lp];
    ``init_best`` f32[B]; all on one CUDA device.  ``blocks``: blocks a
    read (default: :func:`blocks_per_read`); ``rtile``: reverse rows
    staged at once (default: :func:`tiles`).  Returns int32[7, B]: best
    (f32 bits), taken, fen, rsn, fp, rp, col; with ``with_state`` also a
    dict of the masked ub, the evaluated columns (bool[B, Lp]) and their
    col_max (f32[B, Lp], only where evaluated), for the invariant check.
    """
    fmax = inputs[0]
    dev, B, I, Lp = _check(*inputs, geom, ub=(ub, torch.float32),
                           active=(active, torch.bool), init_best=(init_best, torch.float32))
    if ub.shape != (B, Lp) or active.shape != (B, Lp) or init_best.shape != (B,):
        raise ValueError(f"{GUIDED}: ub {tuple(ub.shape)}, active {tuple(active.shape)}, "
                         f"init_best {tuple(init_best.shape)} for B={B}, Lp={Lp}")
    u = masked_ub(ub, active, R)
    ubs, order, ncand = column_order(u)
    capf, capr = tiles(I, rtile)
    if blocks is None:
        blocks = launch_blocks(dev, B, I, rtile)
    work = torch.zeros(3 * B + 3 * B * Lp, dtype=torch.int32, device=dev)
    work[2 * B : 3 * B] = KEY_NEG_INF
    state, cols = work[: 3 * B], work[3 * B :]
    flats = torch.zeros(2 * B * Lp, dtype=torch.int64, device=dev)   # pair keys fe, fp
    out = torch.empty((7, B), dtype=torch.int32, device=fmax.device)
    _kernels.launch(
        GUIDED, (B, I + 2, Lp, blocks, geom["paths"]), dev,
        *inputs, geom["dfs"], geom["dfe"], geom["ids"], geom["fwe"], geom["rve"], float(R),
        float(r), ubs, order, ncand, init_best, B, I, Lp, edge_key(geom["edge0"], I), blocks,
        capf, capr, state, cols, flats, out, metrics.device_counter("split_pairs", dev),
    )
    if not with_state:
        return out
    per_col = cols.view(3, B, Lp)
    return out, dict(ub=u, done=per_col[2] != 0,
                     col_max=per_col[0].contiguous().view(torch.float32))
