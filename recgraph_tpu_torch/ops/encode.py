"""Host->device graph and read encodings.

Counterpart of ``recgraph_tpu/ops/encode.py:25-131`` (``PoaDeviceGraph``,
``_build_poa_device_graph``), ``:134-185`` (``PathDeviceGraph``),
``recombination_engine.py:57-78`` (``rev_device_graph``) and ``:187-226``
(``encode_reads``, ``encode_read_aux``).  Tensors live on an explicit device; the mesh
placement of ``encode.py:57-88`` belongs to the multi-GPU slice.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from .. import scoring
from ..graph.pathgraph import PathGraph, pathwise_meta, pathwise_meta_rev
from ..graph.poagraph import PoaGraph

_TENSOR_FIELDS = (
    "codes", "node_start", "pred_idx", "pred_mask", "min_pred", "r_values",
    "erank", "pred_rank",
)
_BOOL_FIELDS = ("node_start", "pred_mask")


@dataclass(frozen=True, eq=False)
class PoaDeviceGraph:
    """Dense arrays for the POA fills (modes 0-3), as torch tensors."""

    codes: torch.Tensor       # int32[n]   lnz base codes
    node_start: torch.Tensor  # bool[n]
    pred_idx: torch.Tensor    # int32[n, Pm]  predecessor end positions, -1 pad
    pred_mask: torch.Tensor   # bool[n, Pm]
    min_pred: torch.Tensor    # int32[n]   fallback predecessor (min pred / i-1)
    r_values: torch.Tensor    # int32[n]   distance-to-sink (utils.rs:103-126)
    erank: torch.Tensor       # int32[n]   rank among node-end rows, -1 elsewhere
    pred_rank: torch.Tensor   # int32[n, Pm]  erank of each predecessor, -1 pad
    sink_rows: tuple[int, ...]  # F's predecessor end positions, ascending
    n: int
    max_preds: int
    compact_span: int

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @classmethod
    def from_numpy(cls, arrays: dict, device="cpu") -> "PoaDeviceGraph":
        """Build from a dict of numpy arrays (the JAX graph's fields as
        ``np.asarray``) plus its ``sink_rows``/``n``/``max_preds``/
        ``compact_span`` entries."""
        kw = {}
        for f in _TENSOR_FIELDS:
            a = np.asarray(arrays[f])
            a = a.astype(bool) if f in _BOOL_FIELDS else a.astype(np.int32)
            kw[f] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return cls(
            sink_rows=tuple(int(p) for p in arrays["sink_rows"]),
            n=int(arrays["n"]),
            max_preds=int(arrays["max_preds"]),
            compact_span=int(arrays["compact_span"]),
            **kw,
        )

    def to_numpy(self) -> dict:
        """Every field: tensors as numpy arrays, the rest as they are."""
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
        return out

    def cached(self, key: str, build):
        """``build()`` once per graph: derived arrays the fills reuse."""
        v = self.__dict__.get(key)
        if v is None:
            v = build()
            object.__setattr__(self, key, v)
        return v

    def host(self) -> dict:
        """Numpy copy of the graph, for host-driven row loops."""
        return self.cached("_host", self.to_numpy)


def build_poa_device_graph(g: PoaGraph, device="cpu") -> PoaDeviceGraph:
    """Port of ``_build_poa_device_graph`` (encode.py:93-131)."""
    idx, mask = g.padded_preds()
    n = g.n
    min_pred = np.zeros(n, dtype=np.int32)
    for i in range(1, n):
        min_pred[i] = g.min_pred(i)

    # node-end rank metadata: predecessors are always node ends
    is_end = np.zeros(n, dtype=bool)
    is_end[0] = True
    for preds in g.preds.values():
        for p in preds:
            is_end[p] = True
    ends_before = np.cumsum(is_end)                # ends at rows <= i
    erank = np.where(is_end, ends_before - 1, -1).astype(np.int32)
    pred_rank = np.where(mask, erank[np.maximum(idx, 0)], -1).astype(np.int32)
    compact_span = 0
    for i, preds in g.preds.items():
        for p in preds:
            if p > 0:
                compact_span = max(
                    compact_span, int(ends_before[i - 1] - 1 - erank[p]) + 1
                )
    return PoaDeviceGraph.from_numpy(
        dict(
            codes=g.codes, node_start=g.node_start, pred_idx=idx,
            pred_mask=mask, min_pred=min_pred, r_values=g.r_values(),
            erank=erank, pred_rank=pred_rank,
            sink_rows=tuple(int(p) for p in g.preds[n - 1]), n=n,
            max_preds=idx.shape[1], compact_span=compact_span,
        ),
        device,
    )


def _per_device(g, device, build, key="_torch_device_graphs"):
    """``build(g, device)``, cached on the graph per device under ``key``."""
    dev = torch.device(device)
    cache = g.__dict__.setdefault(key, {})
    dg = cache.get(str(dev))
    if dg is None:
        dg = cache[str(dev)] = build(g, dev)
    return dg


def poa_device_graph(g: PoaGraph, device="cpu") -> PoaDeviceGraph:
    """The graph's device encoding, cached on the graph per device."""
    return _per_device(g, device, build_poa_device_graph)


_PATH_TENSOR_FIELDS = ("codes", "node_start", "paths_on", "alphas", "rep_of", "pred_of")
_PATH_BOOL_FIELDS = ("node_start", "paths_on")


@dataclass(frozen=True, eq=False)
class PathDeviceGraph:
    """Dense arrays for the pathwise fills (modes 4/5, 8/9), as torch tensors.

    Counterpart of ``recgraph_tpu/ops/encode.py:134-185``.  ``rep_of`` /
    ``pred_of`` materialise the reference's alpha/delta group semantics
    (``graph.pathgraph.pathwise_meta``): at row i every path p moves in
    the direction chosen by its group representative ``rep_of[i, p]``,
    reading from predecessor row ``pred_of[i, p]``.  The reverse graph
    of modes 8/9 (``rev_device_graph``) holds successor rows in
    ``pred_of`` and adds ``qsrc_of``: the plane a path reads its own
    values from (``pathgraph.pathwise_meta_rev``), -1 for a constant 0.
    """

    codes: torch.Tensor       # int32[n]
    node_start: torch.Tensor  # bool[n]
    paths_on: torch.Tensor    # bool[n, P]
    alphas: torch.Tensor      # int32[n]
    rep_of: torch.Tensor      # int32[n, P] (-1 off-path)
    pred_of: torch.Tensor     # int32[n, P] (-1 off-path)
    n: int
    paths_number: int
    qsrc_of: torch.Tensor | None = None  # int32[n, P], reverse graphs only

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @classmethod
    def from_numpy(cls, arrays: dict, device="cpu") -> "PathDeviceGraph":
        """Build from a dict of numpy arrays (the JAX graph's fields as
        ``np.asarray``) plus its ``n`` and ``paths_number``; a
        ``qsrc_of`` entry that is not None is carried across."""
        kw = {}
        for f in _PATH_TENSOR_FIELDS + ("qsrc_of",):
            if arrays.get(f) is None:   # qsrc_of: reverse graphs only
                continue
            a = np.asarray(arrays[f])
            a = a.astype(bool) if f in _PATH_BOOL_FIELDS else a.astype(np.int32)
            kw[f] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return cls(n=int(arrays["n"]), paths_number=int(arrays["paths_number"]), **kw)

    to_numpy = PoaDeviceGraph.to_numpy
    cached = PoaDeviceGraph.cached
    host = PoaDeviceGraph.host


def build_path_device_graph(g: PathGraph, device="cpu") -> PathDeviceGraph:
    """Port of ``_build_path_device_graph`` (encode.py:172-184)."""
    rep_of, pred_of = pathwise_meta(g)
    return PathDeviceGraph.from_numpy(
        dict(codes=g.codes, node_start=g.node_start, paths_on=g.paths_nodes,
             alphas=g.alphas, rep_of=rep_of, pred_of=pred_of, n=g.n,
             paths_number=g.paths_number),
        device,
    )


def path_device_graph(g: PathGraph, device="cpu") -> PathDeviceGraph:
    """The graph's pathwise device encoding, cached on the graph per device."""
    return _per_device(g, device, build_path_device_graph)


def build_rev_device_graph(rg: PathGraph, device="cpu") -> PathDeviceGraph:
    """Port of ``_build_rev_device_graph`` (recombination_engine.py:
    64-78): the reverse graph's arrays with ``pathwise_meta_rev``'s
    successor rows and ``qsrc_of``."""
    rep_of, pred_of, qsrc_of = pathwise_meta_rev(rg)
    return PathDeviceGraph.from_numpy(
        dict(codes=rg.codes, node_start=rg.node_start, paths_on=rg.paths_nodes,
             alphas=rg.alphas, rep_of=rep_of, pred_of=pred_of, qsrc_of=qsrc_of,
             n=rg.n, paths_number=rg.paths_number),
        device,
    )


def rev_device_graph(rg: PathGraph, device="cpu") -> PathDeviceGraph:
    """The reverse graph's device encoding, cached on it per device."""
    return _per_device(rg, device, build_rev_device_graph, key="_torch_rev_device_graphs")


def group_table(dg: PathDeviceGraph):
    """The groups of each row that the pathwise kernels solve once:
    the distinct (rep, pred) pairs over the row's on-path lanes, in
    path order (``pallas_pathwise._group_meta``, :402-437, without its
    padding of the rows to a multiple of the grid step).

    Returns (grep int32[n, Gd] with -1 past a row's groups, gpred
    int32[n, Gd] with 0 there, pslot int32[n, P]: each on-path lane's
    group column, -1 off-path), on ``dg.device``; Gd is the most groups
    of any row 1..n-2 (at least 1).  Rows 0 and n-1 have no groups.

    On a reverse graph, the lanes that ``pathwise_meta_rev`` marks as a
    constant 0 (``qsrc_of`` -1: the ghost lanes of a ghost-alpha row,
    left without rep and successor) get no group either, so the kernel
    writes them 0.
    """

    def build():
        h = dg.host()
        rep, pred, on = h["rep_of"], h["pred_of"], h["paths_on"]
        zero = h["qsrc_of"] < 0 if dg.qsrc_of is not None else np.zeros_like(on)
        n, P = dg.n, dg.paths_number
        pairs_of = [[] for _ in range(n)]
        pslot = np.full((n, P), -1, np.int32)
        for i in range(1, n - 1):
            slot: dict[tuple[int, int], int] = {}
            for q in np.flatnonzero(on[i] & ~zero[i]):
                t = (int(rep[i, q]), int(pred[i, q]))
                if min(t) < 0:   # the metadata covers every other on-path lane
                    raise ValueError(f"row {i}, path {q}: on the node but in no group")
                if t not in slot:
                    slot[t] = len(pairs_of[i])
                    pairs_of[i].append(t)
                pslot[i, q] = slot[t]
        Gd = max(max((len(p) for p in pairs_of[1 : n - 1]), default=1), 1)
        grep = np.full((n, Gd), -1, np.int32)
        gpred = np.zeros((n, Gd), np.int32)
        for i, pairs in enumerate(pairs_of):
            grep[i, : len(pairs)] = [a for a, _ in pairs]
            gpred[i, : len(pairs)] = [b for _, b in pairs]
        return tuple(torch.from_numpy(a).to(dg.device) for a in (grep, gpred, pslot))

    return dg.cached("_group_table", build)


def encode_reads(sequences: list[str], pad_to: int | None = None, device="cpu"):
    """Pad '$'-prefixed reads into (codes int32[B, Lp], lengths int32[B]).

    Padding uses the 'N' code; every fill masks to the per-read length.
    Lp is rounded up to a multiple of 8, as in the JAX package, so both
    packages see the same shapes.
    """
    lengths = np.array([len(s) for s in sequences], dtype=np.int32)
    Lp = int(lengths.max()) if pad_to is None else pad_to
    Lp = (Lp + 7) // 8 * 8
    out = np.full((len(sequences), Lp), scoring.N, dtype=np.int32)
    for b, s in enumerate(sequences):
        out[b, : len(s)] = scoring.encode(s)
    return (
        torch.from_numpy(out).to(device),
        torch.from_numpy(lengths).to(device),
    )


def encode_read_aux(values, device="cpu"):
    """A per-read int32 auxiliary array (bta, ...), batch-aligned with
    :func:`encode_reads`."""
    return torch.as_tensor(np.asarray(values, dtype=np.int32)).to(device)
