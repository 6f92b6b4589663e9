"""Pathwise fill of modes 4/5 on the GPU: wrapper of ``csrc/pathwise.cu``.

Replaces ``recgraph_tpu/ops/pallas_pathwise.py:462 fill_pathwise_v1``
and, at any path count, its path-tiled variant
``recgraph_tpu/ops/pallas_pathwise_bigp.py:409 fill_pathwise_bigp``.
Its plain version is ``pathwise_engine.fill_pathwise_plain``; both
return A int32[B, P, n, Lp] and agree bit for bit.
``metrics.LAUNCHES["pathwise"]`` counts the launches and
``metrics.SHAPES`` records (reads, rows, Lp, Lp, paths).

:func:`plan` lays out a launch of K7 or K8 (``cuda_pathwise_rev``): the
blocks a read (a cluster that splits the read's lanes), the threads a
block, and whether the per-read scratch fits in shared memory.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _kernels
from .encode import group_table

KERNEL = "pathwise"
SOURCE = "recgraph_tpu_torch/csrc/pathwise.cu"
REPLACES = "recgraph_tpu/ops/pallas_pathwise.py:462"
REPLACES_BIGP = "recgraph_tpu/ops/pallas_pathwise_bigp.py:409"

CLUSTERS = (1, 2, 4, 8)     # blocks a read (8: the portable cluster limit)
MAX_THREADS = 512           # the kernels' __launch_bounds__ (PW_THREADS)
SMEM_MAX = 160 * 1024       # dynamic shared memory a block may take
CHAIN_COLS = (5, 8)         # chain columns a lane the kernels are built for
SM_BLOCKS = 3               # the most blocks an SM is asked to hold at once


@dataclass(frozen=True)
class Plan:
    cluster: int       # blocks a read
    threads: int       # threads a block
    cw: int            # chain columns a lane (CHAIN_COLS)
    smem: int          # dynamic shared memory a block, bytes
    smem_form: bool    # the per-read scratch in shared memory
    stride: int        # device scratch a block, bytes (0 in the shared-memory form)


def lane_split(P: int, cluster: int) -> list[tuple[int, int]]:
    """The lanes [q0, q1) of each block of a read's cluster, as the
    kernel splits them."""
    return [(r * P // cluster, (r + 1) * P // cluster) for r in range(cluster)]


def _lpa(Lp: int) -> int:
    return (Lp + 3) // 4 * 4


def scratch_bytes(Lp: int, Gd: int, nl: int) -> int:
    """The per-read scratch of a K7/K8 block of ``nl`` lanes
    (``PwScratch``): the gap sums, the (src, add) table of each of the Gd
    groups and the lanes' staged source rows as int32, the read codes as
    bytes, each over Lp rounded up to 4 columns; a multiple of 16."""
    return (_lpa(Lp) * (4 * (1 + 2 * Gd + nl) + 1) + 15) // 16 * 16


def meta_bytes(Gd: int, nl: int) -> int:
    """The row tables a block stages one row ahead, twice (``PwMeta``):
    the node code with the row's group count, the Gd groups' reps and
    pred rows, and the group and (K8) source plane of each of its ``nl``
    lanes, padded to 4 ints."""
    return 2 * 4 * ((1 + 2 * Gd + 2 * nl + 3) // 4 * 4)


def plan(B: int, P: int, Lp: int, Gd: int, sms: int, per_sm, cluster: int | None = None) -> Plan:
    """The launch of K7/K8 for B reads of width Lp on a graph of P paths
    and Gd groups a row, on a card of ``sms`` SMs; ``per_sm(threads,
    smem, smem_form, cw)`` gives the blocks an SM holds at once.

    - Cluster (unless given): the most blocks a read, up to 8 and at most
      P, such that the card holds at most two of the launch's blocks an
      SM; 1 once the reads alone fill the card.
    - The scratch in shared memory while it fits in ``SMEM_MAX`` beside
      the row tables (:func:`meta_bytes`), else in device memory.
    - The chains' columns a lane ``cw``: the fewest of ``CHAIN_COLS``
      with which one warp covers the read (32 cw >= Lp), so that a
      group's chain runs on one warp with no exchange between warps; 8
      on longer reads, where a chain takes up to ceil(Lp / 256) warps in
      windows, and where the scratch is in device memory.
    - Threads: one per four columns of a block's lanes (one per column
      when Lp is not a multiple of 4), 64 to ``MAX_THREADS``; a warp
      fewer while an SM could not hold its share of the blocks at once,
      at most ``SM_BLOCKS`` (more blocks a read rather take a second
      wave: each block's rows slow down with every block beside it).
    """
    if cluster is None:
        cluster = max(c for c in CLUSTERS if c <= P and (c == 1 or B * c <= 2 * sms))
    if cluster not in CLUSTERS or cluster > P:
        raise ValueError(f"pathwise: cluster {cluster} for {P} paths")
    nl = -(-P // cluster)
    small = meta_bytes(Gd, nl)
    scratch = scratch_bytes(Lp, Gd, nl)
    smem_form = small + scratch <= SMEM_MAX
    smem = small + scratch if smem_form else small
    cw = next((c for c in CHAIN_COLS if smem_form and 32 * c >= Lp), CHAIN_COLS[-1])
    items = nl * (Lp // 4 if Lp % 4 == 0 else Lp)
    threads = min(MAX_THREADS, max(64, -(-items // 32) * 32))
    need = min(-(-B * cluster // sms), SM_BLOCKS)
    while threads > 64 and per_sm(threads, smem, smem_form, cw) < need:
        threads -= 32
    return Plan(cluster, threads, cw, smem, smem_form, 0 if smem_form else scratch)


_per_sm_cache: dict = {}


def launch_plan(entry: str, dev, B, P, Lp, Gd, cluster=None) -> Plan:
    """:func:`plan` on ``dev``, the occupancy from the C entry ``entry``
    (``rgt_pathwise_per_sm`` or ``rgt_pathwise_rev_per_sm``)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def per_sm(threads, smem, smem_form, cw):
        key = (entry, dev.index, threads, smem, smem_form, cw)
        if key not in _per_sm_cache:
            with torch.cuda.device(dev):
                v = getattr(_kernels.load(), entry)(threads, smem, int(smem_form), cw)
            _kernels.check(-v if v < 0 else 0, entry)
            _per_sm_cache[key] = v
        return _per_sm_cache[key]

    return plan(B, P, Lp, Gd, sms, per_sm, cluster)


def group_counts(dg) -> torch.Tensor:
    """int32[n]: the groups of each row (``encode.group_table``'s grep
    entries that are not -1), cached on the graph."""
    return dg.cached("_group_counts",
                     lambda: (group_table(dg)[0] >= 0).sum(1, dtype=torch.int32).contiguous())


def scratch_tensor(pl: Plan, B: int, dev) -> torch.Tensor:
    """The device scratch of a launch (16 bytes in the shared-memory form)."""
    return torch.empty(max(16, B * pl.cluster * pl.stride), dtype=torch.uint8, device=dev)


def fill_pathwise_cuda(dg, table, seq, semiglobal, cluster=None):
    """Launch the dense pathwise fill on the GPU (``cluster``: blocks a
    read, else :func:`plan`'s choice)."""
    dev = seq.device
    B, Lp = seq.shape
    n, P = dg.n, dg.paths_number
    grep, gpred, pslot = group_table(dg)
    gcount = group_counts(dg)
    Gd = grep.shape[1]
    _kernels.check_tensors(KERNEL, dev, seq=seq, table=table, codes=dg.codes,
                           grep=grep, gpred=gpred, pslot=pslot, gcount=gcount)
    if table.shape != (7, 7):
        raise ValueError(f"{KERNEL}: bad table shape {tuple(table.shape)}")
    pl = launch_plan("rgt_pathwise_per_sm", dev, B, P, Lp, Gd, cluster)
    scratch = scratch_tensor(pl, B, dev)
    A = torch.empty((B, P, n, Lp), dtype=torch.int32, device=dev)
    _kernels.launch(
        KERNEL, (B, n, Lp, Lp, P), dev,
        seq, table, dg.codes, grep, gpred, pslot, gcount, B, n, P, Lp, Gd, int(bool(semiglobal)),
        pl.cluster, pl.threads, pl.smem, int(pl.smem_form), pl.cw, scratch, pl.stride,
        A,
    )
    return A
