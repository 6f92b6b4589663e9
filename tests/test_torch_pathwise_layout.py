"""The host side of the pathwise fills K7 and K8 on the CPU.

``cuda_pathwise.plan`` lays out a launch: the blocks a read (a cluster
that splits the read's lanes), the threads a block and whether the
per-read scratch sits in shared or device memory.  It is checked at the
launch shapes of ``chip_smoke.py``'s CLI runs, on the lane split, and
where the scratch changes form.  ``pathwise_engine.replay_table_plain``,
the (src, add) table the kernels' chain warps build for each group, is
held to the plain fills: replaying every on-path lane of every group of
every row from it gives the plain fill's rows, exactly (int32 DP cells),
for K7 in modes 4/5 and K8 in modes 8/9, on the delta-leak graphs too.
"""

import os
import random

import pytest
import torch

from recgraph_tpu_torch import fuzz
from recgraph_tpu_torch.graph.pathgraph import PathGraph
from recgraph_tpu_torch.io import fasta, gfa
from recgraph_tpu_torch.ops import cuda_pathwise, pathwise_engine, recombination_engine
from recgraph_tpu_torch.ops.encode import (
    encode_reads, group_table, path_device_graph, rev_device_graph,
)
from recgraph_tpu_torch.scoring import GAP, SENTINEL, ScoreMatrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)
H100_SMS = 132


def _per_sm(threads, smem, smem_form, cw):
    """Blocks an SM holds, as the occupancy query answers for kernels of
    96 registers a thread (128 with 8 chain columns a lane; 2,048
    threads, 64 Ki registers, 227 KB of shared memory an SM)."""
    regs = 96 if cw < 8 else 128
    return max(0, min(2048 // threads, 65536 // (regs * threads), 232448 // max(smem, 1), 32))


def _bytes(Lp, Gd, nl):
    return cuda_pathwise.meta_bytes(Gd, nl) + cuda_pathwise.scratch_bytes(Lp, Gd, nl)


@pytest.mark.parametrize("B,P,Lp,Gd,cluster,threads,cw", [
    (348, 9, 152, 2, 1, 224, 5),      # stretch chunk, modes 4/5/8/9
    (697, 9, 152, 2, 1, 224, 5),      # stretch mode-4 chunk: a second wave, not 6 blocks an SM
    (24, 128, 152, 2, 8, 320, 5),     # 128 paths, modes 4/8
    (11, 10, 2440, 2, 8, 512, 8),     # long chunk, modes 5/8/9: chains in windows
])
def test_plan_at_main_path_shapes(B, P, Lp, Gd, cluster, threads, cw):
    pl = cuda_pathwise.plan(B, P, Lp, Gd, H100_SMS, _per_sm)
    assert (pl.cluster, pl.threads, pl.cw) == (cluster, threads, cw)
    nl = -(-P // cluster)
    assert pl.smem_form and pl.stride == 0 and pl.smem == _bytes(Lp, Gd, nl)
    assert pl.smem % 16 == 0
    assert cw == 8 or 32 * cw >= Lp   # short reads: one warp covers a chain
    # an SM holds its share of the blocks, up to SM_BLOCKS; a warp more would not
    need = min(-(-B * cluster // H100_SMS), cuda_pathwise.SM_BLOCKS)
    assert _per_sm(pl.threads, pl.smem, True, cw) >= need
    if pl.threads < min(512, -(-nl * Lp // 128) * 32):
        assert _per_sm(pl.threads + 32, pl.smem, True, cw) < need


def test_lane_split_gives_every_lane_one_block():
    for P in (1, 2, 3, 7, 9, 10, 23, 126, 128, 130):
        for S in cuda_pathwise.CLUSTERS:
            if S > P:
                with pytest.raises(ValueError):
                    cuda_pathwise.plan(4, P, 152, 2, H100_SMS, _per_sm, cluster=S)
                continue
            spans = cuda_pathwise.lane_split(P, S)
            lanes = [q for q0, q1 in spans for q in range(q0, q1)]
            assert lanes == list(range(P)), (P, S)
            assert all(0 < q1 - q0 <= -(-P // S) for q0, q1 in spans), (P, S)
    # clusters never ask for more blocks a read than paths, nor more than
    # two blocks an SM on average
    assert cuda_pathwise.plan(4, 1, 152, 1, H100_SMS, _per_sm).cluster == 1
    assert cuda_pathwise.plan(4, 3, 152, 1, H100_SMS, _per_sm).cluster == 2
    assert cuda_pathwise.plan(49, 128, 152, 1, H100_SMS, _per_sm).cluster == 4
    assert cuda_pathwise.plan(264, 128, 152, 1, H100_SMS, _per_sm).cluster == 1


def test_scratch_changes_form_where_the_bytes_say():
    Gd, P = 2, 10
    fits = max(Lp for Lp in range(4, 20000, 4) if _bytes(Lp, Gd, P) <= cuda_pathwise.SMEM_MAX)
    inside = cuda_pathwise.plan(2, P, fits, Gd, H100_SMS, _per_sm, cluster=1)
    past = cuda_pathwise.plan(2, P, fits + 4, Gd, H100_SMS, _per_sm, cluster=1)
    assert inside.smem_form and inside.stride == 0 and inside.smem == _bytes(fits, Gd, P)
    assert not past.smem_form and past.smem == cuda_pathwise.meta_bytes(Gd, P)
    assert past.cw == 8   # device memory: the 8-column chains
    assert past.stride == cuda_pathwise.scratch_bytes(fits + 4, Gd, P)
    assert past.stride % 16 == 0
    # a read of ~41,000 bp takes the device-scratch form
    assert not cuda_pathwise.plan(1, P, 41008, Gd, H100_SMS, _per_sm).smem_form


def _case(name):
    """(PathGraph, reads) of a case."""
    if name == "example":
        g = PathGraph.from_gfa(gfa.parse_gfa(os.path.join(ROOT, "example", "graph.gfa")))
        return g, fasta.get_sequences(os.path.join(ROOT, "example", "reads.fa"))[0][:2]
    if name.startswith("leak"):
        gf = fuzz.fragment_gfa(int(name[4:]))
        return PathGraph.from_gfa(gf), fuzz.fragment_reads(random.Random(7), gf, k=3)
    rng = random.Random(int(name[6:]))
    gf = fuzz.random_gfa(rng, n_nodes=20, n_paths=5, cover_all=True)
    return PathGraph.from_gfa(gf), [fuzz.random_read(rng, gf) for _ in range(3)] + ["$A"]


def _assert_replays(dg, A, subs, G, L, restart):
    """Every on-path lane of every group of every row of A, replayed
    from the group's table, equals A (K8 when L is given: there row n-1
    held path 0's chain on every plane while the rows above read it)."""
    grep, gpred, pslot = (t.numpy() for t in group_table(dg))
    qsrc = dg.qsrc_of.numpy() if dg.qsrc_of is not None else None
    tab = subs[1]
    B, P, n, Lp = A.shape

    def at(q, r):
        return A[:, 0 if L is not None and r == n - 1 else q, r]

    for i in range(1, n - 1):
        code = int(dg.codes[i])
        subc = subs[0][code]
        for g in range(grep.shape[1]):
            if grep[i, g] < 0:
                break
            src, add = pathwise_engine.replay_table_plain(
                at(grep[i, g], gpred[i, g]), G, subc, int(tab[code, GAP]), restart, L)
            for q in (pslot[i] == g).nonzero()[0]:
                Aq = at(q if qsrc is None else qsrc[i, q], gpred[i, g])
                row = torch.where(src < 0, 0, Aq.gather(1, src.long().clamp(min=0))) + add
                assert torch.equal(row, A[:, q, i]), (i, g, q)


@pytest.mark.parametrize("name,matrix", [("example", "none"), ("random11", "HOXD70")])
def test_replay_table_gives_the_forward_fill(name, matrix):
    g, reads = _case(name)
    dg = path_device_graph(g, "cpu")
    table = torch.as_tensor(ScoreMatrix.create(matrix, 2, -4).table, dtype=torch.int32)
    seq, _ = encode_reads(reads)
    G = torch.cumsum(table[seq.long(), GAP], 1, dtype=torch.int32)
    subs = (table[:, seq.long()], table)     # [code, B, Lp]
    for semiglobal in (False, True):
        A = pathwise_engine.fill_pathwise_plain(dg, table, seq, semiglobal)
        _assert_replays(dg, A, subs, G, None, not semiglobal)


@pytest.mark.parametrize("name", ["random12", "leak4"])
def test_replay_table_gives_the_reverse_fill(name):
    g, reads = _case(name)
    dgr = rev_device_graph(g.reverse(), "cpu")
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table, dtype=torch.int32)
    seq, L = encode_reads(reads)
    Lp = seq.shape[1]
    j = torch.arange(Lp)
    rev = torch.where(j == (L.long() - 1)[:, None], SENTINEL, torch.roll(seq, -1, 1)).long()
    Gs = torch.where(j < L[:, None], table[rev, GAP], 0).flip(1).cumsum(1).flip(1)
    subs = (table[:, rev], table)
    for mode8 in (True, False):
        A = recombination_engine.fill_pathwise_rev_plain(dgr, table, seq, L, mode8)
        _assert_replays(dgr, A, subs, Gs.to(torch.int32), L, mode8)
