"""The host side of the windowed pathwise fill K10 on the CPU.

``cuda_pathwise_win.plan`` lays out a launch of one block a read: the
threads a block and whether the per-read scratch sits in shared or
device memory.  It is checked at the launch shapes of ``chip_smoke.py``'s
long mode-4 runs and where the threads and the scratch change form.
``pathwise_window.win_replay_table_plain``, the (src, add, floor) table
K10's chain warps build for each group with the realignment shift and
the packed chain's clamp folded in, is held to the plain fill: replaying
every row of every lane from it (``fill_pathwise_win_via_table``) gives
``fill_pathwise_win_plain``'s Aw, window starts and exit bounds exactly
(int32), on 8 long reads at W = 32 (reads overflow the window and fail
the guard) and on the example graph at W = 64.
"""

import contextlib
import io
import os
import sys

import pytest
import torch

from recgraph_tpu_torch.graph.pathgraph import PathGraph
from recgraph_tpu_torch.io import fasta, gfa
from recgraph_tpu_torch.ops import cuda_pathwise, cuda_pathwise_win, pathwise_window
from recgraph_tpu_torch.ops.encode import encode_reads, path_device_graph
from recgraph_tpu_torch.ops.encode import group_table as encode_group_table
from recgraph_tpu_torch.scoring import ScoreMatrix

from test_torch_pathwise_window import long_reads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
torch.set_num_threads(1)
H100_SMS = 132


def _per_sm(threads, smem, smem_form):
    """Blocks an SM holds, as the occupancy query answers for a kernel of
    96 registers a thread (2,048 threads, 64 Ki registers, 227 KB of
    shared memory an SM)."""
    return max(0, min(2048 // threads, 65536 // (96 * threads), 232448 // max(smem, 1), 32))


@pytest.mark.parametrize("B,W,threads", [
    (110, 256, 512),   # long mode 4, the first rung: 10 lanes, 4 cells a thread
    (72, 256, 512),    # the long corpus' last chunk
    (110, 512, 512),   # the second rung
    (264, 256, 320),   # two reads an SM: a warp fewer until an SM holds two blocks
])
def test_plan_at_main_path_shapes(B, W, threads):
    P, n, Lp, Gd = 10, 3798, 2440, 2
    pl = cuda_pathwise_win.plan(B, P, n, Lp, W, Gd, H100_SMS, _per_sm)
    assert pl.threads == threads
    assert pl.smem_form and pl.stride == 0
    assert pl.smem == cuda_pathwise.meta_bytes(Gd, P) + cuda_pathwise_win.scratch_bytes(
        Lp, n, W, Gd, P)
    assert pl.smem % 16 == 0 and pl.smem <= cuda_pathwise_win.SMEM_MAX
    # every block of the launch resident at once
    assert _per_sm(pl.threads, pl.smem, True) >= -(-B // H100_SMS)


def test_plan_cluster_and_scratch_edges():
    """One block holds all of a read's lanes (no cluster): a path alone
    takes the 64-thread floor; the scratch moves to device memory past
    SMEM_MAX (a 41,000-bp read at W 1,024), at a stride that is a
    multiple of 16."""
    P, n, Lp, Gd = 10, 3798, 2440, 2
    one = cuda_pathwise_win.plan(8, 1, n, Lp, 32, Gd, H100_SMS, _per_sm)
    assert one.threads == 64 and one.smem_form
    big = cuda_pathwise_win.plan(8, P, 30000, 41000, 1024, Gd, H100_SMS, _per_sm)
    assert not big.smem_form and big.smem == cuda_pathwise.meta_bytes(Gd, P)
    assert big.stride == cuda_pathwise_win.scratch_bytes(41000, 30000, 1024, Gd, P)
    assert big.stride % 16 == 0 and big.threads == 512
    # the scratch just past SMEM_MAX: W 1,024 on the long corpus' graph
    wide = cuda_pathwise_win.plan(8, P, n, Lp, 1024, Gd, H100_SMS, _per_sm)
    assert (cuda_pathwise.meta_bytes(Gd, P) + cuda_pathwise_win.scratch_bytes(Lp, n, 1024, Gd, P)
            > cuda_pathwise_win.SMEM_MAX) and not wide.smem_form
    # the scratch: gap sums, window starts and best positions, floor,
    # (src, add) a group, staged rows and rows i-1 and i a lane (int32),
    # read codes (bytes)
    assert cuda_pathwise_win.scratch_bytes(10, 5, 9, 2, 3) == (
        4 * (12 + 16 + 12 * (1 + 2 * 2 + 3 * 3)) + 12 + 15) // 16 * 16


def test_row_tables_pack_the_group_table():
    """K10 loads a row's tables with one int a lane: the node code and
    group count, the groups' reps and pred rows, each lane's group."""
    g = PathGraph.from_gfa(gfa.parse_gfa(os.path.join(ROOT, "example", "graph.gfa")))
    dg = path_device_graph(g, "cpu")
    grep, gpred, pslot = encode_group_table(dg)
    meta = cuda_pathwise_win.row_tables(dg)
    Gd, P = grep.shape[1], dg.paths_number
    assert meta.dtype == torch.int32 and meta.shape == (dg.n, 1 + 2 * Gd + P)
    assert torch.equal(meta[:, 0] & 0xff, dg.codes.to(torch.int32))
    assert torch.equal(meta[:, 0] >> 8, (grep >= 0).sum(1, dtype=torch.int32))
    assert torch.equal(meta[:, 1:], torch.cat([grep, gpred, pslot], 1))


@pytest.fixture(scope="module")
def long8(tmp_path_factory):
    from make_synthetic import make

    d = str(tmp_path_factory.mktemp("pwtab"))
    with contextlib.redirect_stdout(io.StringIO()):
        make(d, n_back=1200, n_reads=1, seed=11)
    reads = long_reads(os.path.join(d, "graph.gfa"), 8, 11)
    return PathGraph.from_gfa(gfa.parse_gfa(os.path.join(d, "graph.gfa"))), reads


@pytest.mark.parametrize("case,W", [("long8", 32), ("example", 64)])
def test_table_replay_matches_plain_fill(request, case, W):
    if case == "long8":
        g, reads = request.getfixturevalue("long8")
        matrix = "none"
    else:
        g = PathGraph.from_gfa(gfa.parse_gfa(os.path.join(ROOT, "example", "graph.gfa")))
        reads = fasta.get_sequences(os.path.join(ROOT, "example", "reads.fa"))[0][:6]
        matrix = "HOXD70"
    dg = path_device_graph(g, "cpu")
    table = torch.as_tensor(ScoreMatrix.create(matrix, 2, -4).table, dtype=torch.int32)
    seq, L = encode_reads(reads, device="cpu")
    rmin = pathwise_window.rmin_tensor(dg)
    ref = pathwise_window.fill_pathwise_win_plain(dg, table, seq, L, W, rmin)
    got = pathwise_window.fill_pathwise_win_via_table(dg, table, seq, L, W, rmin)
    for a, b, what in zip(got, ref, ("Aw", "ws", "bound")):
        assert torch.equal(a, b), what
    if case == "long8":   # the window strands cells: some read fails the guard
        fc = pathwise_window._final_column_win(*ref[:2], L)
        assert (fc.amax(dim=(1, 2)) <= ref[2]).any()
