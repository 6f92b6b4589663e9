"""The CUDA kernels K1-K8, K10-K17, S1 (both entries) and S2 against their
plain torch versions, on the card (K7 and K8 also stand for the TPU's path-tiled K9a
and K9b).

Every test needs an NVIDIA GPU and skips without one.  The file imports
no JAX and nothing of the JAX package, and uses no conftest fixture, so
it runs on the GPU machine with

    python -m pytest tests/test_torch_kernels.py -q --noconftest

The tolerance is exact equality: every output is an int32 DP value,
index or flag, or S1's f32 column maximum, which rounds as the plain
version's (and the XLA engine's) expression does.
"""

import contextlib
import functools
import io
import os
import random
import sys

import numpy as np
import pytest
import torch

from recgraph_tpu_torch import fuzz, kernel_ab, metrics
from recgraph_tpu_torch.align.pipeline import Options, run
from recgraph_tpu_torch.graph.pathgraph import PathGraph
from recgraph_tpu_torch.graph.poagraph import PoaGraph
from recgraph_tpu_torch.io import fasta, gfa
from recgraph_tpu_torch.ops import (
    cuda_gap67_fill, cuda_gap67_hardrow, cuda_pathwise, cuda_pathwise_rev_win,
    cuda_pathwise_win, cuda_poa_gap_global, cuda_poa_gap_global_win, cuda_pathwise_rev,
    cuda_poa_gap_local, cuda_poa_global, cuda_poa_global_win, cuda_poa_local,
    cuda_poa_variants as cv, cuda_split_summary, pathwise_engine, pathwise_gap_engine,
    pathwise_window, poa_engine, poa_gap_engine, poa_variants as pv, recombination_engine,
    recombination_window, traceback_engine as tb,
)
from recgraph_tpu_torch.ops.encode import (
    encode_read_aux, encode_reads, path_device_graph, poa_device_graph, rev_device_graph,
)
from recgraph_tpu_torch.scoring import ScoreMatrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
EXAMPLE = (os.path.join(ROOT, "example", "reads.fa"),
           os.path.join(ROOT, "example", "graph.gfa"))
PENALTIES = [(-4, -2), (1, -2), (0, -1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _pairs(dg, table, seq, L, bta, oe, W):
    """(kernel, plain, args) for K1-K6 on one batch."""
    o, e = oe
    return (
        (cuda_poa_global.fill_global_cuda, poa_engine.fill_global_plain,
         (dg, table, seq, L, bta)),
        (cuda_poa_local.fill_local_cuda, poa_engine.fill_local_plain,
         (dg, table, seq, L)),
        (cuda_poa_global_win.fill_global_win_cuda, poa_engine.fill_global_windowed_plain,
         (dg, table, seq, L, bta, W)),
        (cuda_poa_gap_global.fill_gap_global_cuda, poa_gap_engine.fill_gap_global_plain,
         (dg, table, seq, L, bta, o, e)),
        (cuda_poa_gap_local.fill_gap_local_cuda, poa_gap_engine.fill_gap_local_plain,
         (dg, table, seq, L, o, e)),
        (cuda_poa_gap_global_win.fill_gap_global_win_cuda,
         poa_gap_engine.fill_gap_global_windowed_plain, (dg, table, seq, L, bta, o, e, W)),
    )


def _assert_kernels_match(g, reads, btas, sm, device, oe=(-4, -2), W=32):
    dg = poa_device_graph(g, device)
    table = torch.as_tensor(sm.table, dtype=torch.int32).to(device)
    seq, L = encode_reads(reads, device=device)
    bta = encode_read_aux(btas, device)
    for kern, plain, args in _pairs(dg, table, seq, L, bta, oe, W):
        got = kern(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        assert len(got) == len(ref)
        for k, (a, b) in enumerate(zip(got, ref)):
            assert a.dtype == b.dtype and torch.equal(a, b), (kern.__name__, k)


@pytest.mark.cuda
@pytest.mark.parametrize("matrix", ["none", "HOXD70"])
@pytest.mark.parametrize("amb", [False, True])
def test_kernels_match_plain_example(cuda, matrix, amb):
    seqs, _ = fasta.get_sequences(EXAMPLE[0])
    g = PoaGraph.from_gfa(gfa.parse_gfa(EXAMPLE[1]), amb_mode=amb)
    reads = seqs[:16]
    btas = [int(1 + 0.01 * len(s)) if k % 3 else k % 4 for k, s in enumerate(reads)]
    _assert_kernels_match(g, reads, btas, ScoreMatrix.create(matrix, 2, -4), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(24))
def test_kernels_match_plain_random(cuda, seed):
    """Random DAGs: many predecessors, short and long reads (up to 2,100
    columns, over two column tiles), band widths from 0 to the whole
    read, windows from 16 to 256, both scoring tables and both signs of
    the gap penalties."""
    rng = random.Random(1000 + seed)
    gf = fuzz.random_gfa(rng, n_nodes=8 + seed % 24, n_paths=4, cover_all=True)
    g = PoaGraph.from_gfa(gf, amb_mode=bool(seed % 2))
    reads = [fuzz.random_read(rng, gf) for _ in range(6)] + ["$A", "$" + "ACGT" * 40]
    if seed % 4 == 0:
        reads.append("$" + "".join(rng.choice("ACGT") for _ in range(2100)))
    btas = [rng.choice([0, 1, 2, 5, 1000]) for _ in reads]
    sm = ScoreMatrix.create("HOXD70" if seed % 3 == 0 else "none", 2, -4)
    _assert_kernels_match(g, reads, btas, sm, cuda, oe=PENALTIES[seed % 3],
                          W=(16, 64, 256)[seed % 3])


@pytest.mark.cuda
def test_dispatch_launches_kernels_and_counts(cuda):
    seqs, _ = fasta.get_sequences(EXAMPLE[0])
    g = PoaGraph.from_gfa(gfa.parse_gfa(EXAMPLE[1]))
    dg = poa_device_graph(g, cuda)
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table).to(cuda)
    seq, L = encode_reads(seqs[:4], device=cuda)
    bta = encode_read_aux([2] * 4, cuda)
    metrics.reset_phases()
    poa_engine.fill_global_best(dg, table, seq, L, bta)
    poa_engine.fill_local_best(dg, table, seq, L)
    poa_engine.fill_local_best(dg, table, seq, L)
    poa_engine.fill_global_windowed_best(dg, table, seq, L, bta, 64)
    poa_gap_engine.fill_gap_global_best(dg, table, seq, L, bta, -4, -2)
    poa_gap_engine.fill_gap_local_best(dg, table, seq, L, -4, -2)
    poa_gap_engine.fill_gap_global_windowed_best(dg, table, seq, L, bta, -4, -2, 64)
    assert metrics.LAUNCHES[cuda_poa_global.KERNEL] == 1
    assert metrics.LAUNCHES[cuda_poa_local.KERNEL] == 2
    for mod in (cuda_poa_global_win, cuda_poa_gap_global, cuda_poa_gap_local,
                cuda_poa_gap_global_win):
        assert metrics.LAUNCHES[mod.KERNEL] == 1, mod.KERNEL
    B, Lp = seq.shape
    assert metrics.SHAPES == {
        (cuda_poa_global.KERNEL, B, g.n, Lp, Lp): 1, (cuda_poa_local.KERNEL, B, g.n, Lp, Lp): 2,
        (cuda_poa_global_win.KERNEL, B, g.n, Lp, 64): 1,
        (cuda_poa_gap_global.KERNEL, B, g.n, Lp, Lp): 1,
        (cuda_poa_gap_local.KERNEL, B, g.n, Lp, Lp): 1,
        (cuda_poa_gap_global_win.KERNEL, B, g.n, Lp, 64): 1,
    }
    with pytest.raises(ValueError, match="int32"):
        cuda_poa_local.fill_local_cuda(dg, table, seq.long(), L)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_poa_gap_local.fill_gap_local_cuda(dg, table, seq.t().contiguous().t(), L, -4, -2)
    with pytest.raises(ValueError, match="cpu"):
        cuda_poa_gap_global.fill_gap_global_cuda(dg, table, seq, L.cpu(), bta, -4, -2)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_cuda_pipeline_matches_cpu_amb_strand(cuda, tmp_path, mode):
    """The whole pipeline on the card equals the CPU run (which the CPU
    tests hold against the JAX pipeline), reverse-strand retries included."""
    seqs, names = fasta.get_sequences(EXAMPLE[0])
    reads = tmp_path / "reads.fa"
    reads.write_text("".join(f">{n}\n{s[1:]}\n" for n, s in zip(names[:12], seqs[:12])))
    out = {}
    for device in ("cpu", "cuda"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            run(Options(str(reads), EXAMPLE[1], alignment_mode=mode, amb_strand=True,
                        device=device))
        out[device] = buf.getvalue()
    assert out["cuda"] == out["cpu"] and len(out["cpu"].splitlines()) == 12


def _long_reads(gfa_path, k, seed):
    """k full-haplotype reads with 2 % substitutions (chip_smoke.make_long's recipe)."""
    rng = random.Random(seed)
    walks, segs = {}, {}
    with open(gfa_path) as fh:
        for ln in fh:
            f = ln.rstrip("\n").split("\t")
            if f[0] == "P":
                walks[f[1]] = [int(x[:-1]) for x in f[2].split(",")]
            elif f[0] == "S":
                segs[int(f[1])] = f[2]
    reads = []
    for _ in range(k):
        s = "".join(segs[x] for x in walks[rng.choice(sorted(walks))])
        reads.append("$" + "".join(rng.choice("ACGT") if rng.random() < 0.02 else c
                                   for c in s))
    return reads


def _assert_equal(got, ref, what):
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), (what, k)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(8))
def test_pathwise_kernel_matches_plain(cuda, seed):
    """K7 on random DAGs (1-9 paths, up to 3 predecessor edges a node)
    and reads up to 2,100 columns (three column tiles), both modes, both
    tables, at widths where the JAX engine's packed chain fits and where
    it does not."""
    rng = random.Random(500 + seed)
    gf = fuzz.random_gfa(rng, n_nodes=6 + 4 * seed, n_paths=1 + seed, cover_all=True)
    g = PathGraph.from_gfa(gf)
    reads = [fuzz.random_read(rng, gf) for _ in range(5)] + ["$A", "$" + "ACGT" * 40]
    if seed % 3 == 0:
        reads.append("$" + "".join(rng.choice("ACGT") for _ in range(2100)))
    sm = ScoreMatrix.create("HOXD70" if seed % 2 else "none", 2, -4)
    dg = path_device_graph(g, cuda)
    table = torch.as_tensor(sm.table, dtype=torch.int32).to(cuda)
    seq, _ = encode_reads(reads, device=cuda)
    for semiglobal in (False, True):
        _assert_equal(cuda_pathwise.fill_pathwise_cuda(dg, table, seq, semiglobal),
                      pathwise_engine.fill_pathwise_plain(dg, table, seq, semiglobal),
                      (seed, semiglobal))


@pytest.mark.cuda
@pytest.mark.parametrize("corpus", ["example", "p126"])
def test_pathwise_kernel_matches_plain_corpora(cuda, tmp_path, corpus):
    """K7 on the example graph (23 paths, up to 9 groups a row) and on a
    126-path graph, the shape at which the JAX dispatch takes K9a."""
    if corpus == "example":
        reads_fa, gfa_path = EXAMPLE
    else:
        from make_synthetic import make

        with contextlib.redirect_stdout(io.StringIO()):
            make(str(tmp_path), n_back=80, n_reads=8, seed=7, n_paths=126)
        reads_fa, gfa_path = str(tmp_path / "reads.fa"), str(tmp_path / "graph.gfa")
    g = PathGraph.from_gfa(gfa.parse_gfa(gfa_path))
    reads = fasta.get_sequences(reads_fa)[0][:8]
    dg = path_device_graph(g, cuda)
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table).to(cuda)
    seq, _ = encode_reads(reads, pad_to=256, device=cuda)
    for semiglobal in (False, True):
        _assert_equal(cuda_pathwise.fill_pathwise_cuda(dg, table, seq, semiglobal),
                      pathwise_engine.fill_pathwise_plain(dg, table, seq, semiglobal),
                      (corpus, semiglobal))


def _pathwise_edge(name, tmp_path):
    """(PathGraph, reads, read width or None, clusters) of a K7/K8 case
    at the edges of their launch layout (``cuda_pathwise.plan``)."""
    if name == "p1":
        rng = random.Random(61)
        gf = fuzz.random_gfa(rng, n_nodes=20, n_paths=1, cover_all=True)
        return PathGraph.from_gfa(gf), [fuzz.random_read(rng, gf) for _ in range(5)], None, (1,)
    if name == "p7":
        rng = random.Random(67)
        gf = fuzz.random_gfa(rng, n_nodes=30, n_paths=7, cover_all=True)
        reads = [fuzz.random_read(rng, gf) for _ in range(6)] + ["$" + "ACGT" * 70]
        return PathGraph.from_gfa(gf), reads, None, (None, 1, 2, 4)
    if name == "p126":
        from make_synthetic import make

        with contextlib.redirect_stdout(io.StringIO()):
            make(str(tmp_path), n_back=80, n_reads=8, seed=7, n_paths=126)
        g = PathGraph.from_gfa(gfa.parse_gfa(str(tmp_path / "graph.gfa")))
        return g, fasta.get_sequences(str(tmp_path / "reads.fa"))[0][:8], None, (1, 8)
    if name == "lp150":   # 150 columns: one column a thread, no 16-byte stores
        g = PathGraph.from_gfa(gfa.parse_gfa(EXAMPLE[1]))
        reads = [r[:150] for r in fasta.get_sequences(EXAMPLE[0])[0][:6]]
        return g, reads, 150, (None, 1, 2)
    # long41: one 41,000-bp read on a row of 40 groups: the device-scratch form
    read = "$" + "".join(random.Random(5).choice("ACGT") for _ in range(41000))
    return PathGraph.from_gfa(fuzz.fan_gfa(40)), [read], None, (None, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["p1", "p7", "p126", "lp150", "long41"])
def test_pathwise_kernels_at_layout_edges(cuda, tmp_path, name):
    """K7 and K8 at the edges of their layout, both modes each, every
    cell equal to the plain fills: one path; 7 paths (not a multiple of
    the cluster size) at cluster sizes 1, 2 and 4 and the wrapper's own
    choice; 126 paths at 1 and 8 blocks a read; a read width of 150 (not
    a multiple of 4); a 41,000-bp read on a row of 40 groups (the
    per-read scratch in device memory, not shared memory)."""
    g, reads, width, clusters = _pathwise_edge(name, tmp_path)
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table, dtype=torch.int32).to(cuda)
    seq, L = encode_reads(reads, pad_to=256 if name == "p126" else None, device=cuda)
    if width is not None:
        seq = seq[:, :width].contiguous()
    dg, dgr = path_device_graph(g, cuda), rev_device_graph(g.reverse(), cuda)
    for semi in (False, True):
        ref = pathwise_engine.fill_pathwise_plain(dg, table, seq, semi)
        ref_r = recombination_engine.fill_pathwise_rev_plain(dgr, table, seq, L, not semi)
        for cluster in clusters:
            _assert_equal(cuda_pathwise.fill_pathwise_cuda(dg, table, seq, semi, cluster),
                          ref, ("K7", name, semi, cluster))
            _assert_equal(cuda_pathwise_rev.fill_pathwise_rev_cuda(dgr, table, seq, L, not semi,
                                                                   cluster),
                          ref_r, ("K8", name, semi, cluster))


@pytest.mark.cuda
def test_pathwise_win_kernel_matches_plain(cuda, tmp_path):
    """K10 on long reads at window widths from 16 (the guard fails) to
    1,024 (several column tiles)."""
    from make_synthetic import make

    with contextlib.redirect_stdout(io.StringIO()):
        make(str(tmp_path), n_back=600, n_reads=1, seed=11)
    gfa_path = str(tmp_path / "graph.gfa")
    g = PathGraph.from_gfa(gfa.parse_gfa(gfa_path))
    reads = _long_reads(gfa_path, 3, 5) + ["$" + "ACGT" * 30]
    dg = path_device_graph(g, cuda)
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table).to(cuda)
    seq, L = encode_reads(reads, device=cuda)
    rmin = pathwise_window.rmin_tensor(dg)
    for W in (16, 64, 256, 1024):
        _assert_equal(pathwise_window.fill_pathwise_win_best(dg, table, seq, L, W, rmin),
                      pathwise_window.fill_pathwise_win_plain(dg, table, seq, L, W, rmin), W)


def _gap_local_edge(name, tmp_path):
    """(PoaGraph, reads, read width to pad to, forced layouts) of a case at
    the edges of the warp layout of K2, K4 and K5
    (``cuda_poa_gap_local.plan``); None in the layouts is the wrapper's own
    choice."""
    Plan = cuda_poa_gap_local.Plan
    seqs = fasta.get_sequences(EXAMPLE[0])[0]
    example = PoaGraph.from_gfa(gfa.parse_gfa(EXAMPLE[1]))
    if name == "bp1":   # 1-bp reads: one column a lane
        return example, ["$A", "$C", "$G", "$T", "$N"], None, (None,)
    if name == "lp32":   # reads of 32 columns: one column a lane, and 2 warps of 3 forced
        return example, [r[:32] for r in seqs[:6]], None, (None, Plan(2, 3, False))
    if name.startswith("lp"):
        # a width of 151 (not a multiple of 4: no 16-byte stores); past a
        # warp of 5 columns a lane; one warp of 7 columns a lane; just past
        # one warp a read (2 warps); past two warp segments (3 warps; reads
        # are padded to 8 columns); the full form in one window
        return example, seqs[:6], int(name[2:]), (None,)
    if name == "forced":   # several warps a read, the full form in one window
        return example, seqs[:6], None, (None, Plan(2, 5, False), Plan(3, 3, False),
                                         Plan(16, 9, True))
    if name == "fan40":   # a start row of 40 predecessor slots
        gf = fuzz.fan_gfa(40)
        rng = random.Random(40)
        return PoaGraph.from_gfa(gf), [fuzz.random_read(rng, gf) for _ in range(4)], None, (
            None, Plan(2, 5, False), Plan(16, 9, True))
    # long5k: a 4,900-bp read on the long corpus' graph, the full form in
    # two windows (with a 2,440-bp read beside it)
    from make_synthetic import make

    with contextlib.redirect_stdout(io.StringIO()):
        make(str(tmp_path), n_back=1200, n_reads=1, seed=11)
    gfa_path = str(tmp_path / "graph.gfa")
    r = _long_reads(gfa_path, 2, 11)
    return PoaGraph.from_gfa(gfa.parse_gfa(gfa_path)), [r[0] + r[1][1:], r[1]], None, (None,)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bp1", "lp151", "lp161", "lp225", "lp321", "forced", "fan40",
                                  "long5k"])
def test_gap_local_kernel_at_layout_edges(cuda, tmp_path, name):
    """K5 at the edges of its layout, every output equal to the plain fill
    for both signs of the gap open and both tables: 1-bp reads; widths of
    151 (no 16-byte stores), 168 (7 columns a lane), 232 (just past one
    warp a read) and 328 (past two warp segments); 2 and 3 warps a read
    and the full form forced on the example reads (start rows
    whose predecessors lie up to 218 rows back); a start row of 40
    predecessor slots; a 4,900-bp read (the full form in two windows)."""
    g, reads, pad_to, layouts = _gap_local_edge(name, tmp_path)
    dg = poa_device_graph(g, cuda)
    seq, L = encode_reads(reads, pad_to=pad_to, device=cuda)
    if name == "lp151":
        seq = seq[:, :151].contiguous()
    for matrix, (o, e) in (("none", (-4, -2)), ("none", (1, -2)), ("HOXD70", (-4, -2))):
        if name == "long5k" and matrix == "HOXD70":
            continue
        table = torch.as_tensor(ScoreMatrix.create(matrix, 2, -4).table,
                                dtype=torch.int32).to(cuda)
        ref = poa_gap_engine.fill_gap_local_plain(dg, table, seq, L, o, e)
        for layout in layouts:
            _assert_equal(cuda_poa_gap_local.fill_gap_local_cuda(dg, table, seq, L, o, e, layout),
                          ref, ("K5", name, matrix, o, e, layout))


WARP_EDGES = ["bp1", "lp151", "lp224", "lp225", "lp321", "lp3585", "forced", "fan40", "long5k"]


def _edge_inputs(name, tmp_path, device):
    g, reads, pad_to, layouts = _gap_local_edge(name, tmp_path)
    dg = poa_device_graph(g, device)
    seq, L = encode_reads(reads, pad_to=pad_to, device=device)
    if name == "lp151":
        seq = seq[:, :151].contiguous()
    bta = encode_read_aux([k % 3 if k % 2 else int(1 + 0.01 * len(s))
                           for k, s in enumerate(reads)], device)
    return dg, seq, L, bta, layouts


@pytest.mark.cuda
@pytest.mark.parametrize("name", WARP_EDGES)
def test_gap_global_kernel_at_layout_edges(cuda, tmp_path, name):
    """K4 at the edges of its layout (K5's cases; widths of 224, one warp
    of 7 columns a lane, and 3,585, the full form in one window), every
    output equal to the plain fill: both signs of the gap open, both
    tables, bands from column 0 (band slack 0-2 beside the CLI's), and a
    gap open just past the prefix-max chain's range (the clamped chain)."""
    dg, seq, L, bta, layouts = _edge_inputs(name, tmp_path, cuda)
    n, Lp = dg.n, seq.shape[1]
    oc = -((1 << 26) // (2 * n + 2 * Lp + 2)) - 1
    assert not cuda_poa_gap_global.check_chain_range(oc, -1, n, Lp)
    assert cuda_poa_gap_global.check_chain_range(oc + 3, -1, n, Lp)
    for matrix, (o, e) in (("none", (-4, -2)), ("none", (1, -2)), ("HOXD70", (-4, -2)),
                           ("none", (oc, -1))):
        if name == "long5k" and matrix == "HOXD70":
            continue
        table = torch.as_tensor(ScoreMatrix.create(matrix, 2, -4).table,
                                dtype=torch.int32).to(cuda)
        ref = poa_gap_engine.fill_gap_global_plain(dg, table, seq, L, bta, o, e)
        for layout in layouts:
            _assert_equal(cuda_poa_gap_global.fill_gap_global_cuda(dg, table, seq, L, bta, o, e,
                                                                   layout),
                          ref, ("K4", name, matrix, o, e, layout))


@pytest.mark.cuda
@pytest.mark.parametrize("name", WARP_EDGES)
def test_local_kernel_at_layout_edges(cuda, tmp_path, name):
    """K2 at the edges of its layout (K5's and K4's cases), all four
    outputs equal to the plain fill, with both tables."""
    dg, seq, L, _, layouts = _edge_inputs(name, tmp_path, cuda)
    for matrix in ("none", "HOXD70"):
        table = torch.as_tensor(ScoreMatrix.create(matrix, 2, -4).table,
                                dtype=torch.int32).to(cuda)
        ref = poa_engine.fill_local_plain(dg, table, seq, L)
        for layout in layouts:
            _assert_equal(cuda_poa_local.fill_local_cuda(dg, table, seq, L, layout), ref,
                          ("K2", name, matrix, layout))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lp32"] + WARP_EDGES)
def test_global_kernel_at_layout_edges(cuda, tmp_path, name):
    """K1 at the edges of its layout (K4's cases, and reads of 32 columns),
    all six outputs equal to the plain fill, with both tables: 1, 32, 151,
    224 and 225 columns, several warps and the full form forced, 40
    predecessor slots, 3,585 columns and a 4,900-bp read (the full form in
    one window and in two)."""
    dg, seq, L, bta, layouts = _edge_inputs(name, tmp_path, cuda)
    for matrix in ("none", "HOXD70"):
        if name == "long5k" and matrix == "HOXD70":
            continue
        table = torch.as_tensor(ScoreMatrix.create(matrix, 2, -4).table,
                                dtype=torch.int32).to(cuda)
        ref = poa_engine.fill_global_plain(dg, table, seq, L, bta)
        for layout in layouts:
            _assert_equal(cuda_poa_global.fill_global_cuda(dg, table, seq, L, bta, layout), ref,
                          ("K1", name, matrix, layout))


def _asymmetric_table(device):
    """The plain table with sm('-', x) != sm(x, '-') for every base x."""
    tab = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table, dtype=torch.int32).clone()
    gap = poa_engine.GAP
    tab[gap, :4] = torch.tensor([-3, -5, -2, -6], dtype=torch.int32)
    tab[:4, gap] = torch.tensor([-4, -1, -7, -3], dtype=torch.int32)
    return tab.to(device)


@pytest.mark.cuda
def test_global_kernel_base_case_and_asymmetric_table(cuda):
    """K1 with bands from column 0 on every row of a read (band slack
    1,000) on graphs whose start rows' min_pred is not their row i-1 (the
    base case reads that row's m at its band start from device memory),
    with a table whose gap row and gap column differ (row 0's gap sums are
    its own), at the wrapper's layout and forced ones."""
    Plan = cuda_poa_gap_local.Plan
    rng = random.Random(77)
    gf = fuzz.random_gfa(rng, n_nodes=24, n_paths=4, cover_all=True)
    seqs = fasta.get_sequences(EXAMPLE[0])[0]
    for g, reads in ((PoaGraph.from_gfa(gf), [fuzz.random_read(rng, gf) for _ in range(6)]),
                     (PoaGraph.from_gfa(gfa.parse_gfa(EXAMPLE[1])), seqs[:6])):
        dg = poa_device_graph(g, cuda)
        minp = dg.host()["min_pred"]
        assert any(int(minp[i]) != i - 1 for i in range(1, dg.n - 1))
        seq, L = encode_reads(reads, device=cuda)
        bta = encode_read_aux([1000, 0, 1, 2, 5, 1000], cuda)
        for table in (_asymmetric_table(cuda),
                      torch.as_tensor(ScoreMatrix.create("HOXD70", 2, -4).table).to(cuda)):
            ref = poa_engine.fill_global_plain(dg, table, seq, L, bta)
            assert (ref[4][0] == 0).all()
            for layout in (None, Plan(2, 5, False), Plan(16, 9, True)):
                _assert_equal(cuda_poa_global.fill_global_cuda(dg, table, seq, L, bta, layout),
                              ref, ("K1", g.n, layout))


def _win_shift_cases(device):
    """K6's window cases: a two-arm bubble of 600-bp arms (the window jumps
    back by more than W at the second arm's first row; band slack 400
    overflows) and a random graph (windows move by +8 and -8)."""
    bubble = fuzz.bubble_gfa(600, 40, seed=3)
    rng = random.Random(5)
    cases = [(PoaGraph.from_gfa(bubble), [fuzz.random_read(rng, bubble) for _ in range(3)],
              [1, 2, 400])]
    rng = random.Random(54)
    gf = fuzz.random_gfa(rng, n_nodes=20, n_paths=6, cover_all=True)
    reads = [fuzz.random_read(rng, gf) for _ in range(4)]
    cases.append((PoaGraph.from_gfa(gf), reads, [1, 3, 9, 20]))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("W", [256, 512])
def test_gap_global_win_kernel_window_shifts(cuda, W):
    """K6 at W 256 and 512, all ten outputs (``over`` and ``wss``
    included) equal to the plain windowed fill: windows that move by 0, +8
    and -8 and back by W or more, a read that overflows its window, both
    signs of the gap open, a gap open past the prefix-max chain's range
    (the clamped chain), at the wrapper's layout and forced ones."""
    Plan = cuda_poa_gap_local.Plan
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table, dtype=torch.int32).to(cuda)
    forced = (None, Plan(3, 3, False) if W == 256 else Plan(3, 7, False), Plan(16, 9, True))
    shifts = set()
    for g, reads, btas in _win_shift_cases(cuda):
        dg = poa_device_graph(g, cuda)
        seq, L = encode_reads(reads, device=cuda)
        bta = encode_read_aux(btas, cuda)
        n, Lp = dg.n, seq.shape[1]
        oc = -((1 << 26) // (2 * n + 2 * Lp + 2)) - 1
        assert not cuda_poa_gap_global.check_chain_range(oc, -1, n, Lp)
        for o, e in ((-4, -2), (1, -2), (oc, -1)):
            ref = poa_gap_engine.fill_gap_global_windowed_plain(dg, table, seq, L, bta, o, e, W)
            ws = ref[8][:, :-1]
            d = (ws[:, 1:] - ws[:, :-1]).flatten().tolist()
            shifts |= {k for k, hit in (("0", 0 in d), ("+8", 8 in d), ("-8", -8 in d),
                                        ("-W", min(d) <= -W), ("over", bool(ref[9].any())))
                       if hit}
            for layout in forced:
                _assert_equal(cuda_poa_gap_global_win.fill_gap_global_win_cuda(
                    dg, table, seq, L, bta, o, e, W, layout), ref, ("K6", n, W, o, e, layout))
    assert shifts == {"0", "+8", "-8", "-W", "over"}


# K3's forced layouts at each window width: one warp at 1, 3, 5 and 7
# columns a lane where the width allows it, several warps, the full form
_WIN_LAYOUTS = {
    32: ((1, 1, False), (2, 1, False), (16, 9, True)),
    96: ((1, 3, False), (3, 1, False)),
    160: ((1, 5, False), (2, 3, False)),
    224: ((1, 7, False), (2, 5, False)),
    256: ((3, 3, False), (16, 9, True)),
    512: ((3, 7, False), (16, 9, True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("W", sorted(_WIN_LAYOUTS))
def test_global_win_kernel_layouts_and_window_shifts(cuda, W):
    """K3 at W 32-512 under the wrapper's layout and forced ones (one warp
    at 1, 3, 5 and 7 columns a lane, several warps, the full form), all
    eight outputs (``wss`` and ``over`` included) equal to the plain
    windowed fill: windows that move by 0, +8 and -8 and back by W or
    more, reads that overflow their window, windows past the read's end,
    both tables and one whose gap row and gap column differ (row 0's G)."""
    layouts = (None, *(cuda_poa_gap_local.Plan(*p) for p in _WIN_LAYOUTS[W]))
    tables = (torch.as_tensor(ScoreMatrix.create("none", 2, -4).table).to(cuda),
              torch.as_tensor(ScoreMatrix.create("HOXD70", 2, -4).table).to(cuda),
              _asymmetric_table(cuda))
    shifts = set()
    for g, reads, btas in _win_shift_cases(cuda):
        dg = poa_device_graph(g, cuda)
        seq, L = encode_reads(reads, device=cuda)
        bta = encode_read_aux(btas, cuda)
        for t, table in enumerate(tables):
            ref = poa_engine.fill_global_windowed_plain(dg, table, seq, L, bta, W)
            ws = ref[6][:, :-1]
            d = (ws[:, 1:] - ws[:, :-1]).flatten().tolist()
            shifts |= {k for k, hit in (("0", 0 in d), ("+8", 8 in d), ("-8", -8 in d),
                                        ("-W", min(d) <= -W), ("over", bool(ref[7].any())))
                       if hit}
            for layout in layouts:
                _assert_equal(cuda_poa_global_win.fill_global_win_cuda(
                    dg, table, seq, L, bta, W, layout), ref, ("K3", dg.n, W, t, layout))
    assert shifts == {"0", "+8", "-8", "-W", "over"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lp151", "forced", "fan40"])
def test_global_v1_kernel_at_layout_edges(cuda, tmp_path, name):
    """K14 at K1's layout edges, every lane of packed [n, B, Lp + 8] equal
    to the plain layout (the band in lanes Lp and Lp + 1, zero lanes Lp + 2
    .. Lp + 7 and row n - 1 included), with both tables: a width of 151
    (Lp + 8 not a multiple of 4: 4-byte stores) and of 152 (16-byte
    stores), several warps and the full form forced, 40 predecessor slots."""
    Plan = cuda_poa_gap_local.Plan
    dg, seq, L, bta, layouts = _edge_inputs(name, tmp_path, cuda)
    Lp = seq.shape[1]
    assert (Lp % 4 != 0) == (name == "lp151")
    layouts = dict.fromkeys((*layouts, Plan(2, 5, False), Plan(16, 9, True)))
    for matrix in ("none", "HOXD70"):
        table = torch.as_tensor(ScoreMatrix.create(matrix, 2, -4).table,
                                dtype=torch.int32).to(cuda)
        ref = pv.fill_global_v1_plain(dg, table, seq, L, bta)
        assert (ref[3][:, :, Lp + 2:] == 0).all() and (ref[3][-1] == 0).all()
        for layout in layouts:
            _assert_equal(cv.fill_global_v1_cuda(dg, table, seq, L, bta, layout), ref,
                          ("K14", name, matrix, layout))


@pytest.mark.cuda
def test_gap_local_clamped_chain_past_range(cuda, tmp_path):
    """K5 past the prefix-max chain's range, (|o| + |e|) x Lp >= 2^27: the
    wrapper takes the clamped chain, bit for bit the plain fill (the
    reference's map scan), at the CLI's -O 100000 -E 1 on reads past
    1,342 bp (several warps a read, and the full form), at
    (o, e) = (-2^20, 0) on the example reads (one warp a read), and at
    e = -2^22, where the reference's scan clamps; the dispatcher takes
    it too.  Then the CLI's -m 3 -O 100000 -E 1 on such reads on the card
    equals the CPU run."""
    Plan = cuda_poa_gap_local.Plan
    rng = random.Random(1342)
    longs = ["$" + "".join(rng.choice("ACGT") for _ in range(k)) for k in (1400, 1350)]
    g = PoaGraph.from_gfa(gfa.parse_gfa(EXAMPLE[1]))
    dg = poa_device_graph(g, cuda)
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table, dtype=torch.int32).to(cuda)
    short = fasta.get_sequences(EXAMPLE[0])[0][:6]
    for reads, (o, e), layouts in ((longs, (-100000, -1), (None, Plan(16, 9, True))),
                                   (short, (-(1 << 20), 0), (None, Plan(2, 5, False))),
                                   (short, (-5, -(1 << 22)), (None,))):
        seq, L = encode_reads(reads, device=cuda)
        assert not cuda_poa_gap_local.check_chain_range(o, e, seq.shape[1])
        ref = poa_gap_engine.fill_gap_local_plain(dg, table, seq, L, o, e)
        _assert_equal(poa_gap_engine.fill_gap_local_best(dg, table, seq, L, o, e), ref,
                      ("K5 dispatch", o, e))
        for layout in layouts:
            _assert_equal(cuda_poa_gap_local.fill_gap_local_cuda(dg, table, seq, L, o, e, layout),
                          ref, ("K5 clamped", o, e, layout))
    fa = tmp_path / "long.fa"
    fa.write_text("".join(f">r{k}\n{s[1:]}\n" for k, s in enumerate(longs)))
    out = {}
    for device in ("cpu", "cuda"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            run(Options(str(fa), EXAMPLE[1], alignment_mode=3, gap_open=100000,
                        gap_extension=1, device=device))
        out[device] = buf.getvalue()
    assert out["cuda"] == out["cpu"] and len(out["cpu"].splitlines()) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["long8", "example", "fan40"])
def test_pathwise_win_kernel_at_layout_edges(cuda, tmp_path, name):
    """K10 at the edges of its layout, all three outputs equal to the
    plain fill: 8 long reads (rows of 2 groups) and a read shorter than
    the window at W = 32 (the exit bound of reads that fail the guard)
    and 1,024; the example graph (rows of up to
    9 groups) at W = 64 and W = 34 (not a multiple of 4: no 16-byte
    stores); a 41,000-bp read on a row of 40 groups at W = 1,024 (the
    per-read scratch in device memory)."""
    if name == "long8":
        from make_synthetic import make

        with contextlib.redirect_stdout(io.StringIO()):
            make(str(tmp_path), n_back=1200, n_reads=1, seed=11)
        gfa_path = str(tmp_path / "graph.gfa")
        g = PathGraph.from_gfa(gfa.parse_gfa(gfa_path))
        reads, widths = _long_reads(gfa_path, 8, 11) + ["$" + "ACGT" * 5], (32, 1024)
    elif name == "example":
        g = PathGraph.from_gfa(gfa.parse_gfa(EXAMPLE[1]))
        reads, widths = fasta.get_sequences(EXAMPLE[0])[0][:8], (64, 34)
    else:
        g = PathGraph.from_gfa(fuzz.fan_gfa(40))
        reads = ["$" + "".join(random.Random(5).choice("ACGT") for _ in range(41000))]
        widths = (1024,)
    dg = path_device_graph(g, cuda)
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table, dtype=torch.int32).to(cuda)
    seq, L = encode_reads(reads, device=cuda)
    rmin = pathwise_window.rmin_tensor(dg)
    for W in widths:
        ref = pathwise_window.fill_pathwise_win_plain(dg, table, seq, L, W, rmin)
        _assert_equal(cuda_pathwise_win.fill_pathwise_win_cuda(dg, table, seq, L, W, rmin), ref,
                      ("K10", name, W))


@pytest.mark.cuda
def test_pathwise_dispatch_launches_kernels_and_counts(cuda):
    seqs, _ = fasta.get_sequences(EXAMPLE[0])
    g = PathGraph.from_gfa(gfa.parse_gfa(EXAMPLE[1]))
    dg = path_device_graph(g, cuda)
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table).to(cuda)
    seq, L = encode_reads(seqs[:4], device=cuda)
    rmin = pathwise_window.rmin_tensor(dg)
    metrics.reset_phases()
    pathwise_engine.fill_pathwise_best(dg, table, seq, False)
    pathwise_engine.fill_pathwise_best(dg, table, seq, True)
    pathwise_window.fill_pathwise_win_best(dg, table, seq, L, 64, rmin)
    B, Lp = seq.shape
    P = g.paths_number
    assert metrics.LAUNCHES == {cuda_pathwise.KERNEL: 2, cuda_pathwise_win.KERNEL: 1}
    assert metrics.SHAPES == {(cuda_pathwise.KERNEL, B, g.n, Lp, Lp, P): 2,
                              (cuda_pathwise_win.KERNEL, B, g.n, Lp, 64, P): 1}
    with pytest.raises(ValueError, match="int32"):
        cuda_pathwise.fill_pathwise_cuda(dg, table, seq.long(), False)
    with pytest.raises(ValueError, match="window width"):
        cuda_pathwise_win.fill_pathwise_win_cuda(dg, table, seq, L, 4, rmin)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [4, 5])
def test_cuda_pipeline_matches_cpu_pathwise(cuda, tmp_path, mode):
    """Modes 4/5 through the whole pipeline on the card equal the CPU run
    (which the CPU tests hold against the JAX pipeline and the goldens)."""
    seqs, names = fasta.get_sequences(EXAMPLE[0])
    reads = tmp_path / "reads.fa"
    reads.write_text("".join(f">{n}\n{s[1:]}\n" for n, s in zip(names[:12], seqs[:12])))
    out = {}
    for device in ("cpu", "cuda"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            run(Options(str(reads), EXAMPLE[1], alignment_mode=mode, device=device))
        out[device] = buf.getvalue()
    assert out["cuda"] == out["cpu"] and len(out["cpu"].splitlines()) == 12


def _rev_pair(g, reads, matrix, device, pad_to=None):
    """(reverse device graph, table, seq, L) of one K8 case."""
    dgr = rev_device_graph(g.reverse(), device)
    table = torch.as_tensor(ScoreMatrix.create(matrix, 2, -4).table).to(device)
    seq, L = encode_reads(reads, pad_to=pad_to, device=device)
    return dgr, table, seq, L


def _assert_rev_kernel(g, reads, matrix, device, what, pad_to=None):
    dgr, table, seq, L = _rev_pair(g, reads, matrix, device, pad_to)
    for mode8 in (True, False):
        _assert_equal(cuda_pathwise_rev.fill_pathwise_rev_cuda(dgr, table, seq, L, mode8),
                      recombination_engine.fill_pathwise_rev_plain(dgr, table, seq, L, mode8),
                      (what, mode8))


@pytest.mark.cuda
def test_pathwise_rev_kernel_matches_plain_random(cuda):
    """K8 on random DAGs (1-9 paths), both modes, both tables, with reads
    up to 2,100 columns (three column tiles) and a one-base read."""
    for seed in range(8):
        rng = random.Random(700 + seed)
        gf = fuzz.random_gfa(rng, n_nodes=6 + 4 * seed, n_paths=1 + seed, cover_all=True)
        reads = [fuzz.random_read(rng, gf) for _ in range(5)] + ["$A", "$" + "ACGT" * 40]
        if seed % 3 == 0:
            reads.append("$" + "".join(rng.choice("ACGT") for _ in range(2100)))
        _assert_rev_kernel(PathGraph.from_gfa(gf), reads, "HOXD70" if seed % 2 else "none",
                           cuda, seed)


@pytest.mark.cuda
def test_pathwise_rev_kernel_matches_plain_leak_graphs(cuda):
    """K8 on the fragment graphs whose reverse graphs have the
    reference's delta-leak rows (clone rows and ghost-alpha rows with
    constant-0 lanes), which the TPU kernel declined."""
    for seed in fuzz.LEAK_SEEDS:
        gf = fuzz.fragment_gfa(seed)
        reads = fuzz.fragment_reads(random.Random(seed * 31 + 5), gf, k=4)
        _assert_rev_kernel(PathGraph.from_gfa(gf), reads, "none", cuda, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("corpus", ["example", "p126"])
def test_pathwise_rev_kernel_matches_plain_corpora(cuda, tmp_path, corpus):
    """K8 on the example graph (23 paths, up to 9 groups a row), with
    HOXD70 too, and on a 126-path graph, where the JAX dispatch takes
    K9b."""
    if corpus == "example":
        reads_fa, gfa_path = EXAMPLE
    else:
        from make_synthetic import make

        with contextlib.redirect_stdout(io.StringIO()):
            make(str(tmp_path), n_back=80, n_reads=8, seed=7, n_paths=126)
        reads_fa, gfa_path = str(tmp_path / "reads.fa"), str(tmp_path / "graph.gfa")
    g = PathGraph.from_gfa(gfa.parse_gfa(gfa_path))
    reads = fasta.get_sequences(reads_fa)[0][:8]
    for matrix in ("none", "HOXD70") if corpus == "example" else ("none",):
        _assert_rev_kernel(g, reads, matrix, cuda, (corpus, matrix), pad_to=256)


def _rev_win_cases(name, tmp_path):
    """S2's cases on one graph family: (graph, reads, matrix, widths)."""
    cases = []
    if name == "long8":
        from make_synthetic import make

        with contextlib.redirect_stdout(io.StringIO()):
            make(str(tmp_path), n_back=1200, n_reads=1, seed=11)
        gfa_path = str(tmp_path / "graph.gfa")
        reads = _long_reads(gfa_path, 8, 11) + ["$" + "ACGT" * 5]
        cases = [(PathGraph.from_gfa(gfa.parse_gfa(gfa_path)), reads, "none", (32, 256, 1024))]
    elif name == "example":
        g = PathGraph.from_gfa(gfa.parse_gfa(EXAMPLE[1]))
        reads = fasta.get_sequences(EXAMPLE[0])[0][:8]
        cases = [(g, reads, "none", (34, 64)), (g, reads, "HOXD70", (64,))]
    elif name == "fan40":
        reads = ["$" + "".join(random.Random(5).choice("ACGT") for _ in range(41000))]
        cases = [(PathGraph.from_gfa(fuzz.fan_gfa(40)), reads, "none", (1024,))]
    else:
        for seed in fuzz.LEAK_SEEDS:
            gf = fuzz.fragment_gfa(seed)
            reads = fuzz.fragment_reads(random.Random(seed * 31 + 5), gf, k=4)
            cases.append((PathGraph.from_gfa(gf), reads, "none", (8,)))
    return cases


@pytest.mark.cuda
def test_pathwise_rev_win_kernel_matches_plain(cuda, tmp_path):
    """S2 (the reverse form of K10's kernel) against its plain version,
    all three outputs: 8 long reads and a read shorter than the window at
    W 32, 256 and 1,024 (windows that move, the exit account of reads
    that strand cells); the example graph (rows of up to 9 groups) at W 34
    (no 16-byte stores) and 64, and with HOXD70; a 41,000-bp read at
    W 1,024 (the per-read scratch in device memory); the fragment graphs
    whose reverse graphs have clone rows and constant-0 lanes at W 8.
    Then the dispatcher's launch count and shape, and its refusals.  One
    item for the four graph families, as it skips without a card."""
    for name in ("long8", "example", "fan40", "leak"):
        for g, reads, matrix, widths in _rev_win_cases(name, tmp_path):
            dgr, table, seq, L = _rev_pair(g, reads, matrix, cuda)
            table = table.to(torch.int32)
            for W in widths:
                ref = recombination_window.fill_pathwise_rev_win_plain(dgr, table, seq, L, W)
                metrics.reset_phases()
                got = recombination_window.fill_pathwise_rev_win_best(dgr, table, seq, L, W)
                _assert_equal(got, ref, ("S2", name, matrix, W))
                B, Lp = seq.shape
                assert metrics.SHAPES == {(cuda_pathwise_rev_win.KERNEL, B, g.n, Lp, W,
                                           g.paths_number): 1}
        with pytest.raises(ValueError, match="window width"):
            cuda_pathwise_rev_win.fill_pathwise_rev_win_cuda(dgr, table, seq, L, 4)
        with pytest.raises(ValueError, match="reverse graph"):
            cuda_pathwise_rev_win.fill_pathwise_rev_win_cuda(path_device_graph(g, cuda), table,
                                                             seq, L, 8)


@pytest.mark.cuda
def test_split_summary_kernel_matches_plain(cuda):
    """S1 against the plain column summary, bit for bit, on every
    interior column of 6 example reads in modes 8 and 9: at the CLI's
    costs (r = 0.1, where an FMA would round differently), with R = r = 0
    (many ties) and on columns where no pair is valid."""
    seqs, _ = fasta.get_sequences(EXAMPLE[0])
    g = PathGraph.from_gfa(gfa.parse_gfa(EXAMPLE[1]))
    rg = g.reverse()
    dg, dgr = path_device_graph(g, cuda), rev_device_graph(rg, cuda)
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table).to(cuda)
    seq, L = encode_reads(seqs[:6], device=cuda)
    geom = recombination_engine._SplitGeometry(g, rg)
    geom_t = geom.tensors(cuda)
    B, Lp = seq.shape
    bidx = torch.arange(B, dtype=torch.int32, device=cuda).repeat_interleave(Lp - 2)
    cols = torch.arange(1, Lp - 1, dtype=torch.int32, device=cuda).repeat(B)
    for mode in (8, 9):
        Af = pathwise_engine.fill_pathwise_best(dg, table, seq, mode == 9)
        Ar = recombination_engine.fill_pathwise_rev_best(dgr, table, seq, L, mode == 8)
        inputs = recombination_engine.split_inputs(Af, Ar, dg.paths_on)
        # a read whose reverse summaries are all off-path: no valid pair
        dead = list(inputs)
        dead[5] = torch.zeros_like(dead[5])
        for R, r, ins in ((4, 0.1, inputs), (0, 0.0, inputs), (10, 2.0, inputs),
                          (4, 0.1, tuple(dead))):
            got = cuda_split_summary.col_summary_cuda(*ins, geom_t, R, r, bidx, cols)
            ref = recombination_engine.col_summary_plain(*ins, geom_t, R, r, bidx, cols)
            _assert_equal(got, ref, (mode, R, r))
            assert bool((got[0] == recombination_engine.NEGF).all()) == (ins is not inputs)


# (R, r, band width) of the split search: the CLI's, -R 10 -r 2 -B 0.5, ties
SPLIT_COSTS = {"default": (4, 0.1, 1.0), "R10_r2_B05": (10, 2.0, 0.5), "ties": (0, 0.0, 1.0)}


def _guided_vs_plain(g, rg, reads, mode, device, costs, dead=False, runs=((1, None), (4, None),
                                                                          (None, None))):
    """S1's guided entry against ``_run_split_guided`` on the same card
    inputs (K7/K8 planes of ``reads``), after its bound entry against
    ``_column_ub`` bit for bit: the seven outputs bit for bit at each
    (blocks a read, reverse tile) of ``runs``, and the invariant
    (every column with ub + 0.5 >= the read's final threshold was
    evaluated).  Returns the plain search's outputs."""
    dg, dgr = path_device_graph(g, device), rev_device_graph(rg, device)
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table).to(device)
    seq, L = encode_reads(reads, device=device)
    Af = pathwise_engine.fill_pathwise_best(dg, table, seq, mode == 9)
    Ar = recombination_engine.fill_pathwise_rev_best(dgr, table, seq, L, mode == 8)
    finalcol = pathwise_engine._final_column(Af, L).cpu().numpy()
    init_best, _ = recombination_engine._baseline(mode, finalcol, g)
    inputs = list(recombination_engine.split_inputs(Af, Ar, dg.paths_on))
    del Af, Ar
    if dead:   # no reverse summary on its path: no valid pair anywhere
        inputs[5] = torch.zeros_like(inputs[5])
    R, r, rbw = costs
    Lnp = L.cpu().numpy()
    oob = np.maximum((Lnp * (1.0 - rbw) / 2.0).astype(np.int64), 1)
    jcol = np.arange(seq.shape[1])
    active = (jcol[None, :] >= oob[:, None]) & (jcol[None, :] < (Lnp - oob)[:, None])
    geom = recombination_engine._SplitGeometry(g, rg)
    geom_t = geom.tensors(device)
    ref = recombination_engine._run_split_guided(inputs, geom, geom_t, active, init_best, R, r)
    ub = recombination_engine._split_ub(inputs, geom, r)   # S1's bound entry
    wf, wr = (torch.from_numpy(w).to(device)
              for w in recombination_engine._sign_weights(geom, r))
    ref_ub = recombination_engine._column_ub(inputs[0], inputs[2], inputs[3], inputs[5], wf, wr)
    assert ub.dtype == ref_ub.dtype and ub.cpu().numpy().tobytes() == ref_ub.cpu().numpy().tobytes()
    for blocks, rtile in runs:
        out, st = cuda_split_summary.split_guided_cuda(
            inputs, geom_t, ub, torch.from_numpy(active).to(device),
            torch.from_numpy(init_best.astype(np.float32)).to(device), R, r, blocks=blocks,
            rtile=rtile, with_state=True)
        got = recombination_engine.unpack_split(out.cpu().numpy())
        for k, (a, b) in enumerate(zip(got, ref)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (mode, costs, blocks, k)
        bad = recombination_engine.split_unevaluated(
            st["ub"].cpu().numpy(), st["done"].cpu().numpy(), st["col_max"].cpu().numpy(),
            init_best)
        assert not bad.any(), (mode, costs, blocks, bad)
    return ref


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [8, 9])
def test_split_guided_matches_plain_search(cuda, mode):
    """The guided entry on 6 example reads (every one splits in mode 8,
    two in mode 9) with the three cost sets, at 1 and 4 blocks a read,
    the wrapper's count and reverse rows in tiles of 512; on dead reverse
    summaries; and through the dispatcher, which launches the bound and
    guided entries once each, counts one round and its pairs on the
    device."""
    seqs, _ = fasta.get_sequences(EXAMPLE[0])
    g = PathGraph.from_gfa(gfa.parse_gfa(EXAMPLE[1]))
    rg = g.reverse()
    reads = seqs[:4] + [seqs[16], seqs[50]]
    refs = {name: _guided_vs_plain(g, rg, reads, mode, cuda, costs,
                                   runs=((1, None), (4, None), (None, None), (4, 512)))
            for name, costs in SPLIT_COSTS.items()}
    assert refs["default"][1].sum() == (6 if mode == 8 else 2)
    assert not _guided_vs_plain(g, rg, reads, mode, cuda, SPLIT_COSTS["default"], dead=True)[1].any()

    dg, dgr = path_device_graph(g, cuda), rev_device_graph(rg, cuda)
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table).to(cuda)
    seq, L = encode_reads(reads, device=cuda)
    inputs = recombination_engine.split_inputs(
        pathwise_engine.fill_pathwise_best(dg, table, seq, mode == 9),
        recombination_engine.fill_pathwise_rev_best(dgr, table, seq, L, mode == 8), dg.paths_on)
    geom = recombination_engine._SplitGeometry(g, rg)
    active = np.ones(tuple(seq.shape), bool)
    init_best = np.full(len(reads), -1e9, np.float32)
    ref = recombination_engine._run_split_guided(inputs, geom, geom.tensors(cuda), active,
                                                 init_best, 4, 0.1)
    metrics.reset_phases()
    got = recombination_engine.split_search_best(inputs, geom, geom.tensors(cuda), active,
                                                 init_best, 4, 0.1)
    assert all(a.dtype == b.dtype and a.tobytes() == b.tobytes() for a, b in zip(got, ref))
    assert metrics.LAUNCHES == {cuda_split_summary.BOUND: 1, cuda_split_summary.GUIDED: 1}
    metrics.flush_device_counters()
    assert metrics.EVENTS["split_rounds"] == 1 and metrics.EVENTS["split_pairs"] >= len(reads)
    with pytest.raises(ValueError, match="float32"):
        cuda_split_summary.split_guided_cuda(inputs, geom.tensors(cuda), inputs[0],
                                             torch.ones_like(inputs[2][:, 0]),
                                             torch.zeros(len(reads), device=cuda), 4, 0.1)


@pytest.mark.cuda
def test_split_guided_long_read(cuda, tmp_path):
    """The guided entry on one ~1.2 kb read of a long-read graph in
    modes 8 and 9 (hundreds of columns a read, many blocks a read)."""
    from make_synthetic import make

    with contextlib.redirect_stdout(io.StringIO()):
        make(str(tmp_path), n_back=600, n_reads=1, seed=11)
    gfa_path = str(tmp_path / "graph.gfa")
    g = PathGraph.from_gfa(gfa.parse_gfa(gfa_path))
    reads = _long_reads(gfa_path, 1, 7)
    for mode in (8, 9):
        _guided_vs_plain(g, g.reverse(), reads, mode, cuda, SPLIT_COSTS["default"],
                         runs=((1, None), (None, None), (None, 512)))


@pytest.mark.cuda
def test_split_search_past_46340_rows(cuda):
    """S1 on 46,400 interior rows, where the flat index i x I + k passes
    int32: the guided entry (1 and 4 blocks a read, the wrapper's count)
    and the bound entry against the plain search (``_run_split_guided``
    on the CPU, int64 flat indices) bit for bit, and the per-pair entry
    against ``col_summary_plain`` on every column.  Three reads of 24
    columns; each column's valid rows are a few dozen, the best ones
    past row 46,340."""
    from types import SimpleNamespace

    I, B, Lp = 46_400, 3, 24
    rng = np.random.default_rng(46341)
    geom = SimpleNamespace(dfs_i=np.sort(rng.integers(0, 5000, I)).astype(np.int64),
                           dfe_i=np.sort(rng.integers(0, 5000, I))[::-1].astype(np.int64),
                           ids_i=np.arange(I, dtype=np.int32), fw_edge=rng.random(I) < 0.3,
                           rv_edge=rng.random(I) < 0.3, paths=4)

    def side():
        mx = rng.integers(0, 200, (B, I, Lp)).astype(np.int32)
        mx[:, 46_341:] += 400   # the best candidates lie past row 46,340
        arg = rng.integers(0, 4, (B, I, Lp)).astype(np.int32)
        valid = np.zeros((B, I, Lp), bool)
        for b in range(B):
            for j in range(Lp):
                valid[b, rng.integers(0, I, 20), j] = True
                valid[b, rng.integers(46_341, I, 12), j] = True
        return mx, arg, valid

    host = tuple(torch.from_numpy(a) for a in (*side(), *side()))
    dev = tuple(t.to(cuda) for t in host)
    geom_h = recombination_engine._SplitGeometry.tensors(geom, "cpu")
    geom_d = recombination_engine._SplitGeometry.tensors(geom, cuda)
    active = np.ones((B, Lp), bool)
    init_best = np.full(B, -1e9, np.float32)
    ref = recombination_engine._run_split_guided(host, geom, geom_h, active, init_best, 4, 0.1)
    assert ref[1].all() and (ref[2].astype(np.int64) > 46_341).all()
    ub = recombination_engine._split_ub(dev, geom, 0.1)
    assert ub.cpu().numpy().tobytes() == recombination_engine._split_ub(
        host, geom, 0.1).numpy().tobytes()
    for blocks in (1, 4, None):
        out, st = cuda_split_summary.split_guided_cuda(
            dev, geom_d, ub, torch.from_numpy(active).to(cuda),
            torch.from_numpy(init_best).to(cuda), 4, 0.1, blocks=blocks, with_state=True)
        got = recombination_engine.unpack_split(out.cpu().numpy())
        for k, (a, b) in enumerate(zip(got, ref)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (blocks, k)
    bidx = torch.arange(B, dtype=torch.int32).repeat_interleave(Lp - 2)
    cols = torch.arange(1, Lp - 1, dtype=torch.int32).repeat(B)
    want = recombination_engine.col_summary_plain(*host, geom_h, 4, 0.1, bidx, cols)
    assert int(want[3].max()) >= 1 << 31   # past int32
    got = cuda_split_summary.col_summary_cuda(*dev, geom_d, 4, 0.1, bidx.to(cuda),
                                              cols.to(cuda))
    for k, (a, b) in enumerate(zip(got, want)):
        a = a.cpu()
        assert a.dtype == b.dtype and torch.equal(a, b), k


@pytest.mark.cuda
def test_rec_dispatch_launches_kernels_and_counts(cuda):
    seqs, _ = fasta.get_sequences(EXAMPLE[0])
    g = PathGraph.from_gfa(gfa.parse_gfa(EXAMPLE[1]))
    rg = g.reverse()
    dgr = rev_device_graph(rg, cuda)
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table).to(cuda)
    seq, L = encode_reads(seqs[:4], device=cuda)
    B, Lp = seq.shape
    metrics.reset_phases()
    Ar = recombination_engine.fill_pathwise_rev_best(dgr, table, seq, L, True)
    inputs = recombination_engine.split_inputs(Ar, Ar, dgr.paths_on)
    geom_t = recombination_engine._SplitGeometry(g, rg).tensors(cuda)
    pairs = torch.zeros(300, dtype=torch.int32, device=cuda)
    got = recombination_engine.col_summary_best(inputs, geom_t, 4, 0.1, pairs, pairs + 5)
    assert all(x.shape == (300,) for x in got)
    K = recombination_engine.PAIRS_PER_LAUNCH
    assert metrics.LAUNCHES == {cuda_pathwise_rev.KERNEL: 1, cuda_split_summary.KERNEL: 2}
    assert metrics.SHAPES == {(cuda_pathwise_rev.KERNEL, B, g.n, Lp, Lp, g.paths_number): 1,
                              (cuda_split_summary.KERNEL, B, g.n, Lp, K, g.paths_number): 2}
    with pytest.raises(ValueError, match="int32"):
        cuda_pathwise_rev.fill_pathwise_rev_cuda(dgr, table, seq.long(), L, True)
    with pytest.raises(ValueError, match="reverse graph"):
        cuda_pathwise_rev.fill_pathwise_rev_cuda(path_device_graph(g, cuda), table, seq, L,
                                                 True)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_split_summary.col_summary_cuda(*inputs, geom_t, 4, 0.1, pairs.long(), pairs)


@pytest.mark.cuda
def test_cuda_pipeline_matches_cpu_recombination(cuda, tmp_path):
    """Modes 8/9 through the whole pipeline on the card equal the CPU run
    (which the CPU tests hold against the JAX pipeline and the goldens),
    with the CLI's costs and with -R 10 -r 2 -B 0.5."""
    seqs, names = fasta.get_sequences(EXAMPLE[0])
    reads = tmp_path / "reads.fa"
    reads.write_text("".join(f">{n}\n{s[1:]}\n" for n, s in zip(names[:12], seqs[:12])))
    for cfg in (dict(alignment_mode=8), dict(alignment_mode=9),
                dict(alignment_mode=8, base_rec_cost=10, multi_rec_cost=2.0,
                     rec_band_width=0.5)):
        out = {}
        for device in ("cpu", "cuda"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
                run(Options(str(reads), EXAMPLE[1], device=device, **cfg))
            out[device] = buf.getvalue()
        assert out["cuda"] == out["cpu"] and len(out["cpu"].splitlines()) == 12, cfg


def _gap67_graph(name, tmp_path):
    """(PathGraph, reads) of a modes-6/7 kernel case."""
    if name == "example":
        g = PathGraph.from_gfa(gfa.parse_gfa(EXAMPLE[1]))
        return g, fasta.get_sequences(EXAMPLE[0])[0][:6]
    if name.startswith("random"):
        rng = random.Random(int(name[6:]))
        gf = fuzz.random_gfa(rng, n_nodes=16, n_paths=5, cover_all=True)
        return PathGraph.from_gfa(gf), [fuzz.random_read(rng, gf) for _ in range(6)]
    if name == "fan40":
        gf = fuzz.fan_gfa(40)
        rng = random.Random(40)
        return PathGraph.from_gfa(gf), [fuzz.random_read(rng, gf) for _ in range(4)]
    if name == "long41":   # 41,000 bp: the easy rows' selectors leave shared memory
        read = "$" + "".join(random.Random(5).choice("ACGT") for _ in range(41000))
        return PathGraph.from_gfa(fuzz.fan_gfa(40)), [read]
    from make_synthetic import make

    n_paths, n_back = {"p130": (130, 30), "tile": (6, 60), "tile3": (6, 60), "p32": (32, 30),
                       "p33": (33, 80), "p64": (64, 80)}[name]
    with contextlib.redirect_stdout(io.StringIO()):
        make(str(tmp_path), n_back=n_back, n_reads=2, seed=7, n_paths=n_paths)
    g = PathGraph.from_gfa(gfa.parse_gfa(str(tmp_path / "graph.gfa")))
    reads = fasta.get_sequences(str(tmp_path / "reads.fa"))[0]
    if name in ("tile", "tile3"):   # 1,100 bp: two 1,024-column tiles; 2,100 bp: three
        n_bp = 1100 if name == "tile" else 2100
        reads.append("$" + "".join(random.Random(5).choice("ACGT") for _ in range(n_bp)))
    return g, reads


@pytest.mark.cuda
@pytest.mark.parametrize("name,matrix,oe", [
    ("example", "none", (-4, -2)), ("example", "HOXD70", (-200, -2)),
    ("random31", "none", (-3, -1)), ("random32", "HOXD70", (-200, -2)),
    ("p130", "none", (-4, -2)), ("tile", "none", (-4, -2)),
    ("p32", "none", (-4, -2)), ("p33", "none", (-4, -2)), ("p64", "HOXD70", (-4, -2)),
    ("tile3", "none", (-4, -2)), ("fan40", "none", (-4, -2)), ("long41", "none", (-4, -2)),
])
def test_gap67_fill_kernel_matches_plain(cuda, tmp_path, name, matrix, oe):
    """K11 (with K12's column program in its hard rows) on every plane
    cell, both modes: the example graph (up to 9 blocks a row), HOXD70
    with o = -200 (past the TPU kernel's packed-chain gate), random
    covered DAGs, 130 paths (past its P <= 128 gate), reads of 1,100
    and 2,100 bp (two and three column tiles of the easy rows' scans),
    32, 33 and 64 paths (the chain warp alone, then one and 32 lanes
    that follow it), and a row of 40 hub lanes (the column program's
    shared-memory form), and a 41,000-bp read on that graph (the easy
    rows' selectors in the per-read scratch, not in shared memory)."""
    g, reads = _gap67_graph(name, tmp_path)
    table = torch.as_tensor(ScoreMatrix.create(matrix, 2, -4).table, dtype=torch.int32)
    tabs_c = pathwise_gap_engine.gap_tables(g, cuda)
    tabs_h = pathwise_gap_engine.gap_tables(g, "cpu")
    seq, _ = encode_reads(reads)
    for semi in (False, True):
        got = cuda_gap67_fill.fill_gap67_cuda(tabs_c, table.to(cuda), seq.to(cuda), *oe, semi)
        ref = pathwise_gap_engine.fill_gap_plain(tabs_h, table, seq, *oe, semi)
        _assert_equal(tuple(t.cpu() for t in got), ref, (name, semi))


@pytest.mark.cuda
def test_gap67_hardrow_kernel_matches_plain(cuda):
    """K12 through its own wrapper on the staged inputs of the example
    graph's hard rows, and the launch counters of K11 and K12."""
    g, reads = _gap67_graph("example", None)
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table, dtype=torch.int32)
    tabs = pathwise_gap_engine.gap_tables(g, "cpu")
    seq, _ = encode_reads(reads)
    Dm, X, Y = pathwise_gap_engine.fill_gap_plain(tabs, table, seq, -4, -2, False)
    m = tabs.meta
    metrics.reset_phases()
    hard = [i for i in range(1, m.n - 1) if not m.easy[i]]
    for i in hard:
        sub = table[int(m.codes[i])][seq.long()]
        U, Dc, Dfd, Ypre, _ = pathwise_gap_engine.stage_hard_row(tabs, Dm, Y, i, sub, -4, -2)
        (tb, nd, fire, isa, after), ai = pathwise_gap_engine.hard_row_scalars(tabs, i)
        lc = tabs.lanes[i][:, :, None].expand(-1, -1, seq.shape[0]).contiguous()
        args = (U, Dc, Dfd, Ypre, lc, X[i, :, :, 0].t().contiguous(), tb, nd, fire, isa, after)
        ref = pathwise_gap_engine.hard_cols_plain(*args, ai, -4, -2)
        got = cuda_gap67_hardrow.hard_cols_cuda(*(t.to(cuda) for t in args), ai, -4, -2)
        _assert_equal(tuple(t.cpu() for t in got), ref, i)
    assert metrics.LAUNCHES[cuda_gap67_hardrow.KERNEL] == len(hard)
    pathwise_gap_engine.fill_gap_device(g, ScoreMatrix.create("none", 2, -4), seq.to(cuda),
                                        -4, -2, True)
    assert metrics.LAUNCHES[cuda_gap67_fill.KERNEL] == 1
    metrics.flush_device_counters()
    assert metrics.EVENTS["gap67_hard_rows"] == len(hard) * seq.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["p64", "fan40"])
def test_gap67_hardrow_kernel_matches_plain_wide(cuda, tmp_path, name):
    """K12 through its own wrapper where lanes follow the chain warp (64
    paths) and past 32 hub lanes, on every hard row in both modes."""
    g, reads = _gap67_graph(name, tmp_path)
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table, dtype=torch.int32)
    tabs = pathwise_gap_engine.gap_tables(g, "cpu")
    seq, _ = encode_reads(reads)
    m = tabs.meta
    hard = [i for i in range(1, m.n - 1) if not m.easy[i]]
    assert hard
    for semi in (False, True):
        Dm, X, Y = pathwise_gap_engine.fill_gap_plain(tabs, table, seq, -4, -2, semi)
        for i in hard:
            sub = table[int(m.codes[i])][seq.long()]
            U, Dc, Dfd, Ypre, _ = pathwise_gap_engine.stage_hard_row(tabs, Dm, Y, i, sub, -4, -2)
            (tb, nd, fire, isa, after), ai = pathwise_gap_engine.hard_row_scalars(tabs, i)
            lc = tabs.lanes[i][:, :, None].expand(-1, -1, seq.shape[0]).contiguous()
            args = (U, Dc, Dfd, Ypre, lc, X[i, :, :, 0].t().contiguous(), tb, nd, fire, isa,
                    after)
            ref = pathwise_gap_engine.hard_cols_plain(*args, ai, -4, -2)
            got = cuda_gap67_hardrow.hard_cols_cuda(*(t.to(cuda) for t in args), ai, -4, -2)
            _assert_equal(tuple(t.cpu() for t in got), ref, (name, semi, i))


def _variant_pairs(dg, table, seq, L, bta, layout=None):
    """(name, kernel, plain, args) for K13-K17, at a forced ``layout`` if
    one is given; K15 at both element types where int16 holds the values."""
    loc = (dg, table, seq, L)
    lay = {} if layout is None else {"layout": layout}
    pairs = [("K13", functools.partial(cv.fill_local_v1_cuda, **lay), pv.fill_local_v1_plain,
              loc),
             ("K14", functools.partial(cv.fill_global_v1_cuda, **lay), pv.fill_global_v1_plain,
              (*loc, bta)),
             ("K15 int32", functools.partial(cv.fill_local_v2_cuda, **lay),
              pv.fill_local_v2_plain, loc),
             ("K16", functools.partial(cv.fill_local_scores_cuda, **lay),
              pv.fill_local_scores_plain, loc),
             ("K17", functools.partial(cv.fill_local_v4_cuda, **lay), pv.fill_local_v4_plain,
              loc)]
    try:
        cv.check_dtype(torch.int16, dg.n, table, seq.shape[1])
        pairs.append(("K15 int16", functools.partial(cv.fill_local_v2_cuda, **lay),
                      pv.fill_local_v2_plain, (*loc, torch.int16)))
    except ValueError:
        pass
    return pairs


def _assert_variants_match(g, reads, btas, sm, device, layouts=(None,), width=None):
    """K13-K17 equal their plain versions, and K16's walk equals walk_poa's
    over K2's packed planes; with ``layouts``, K13-K17 at each forced
    layout (``width``: the read width to cut the encoded reads to)."""
    dg = poa_device_graph(g, device)
    table = torch.as_tensor(sm.table, dtype=torch.int32).to(device)
    seq, L = encode_reads(reads, pad_to=width, device=device)
    if width is not None:
        seq = seq[:, :width].contiguous()
    bta = encode_read_aux(btas, device)
    refs = {}   # a kernel's plain result, shared by its layouts
    for layout in layouts:
        for name, kern, plain, args in _variant_pairs(dg, table, seq, L, bta, layout):
            if name not in refs:
                refs[name] = plain(*args)
            _assert_equal(kern(*args), refs[name], (name, layout))
    if layouts != (None,):
        return
    _, bi, bj, m = cv.fill_local_scores_cuda(dg, table, seq, L)
    packed = cuda_poa_local.fill_local_cuda(dg, table, seq, L)[3]
    W = tb.max_walk_steps(dg.n, seq.shape[1])
    walk = tb.walk_local_scores(m, seq, table, dg.node_start, dg.codes, dg.pred_idx, bi, bj, W)
    assert kernel_ab.walks_equal(walk, packed, bi, bj, W)


@pytest.mark.cuda
@pytest.mark.parametrize("matrix", ["none", "HOXD70"])
def test_variant_kernels_match_plain_example(cuda, matrix):
    seqs, _ = fasta.get_sequences(EXAMPLE[0])
    g = PoaGraph.from_gfa(gfa.parse_gfa(EXAMPLE[1]))
    reads = seqs[:16]
    btas = [int(1 + 0.01 * len(s)) if k % 3 else k % 4 for k, s in enumerate(reads)]
    _assert_variants_match(g, reads, btas, ScoreMatrix.create(matrix, 2, -4), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(8))
def test_variant_kernels_match_plain_random(cuda, seed):
    """Random DAGs, short and long reads (up to 1,100 columns, two column
    tiles), both scoring tables; K15 at int16 where the values fit."""
    rng = random.Random(2000 + seed)
    gf = fuzz.random_gfa(rng, n_nodes=8 + 3 * seed, n_paths=4, cover_all=True)
    g = PoaGraph.from_gfa(gf)
    reads = [fuzz.random_read(rng, gf) for _ in range(6)] + ["$A", "$" + "ACGT" * 40]
    if seed % 4 == 0:
        reads.append("$" + "".join(rng.choice("ACGT") for _ in range(1100)))
    btas = [rng.choice([0, 1, 2, 5, 1000]) for _ in reads]
    sm = ScoreMatrix.create("HOXD70" if seed % 3 == 0 else "none", 2, -4)
    _assert_variants_match(g, reads, btas, sm, cuda)


# K13, K15, K16 and K17 (and K14) at forced layouts of their kernels: the read width
# and the layouts (one warp at 1, 3, 5 and 7 columns a lane, several warps,
# the full form); widths of 151 and 156 take K15's int16 rows in 2-byte and
# 4-byte stores (16-byte ones where Lp % 8 == 0)
_VARIANT_LAYOUTS = {
    "cw1": (32, ((1, 1, False), (2, 1, False))),
    "cw3": (96, ((1, 3, False), (2, 3, False))),
    "cw5": (160, ((1, 5, False), (2, 5, False), (16, 9, True))),
    "cw7": (224, ((1, 7, False), (16, 9, True))),
    "lp151": (151, (None, (2, 5, False), (16, 9, True))),
    "lp156": (156, (None, (1, 5, False), (2, 5, False), (16, 9, True))),
}
# fuzz.random_gfa(random.Random(seed), n_nodes=60) -> n % 8: K15 zeroes 1,
# 8 and 2 rows past row n-2, K16 and K17 1, 0 and 2
_VARIANT_SEEDS = {0: 3008, 1: 3027, 7: 3000}


@pytest.mark.cuda
@pytest.mark.parametrize("rem", sorted(_VARIANT_SEEDS))
@pytest.mark.parametrize("name", sorted(_VARIANT_LAYOUTS))
def test_variant_kernels_at_layouts(cuda, name, rem):
    """K13, K15 (int32 and int16), K16 and K17 bit for bit their plain
    versions at forced layouts of K2's kernel, on random DAGs whose row
    count n has n % 8 of 0, 1 and 7 (K16 and K17 store n - 1 rows at 1),
    with reads that fill the width."""
    width, layouts = _VARIANT_LAYOUTS[name]
    rng = random.Random(_VARIANT_SEEDS[rem])
    gf = fuzz.random_gfa(rng, n_nodes=60, n_paths=4, cover_all=True)
    g = PoaGraph.from_gfa(gf)
    assert poa_device_graph(g, cuda).n % 8 == rem
    reads = [fuzz.random_read(rng, gf) for _ in range(5)] + ["$A"]
    reads += ["$" + "".join(rng.choice("ACGT") for _ in range(k)) for k in (width // 2, width)]
    reads = [r[:width] for r in reads]
    btas = [rng.choice([0, 1, 2, 5, 1000]) for _ in reads]
    sm = ScoreMatrix.create("none", 2, -4)
    _assert_variants_match(g, reads, btas, sm, cuda,
                           tuple(p and cuda_poa_gap_local.Plan(*p) for p in layouts), width)


@pytest.mark.cuda
def test_kernel_ab_runs_and_counts(cuda):
    """The A/B entry point holds every ported variant to its plain version
    and launches each kernel; int16 past its limits raises on the card."""
    metrics.reset_phases()
    assert kernel_ab.main(["16", "v1", "v2", "v3", "v4", "v5", "g1", "g2"]) == 0
    for k in (cv.LOCAL_V1, cv.GLOBAL_V1, cv.LOCAL_V2, cv.LOCAL_SCORES, cv.LOCAL_V4,
              cuda_poa_local, cuda_poa_global):
        assert metrics.LAUNCHES[k.KERNEL] == 5, k.KERNEL   # check, warm-up, three timed
    assert kernel_ab.main(["16", "v4r16"]) == 2
    dg = poa_device_graph(PoaGraph.from_gfa(gfa.parse_gfa(EXAMPLE[1])), cuda)
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table).to(cuda)
    seq, L = encode_reads(["$" + "A" * 2100], device=cuda)
    with pytest.raises(ValueError, match="int16"):
        cv.fill_local_v2_cuda(dg, table, seq, L, torch.int16)
