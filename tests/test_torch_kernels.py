"""The CUDA kernels K1-K6 against their plain torch versions, on the card.

Every test needs an NVIDIA GPU and skips without one.  The file imports
no JAX and nothing of the JAX package, and uses no conftest fixture, so
it runs on the GPU machine with

    python -m pytest tests/test_torch_kernels.py -q --noconftest

The tolerance is exact equality: every output is an int32 DP value,
index or flag.
"""

import contextlib
import io
import os
import random

import pytest
import torch

from recgraph_tpu_torch import fuzz, metrics
from recgraph_tpu_torch.align.pipeline import Options, run
from recgraph_tpu_torch.graph.poagraph import PoaGraph
from recgraph_tpu_torch.io import fasta, gfa
from recgraph_tpu_torch.ops import (
    cuda_poa_gap_global, cuda_poa_gap_global_win, cuda_poa_gap_local, cuda_poa_global,
    cuda_poa_global_win, cuda_poa_local, poa_engine, poa_gap_engine,
)
from recgraph_tpu_torch.ops.encode import encode_read_aux, encode_reads, poa_device_graph
from recgraph_tpu_torch.scoring import ScoreMatrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
