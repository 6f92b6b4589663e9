"""The port's pipeline and CLI on the CPU: goldens, amb-strand against
the JAX pipeline, chunking, the oracle engine and unported paths (modes
0/1; modes 2/3 in test_torch_pipeline_gap.py, 4/5 in
test_torch_pipeline_pathwise.py, long reads in test_torch_long_reads.py).

The comparisons are byte equality of GAF output.
"""

import contextlib
import io
import os

import pytest
import torch

from recgraph_tpu.align import pipeline as jax_pipeline
from recgraph_tpu.graph.poagraph import PoaGraph
from recgraph_tpu.io import fasta, gfa
from recgraph_tpu.scoring import ScoreMatrix
from recgraph_tpu_torch import cli, metrics
from recgraph_tpu_torch.align.pipeline import Options, run
from recgraph_tpu_torch.ops import poa_engine, traceback_engine

# the port's CPU path runs thousands of tiny ops; more intra-op threads only
# contend with the other test workers on the CPU
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
CONFIGS = {
    "mode0": dict(alignment_mode=0),
    "mode1": dict(alignment_mode=1),
    "mode1_hoxd70": dict(alignment_mode=1, matrix="HOXD70"),
}


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.gaf")) as fh:
        return fh.read()


def _capture(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        fn(*a, **kw)
    return buf.getvalue()


def _subset(example_paths, tmp_path, k):
    seqs, names = fasta.get_sequences(example_paths[0])
    path = tmp_path / f"reads{k}.fa"
    path.write_text("".join(f">{n}\n{s[1:]}\n" for n, s in zip(names[:k], seqs[:k])))
    return str(path)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden_cpu(example_paths, name):
    metrics.reset_phases()
    got = _capture(run, Options(*example_paths, device="cpu", **CONFIGS[name]))
    assert got == _golden(name)
    # the CPU path runs the plain fills and launches no kernel
    assert sum(metrics.LAUNCHES.values()) == 0
    assert metrics.PHASES["fill"] > 0 and metrics.PHASES["walk"] > 0


@pytest.mark.parametrize("mode", [0, 1])
def test_amb_strand_matches_jax(example_paths, tmp_path, mode):
    check_amb_strand(example_paths, tmp_path, mode, 12)


def check_amb_strand(example_paths, tmp_path, mode, k):
    reads = _subset(example_paths, tmp_path, k)
    graph = example_paths[1]
    ref = _capture(jax_pipeline.run, jax_pipeline.Options(
        reads, graph, alignment_mode=mode, amb_strand=True, engine="jax"))
    got = _capture(run, Options(
        reads, graph, alignment_mode=mode, amb_strand=True, device="cpu"))
    assert got == ref
    assert len(got.splitlines()) == k


@pytest.mark.parametrize("mode", [0, 1])
def test_output_does_not_depend_on_chunk_size(example_paths, monkeypatch, mode):
    check_chunking(example_paths, monkeypatch, mode, 7)


def check_chunking(example_paths, monkeypatch, mode, k):
    seqs, _ = fasta.get_sequences(example_paths[0])
    seqs = seqs[:k]
    g = PoaGraph.from_gfa(gfa.parse_gfa(example_paths[1]))
    sm = ScoreMatrix.create("none", 2, -4)
    btas = [int(1 + 0.01 * len(s)) for s in seqs]
    Lp = (max(map(len, seqs)) + 7) // 8 * 8
    W = traceback_engine.max_walk_steps(g.n, Lp)
    planes = 2 if mode < 2 else 5      # the planes and score scratch each fill writes
    three = 3 * 4 * (planes * g.n * Lp + 5 * g.n + 2 * W)
    whole = poa_engine.run_batch_walks(mode, seqs, g, sm, -4, -2, btas, "cpu")
    assert poa_engine.chunk_reads(mode, g.n, Lp, max(btas), "cpu") >= len(seqs)
    monkeypatch.setitem(poa_engine.CHUNK_BYTES, "cpu", three)
    assert poa_engine.chunk_reads(mode, g.n, Lp, max(btas), "cpu") == 3
    chunked = poa_engine.run_batch_walks(mode, seqs, g, sm, -4, -2, btas, "cpu")
    assert len(whole) == len(chunked) == len(seqs)
    for a, b in zip(whole, chunked):
        for f in ("score", "last_row", "last_col_abs", "stop_row", "query_start",
                  "band_check_ok"):
            assert getattr(a, f) == getattr(b, f), f
        assert (a.dirs == b.dirs).all() and (a.rows == b.rows).all()


def test_cli_writes_golden_file(example_paths, tmp_path):
    out = tmp_path / "mode0.gaf"
    _capture(cli.main, ["-m", "0", *example_paths, "-o", str(out), "--device", "cpu"])
    assert out.read_text() == _golden("mode0")


@pytest.mark.parametrize("mode", [0, 1])
def test_oracle_engine(example_paths, tmp_path, mode):
    reads = _subset(example_paths, tmp_path, 2)
    got = _capture(run, Options(reads, example_paths[1], alignment_mode=mode,
                                engine="oracle"))
    assert got.splitlines() == _golden(f"mode{mode}").splitlines()[:2]


def test_unported_paths_raise(example_paths):
    # every mode and multi-process runs are ported; a multi-process run
    # without -o stops before it joins, with recgraph_tpu's message
    for mode in ("0", "6"):
        with pytest.raises(SystemExit, match="multi-process runs require -o <file>"):
            cli.main(["-m", mode, *example_paths, "--device", "cpu", "--num-processes", "2"])
    with pytest.raises(ValueError, match="modes are 0..9"):
        run(Options(*example_paths, alignment_mode=10, device="cpu"))
    with pytest.raises(ValueError, match="engine"):
        Options(*example_paths, engine="jax", device="cpu")

