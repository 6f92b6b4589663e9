"""The port's modes 4/5 through the pipeline and the CLI on the CPU:
the goldens, the reference's dropped first line with ``-o``, the stretch
sample golden, the mode-4 long-read ladder with its full-width rerun
against the JAX engine, the oracle engine, and chunking.

The comparisons are byte equality of GAF output.
"""

import contextlib
import io
import os
import sys

import jax.numpy as jnp
import pytest
import torch

from recgraph_tpu.graph.pathgraph import PathGraph as JaxPathGraph
from recgraph_tpu.io import gfa as jax_gfa
from recgraph_tpu.ops import pathwise_engine as jax_engine
from recgraph_tpu.ops import pathwise_window as jax_window
from recgraph_tpu.scoring import ScoreMatrix as JaxScoreMatrix
from recgraph_tpu_torch import cli, metrics
from recgraph_tpu_torch.align.pipeline import Options, run
from recgraph_tpu_torch.graph.pathgraph import PathGraph
from recgraph_tpu_torch.io import fasta, gfa
from recgraph_tpu_torch.ops import pathwise_engine, pathwise_window
from recgraph_tpu_torch.scoring import ScoreMatrix

from test_torch_pathwise_window import long_reads

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))

# the port's CPU path runs thousands of tiny ops; more intra-op threads only
# contend with the other test workers on the CPU
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, name)) as fh:
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


@pytest.mark.parametrize("mode", [4, 5])
def test_golden_cpu(example_paths, mode):
    metrics.reset_phases()
    got = _capture(cli.main, ["-m", str(mode), *example_paths, "--device", "cpu"])
    assert got == _golden(f"mode{mode}.gaf")
    # the CPU path runs the plain fill and launches no kernel
    assert sum(metrics.LAUNCHES.values()) == 0
    assert metrics.PHASES["fill"] > 0 and metrics.PHASES["walk"] > 0


def test_cli_file_drops_read_zero(example_paths, tmp_path):
    """Modes 4/5 number reads from 0, so the writer's truncate-at-1 rule
    drops read 0's line from an ``-o`` file, as the reference does."""
    out = tmp_path / "mode4.gaf"
    _capture(cli.main, ["-m", "4", _subset(example_paths, tmp_path, 3), example_paths[1],
                        "-o", str(out), "--device", "cpu"])
    assert out.read_text().splitlines() == _golden("mode4.gaf").splitlines()[1:3]


def test_oracle_engine(example_paths, tmp_path):
    reads = _subset(example_paths, tmp_path, 1)
    for mode in (4, 5):
        got = _capture(run, Options(reads, example_paths[1], alignment_mode=mode,
                                    engine="oracle"))
        assert got.splitlines() == _golden(f"mode{mode}.gaf").splitlines()[:1]


def test_stretch_sample_golden(tmp_path):
    """The first 12 reads of the 10,000-read stretch corpus (BASELINE
    configs[4]) against the oracle-generated golden."""
    from make_synthetic import make

    with contextlib.redirect_stdout(io.StringIO()):
        make(str(tmp_path), n_back=700, n_reads=12, seed=42)
    got = _capture(run, Options(str(tmp_path / "reads.fa"), str(tmp_path / "graph.gfa"),
                                alignment_mode=4, device="cpu"))
    assert got == _golden("stretch_mode4_sample.gaf")


def test_chunks_and_walk_batches_do_not_change_output(example_paths, monkeypatch):
    seqs = fasta.get_sequences(example_paths[0])[0][:5]
    g = PathGraph.from_gfa(gfa.parse_gfa(example_paths[1]))
    sm = ScoreMatrix.create("none", 2, -4)
    for mode in (4, 5):
        whole = [r.to_string() for r in pathwise_engine.run_batch_walks(mode, seqs, g, sm, "cpu")]
        Lp = (max(map(len, seqs)) + 7) // 8 * 8
        # one read per fill chunk, one walk loop per two chunks
        monkeypatch.setitem(pathwise_engine.WALK_BYTES, "cpu", 3 * g.n * Lp * 4)
        one = g.paths_number * g.n * Lp * 4
        chunked = pathwise_engine.run_batch_walks(mode, seqs, g, sm, "cpu", chunk_bytes=one)
        assert [r.to_string() for r in chunked] == whole
        monkeypatch.undo()


def _poison(L, W, longest):
    """An unbeatable exit bound below W = 512 for every read, and at every
    W for the longest read: the ladder climbs once, and one read takes
    the full-width rerun."""
    return (W < 512) | (L == longest)


def test_long_ladder_and_fullwidth_rerun_match_jax(tmp_path, monkeypatch):
    """Mode-4 long reads through the W ladder: the records equal the JAX
    engine's under the same forced guard failures, and the full-width
    rerun is counted and reported.  Both engines route reads of 512
    columns or more to the window here (1,024 in the CLI), so that a
    926-row graph with ~590-bp reads climbs the same ladder (W 256, 512)
    as the long corpus at a fraction of the CPU time."""
    from make_synthetic import make

    with contextlib.redirect_stdout(io.StringIO()):
        make(str(tmp_path), n_back=300, n_reads=1, seed=11)
    gfa_path = str(tmp_path / "graph.gfa")
    reads = long_reads(gfa_path, 3, 7)
    monkeypatch.setattr(jax_engine, "LONG_READ_LP", 512)
    monkeypatch.setattr(pathwise_engine, "LONG_READ_LP", 512)
    longest = max(map(len, reads))
    assert sorted(map(len, reads))[-2] < longest

    orig_jax = jax_window._fill_pathwise_win

    def jax_fill(dg, table, seq, L, W, rmin=None):
        Aw, ws, bound = orig_jax(dg, table, seq, L, W, rmin)
        return Aw, ws, bound + jnp.where(_poison(L, W, longest), 1 << 20, 0)

    monkeypatch.setattr(jax_window, "_fill_pathwise_win", jax_fill)
    jax_engine._pw_w_hint.clear()
    ref = jax_engine.run_batch_walks(
        4, reads, JaxPathGraph.from_gfa(jax_gfa.parse_gfa(gfa_path)),
        JaxScoreMatrix.create("none", 2, -4))

    orig, widths = pathwise_window.fill_pathwise_win_best, []

    def port_fill(dg, table, seq, L, W, rmin):
        widths.append((seq.shape[0], W))
        Aw, ws, bound = orig(dg, table, seq, L, W, rmin)
        return Aw, ws, bound + torch.where(_poison(L, W, longest), 1 << 20, 0)

    monkeypatch.setattr(pathwise_window, "fill_pathwise_win_best", port_fill)
    pathwise_engine._pw_w_hint.clear()
    metrics.reset_phases()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        got = pathwise_engine.run_batch_walks(
            4, reads, PathGraph.from_gfa(gfa.parse_gfa(gfa_path)),
            ScoreMatrix.create("none", 2, -4), "cpu")
    assert [r.to_string() for r in got] == [r.to_string() for r in ref]
    assert widths == [(3, 256), (3, 512)]
    assert metrics.EVENTS["pathwise_win_fullwidth"] == 1
    assert "1 long read(s) exceeded the windowed exit bound" in err.getvalue()

    # one read per chunk, and a walk loop whenever two passing reads wait
    g = PathGraph.from_gfa(gfa.parse_gfa(gfa_path))
    monkeypatch.setitem(pathwise_engine.WALK_BYTES, "cpu", 2 * g.n * 256 * 4)
    pathwise_engine._pw_w_hint.clear()
    widths.clear()
    with contextlib.redirect_stderr(io.StringIO()):
        again = pathwise_engine.run_batch_walks(
            4, reads, g, ScoreMatrix.create("none", 2, -4), "cpu",
            chunk_bytes=g.paths_number * g.n * 512 * 4)
    assert [r.to_string() for r in again] == [r.to_string() for r in ref]
    assert widths == [(1, 256), (1, 512)] * 3

    # mode 5 never takes the window
    monkeypatch.setattr(pathwise_window, "fill_pathwise_win_best", None)
    assert len(reads[0]) >= pathwise_engine.LONG_READ_LP
    five = pathwise_engine.run_batch_walks(
        5, reads[:1], PathGraph.from_gfa(gfa.parse_gfa(gfa_path)),
        ScoreMatrix.create("none", 2, -4), "cpu")
    assert len(five) == 1
