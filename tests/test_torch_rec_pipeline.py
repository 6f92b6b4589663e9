"""The port's modes 8/9 through the pipeline and the CLI on the CPU: the
mode-8 golden, the reference's dropped first line with ``-o``, the
oracle engine, and chunking: fill chunks and walk batches of any size
give the same records.  ``test_torch_rec_goldens.py`` has the other
goldens.

The comparisons are byte equality of GAF output.
"""

import contextlib
import io
import os

import pytest
import torch

from recgraph_tpu_torch import cli, metrics
from recgraph_tpu_torch.align.pipeline import Options, run
from recgraph_tpu_torch.graph.pathgraph import PathGraph
from recgraph_tpu_torch.io import fasta, gfa
from recgraph_tpu_torch.ops import recombination_engine
from recgraph_tpu_torch.scoring import ScoreMatrix

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def golden(name):
    with open(os.path.join(GOLDEN_DIR, name)) as fh:
        return fh.read()


def capture(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        fn(*a, **kw)
    return buf.getvalue()


def subset(example_paths, tmp_path, idx):
    seqs, names = fasta.get_sequences(example_paths[0])
    path = tmp_path / f"reads{len(idx)}.fa"
    path.write_text("".join(f">{names[i]}\n{seqs[i][1:]}\n" for i in idx))
    return str(path)


def test_golden_mode8_cpu(example_paths):
    metrics.reset_phases()
    got = capture(cli.main, ["-m", "8", *example_paths, "--device", "cpu"])
    assert got == golden("mode8.gaf")
    # the CPU path runs the plain versions and launches no kernel
    assert sum(metrics.LAUNCHES.values()) == 0
    assert all(metrics.PHASES[p] > 0 for p in ("fill", "split", "walk", "emit"))


def test_cli_file_drops_read_zero(example_paths, tmp_path):
    """Modes 8/9 number reads from 0, so the writer's truncate-at-1 rule
    drops read 0's line from an ``-o`` file, as the reference does."""
    out = tmp_path / "mode8.gaf"
    capture(cli.main, ["-m", "8", subset(example_paths, tmp_path, range(3)), example_paths[1],
                       "-o", str(out), "--device", "cpu"])
    assert out.read_text().splitlines() == golden("mode8.gaf").splitlines()[1:3]


@pytest.mark.parametrize("mode,read", [(8, 1), (9, 16)])
def test_oracle_engine(example_paths, tmp_path, mode, read):
    """The scalar oracle on one read (read 16 recombines in mode 9)."""
    got = capture(run, Options(subset(example_paths, tmp_path, [read]), example_paths[1],
                               alignment_mode=mode, engine="oracle"))
    assert got == golden(f"mode{mode}.gaf").splitlines(keepends=True)[read]


def test_chunks_and_walk_batches(example_paths, monkeypatch):
    """Three-read fill chunks and walk batches of three give the records
    of one chunk, in modes 8 and 9 (reads 16 and 50 recombine in both)."""
    idx = [0, 1, 16, 17, 50, 51]
    seqs = [fasta.get_sequences(example_paths[0])[0][i] for i in idx]
    g = PathGraph.from_gfa(gfa.parse_gfa(example_paths[1]))
    rg = g.reverse()
    sm = ScoreMatrix.create("none", 2, -4)
    n, Lp = g.n, (max(map(len, seqs)) + 7) // 8 * 8
    for mode in (8, 9):
        args = (mode, seqs, g, rg, sm, 4, 0.1, 1.0, "cpu")
        whole = recombination_engine.run_batch_walks(*args)
        monkeypatch.setitem(recombination_engine.WALK_BYTES, "cpu", 3 * 2 * n * Lp * 4)
        chunked = recombination_engine.run_batch_walks(
            *args, chunk_bytes=3 * g.paths_number * n * Lp * 4 * 2)
        monkeypatch.undo()
        assert [r.to_string() for r in chunked] == [r.to_string() for r in whole]
        want = golden(f"mode{mode}.gaf").splitlines()
        got = [r.to_string() for r in whole]
        names = [ln.split("\t")[0] for ln in want]
        assert ["\t".join([names[i]] + s.split("\t")[1:]) for i, s in zip(idx, got)] == \
            [want[i] for i in idx]
