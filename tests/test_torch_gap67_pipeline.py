"""The port's modes 6/7 through the CLI on the CPU.

The torch engine's plain fill costs seconds a chunk on the CPU, so the
goldens are held on a read subset here (the first lines of
``mode6_full.txt`` / ``mode7_full.txt``); the card runs all 52 reads.
Also: the lines go to stdout whatever ``-o`` says (main.rs:277), the
oracle engine prints the same lines, and chunking and walk batching
change nothing.  Byte equality of the printed lines.
"""

import os

import pytest
import torch

from recgraph_tpu_torch import cli
from recgraph_tpu_torch.graph.pathgraph import PathGraph
from recgraph_tpu_torch.io import fasta, gfa
from recgraph_tpu_torch.ops import pathwise_gap_engine
from recgraph_tpu_torch.scoring import ScoreMatrix

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def head_reads(example_paths, tmp_path, k, start=0):
    """A FASTA of example reads start..start+k-1."""
    seqs, names = fasta.get_sequences(example_paths[0])
    path = tmp_path / f"reads_{start}_{k}.fa"
    path.write_text("".join(f">{names[i]}\n{seqs[i][1:]}\n" for i in range(start, start + k)))
    return str(path)


def golden_lines(mode, start, k):
    with open(os.path.join(GOLDEN_DIR, f"mode{mode}_full.txt")) as fh:
        lines = fh.read().splitlines()[2 * start : 2 * (start + k)]
    # read numbers restart at 0 in a subset
    return [f"Best path sequence {(i - 2 * start) // 2}: {ln.rsplit(' ', 1)[1]}"
            if ln.startswith("Best path sequence") else ln
            for i, ln in enumerate(lines, start=2 * start)]


@pytest.mark.parametrize("mode", [6, 7])
def test_cli_matches_golden_subset_on_stdout(example_paths, tmp_path, capsys, mode):
    reads = head_reads(example_paths, tmp_path, 4)
    out = tmp_path / "out.gaf"
    cli.main(["-m", str(mode), reads, example_paths[1], "-o", str(out), "--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == golden_lines(mode, 0, 4)
    assert not out.exists()


@pytest.mark.parametrize("mode", [6, 7])
def test_oracle_engine_matches_golden(example_paths, tmp_path, capsys, mode):
    reads = head_reads(example_paths, tmp_path, 1, start=9)
    cli.main(["-m", str(mode), reads, example_paths[1], "--engine", "oracle"])
    assert capsys.readouterr().out.splitlines() == golden_lines(mode, 9, 1)


def test_chunks_and_walk_batches_change_nothing(example_paths, monkeypatch):
    g = PathGraph.from_gfa(gfa.parse_gfa(example_paths[1]))
    seqs, _ = fasta.get_sequences(example_paths[0])
    reads = seqs[40:45]
    sm = ScoreMatrix.create("none", 2, -4)
    one = pathwise_gap_engine.run_batch(7, reads, g, sm, -4, -2, "cpu")
    # one read a chunk, two reads a walk loop
    monkeypatch.setitem(pathwise_gap_engine.WALK_BYTES, "cpu", 2 * 4 * g.n * 160 * 4)
    many = pathwise_gap_engine.run_batch(7, reads, g, sm, -4, -2, "cpu", chunk_bytes=1)
    assert many == one
    assert [f"{c}" for _, c in one] == golden_lines(7, 40, 5)[0::2]
