"""The port's plain modes-6/7 fill (the plain version of kernel K11)
against the JAX engine's XLA scan.

``pathwise_gap_engine.fill_gap_plain`` must equal JAX ``fill_gap_device``
with ``RECGRAPH_NO_PALLAS67=1`` (its ``_fill_gap`` scan) on every cell
of the three delta-form planes Dm, X and Y: the walk reads delta-form
values and the mask_q quirk leaks deltas between groups, so every cell
is part of the output.  Inputs: the example graph (23 paths, up to 9
blocks a row) in modes 6 and 7, HOXD70 with o = -200 (past the TPU
kernel's packed-chain gate), (o, e) = (-3, -1), and random covered DAGs
(multi-pred rows, re-alpha'd blocks).  The Pallas kernel itself is
checked in test_torch_gap67_interpret.py.
"""

import random

import numpy as np
import pytest
import torch

from recgraph_tpu.graph.pathgraph import PathGraph as JaxPathGraph
from recgraph_tpu.io import fasta
from recgraph_tpu.io import gfa as jax_gfa
from recgraph_tpu.ops import encode as jax_encode
from recgraph_tpu.ops import pathwise_gap_engine as jax_engine
from recgraph_tpu.scoring import ScoreMatrix as JaxScoreMatrix
from recgraph_tpu_torch import fuzz
from recgraph_tpu_torch.graph.pathgraph import PathGraph
from recgraph_tpu_torch.io import gfa
from recgraph_tpu_torch.ops import encode, pathwise_gap_engine
from recgraph_tpu_torch.scoring import ScoreMatrix

from test_torch_gap67_meta import gfa_text

torch.set_num_threads(1)


def fill_both(jg, g, reads, matrix, o, e, semi, monkeypatch, pad_to=None):
    """(JAX planes, port planes), each (Dm, X, Y) as numpy [n, B, P, Lp]."""
    monkeypatch.setenv("RECGRAPH_NO_PALLAS67", "1")
    jseq, _ = jax_encode.encode_reads(reads, pad_to=pad_to)
    ref = jax_engine.fill_gap_device(jg, JaxScoreMatrix.create(matrix, 2, -4), jseq, o, e, semi)
    seq, _ = encode.encode_reads(reads, pad_to=pad_to)
    got = pathwise_gap_engine.fill_gap_device(g, ScoreMatrix.create(matrix, 2, -4), seq, o, e,
                                              semi, device="cpu")
    return [np.asarray(a) for a in ref], [a.numpy() for a in got]


def assert_planes_equal(ref, got, what):
    for a, b, name in zip(ref, got, ("Dm", "X", "Y")):
        assert a.shape == b.shape, f"{what} {name}: {a.shape} != {b.shape}"
        bad = np.argwhere(a != b)
        assert not len(bad), f"{what} {name}: {len(bad)} cells differ, first {bad[:4].tolist()}"


@pytest.fixture(scope="module")
def example(example_paths):
    seqs, _ = fasta.get_sequences(example_paths[0])
    return (JaxPathGraph.from_gfa(jax_gfa.parse_gfa(example_paths[1])),
            PathGraph.from_gfa(gfa.parse_gfa(example_paths[1])), seqs)


@pytest.mark.parametrize("case", [
    ("none", -4, -2, False, slice(0, 6)),
    ("none", -4, -2, True, slice(0, 6)),
    ("HOXD70", -200, -2, False, slice(6, 8)),
    ("HOXD70", -200, -2, True, slice(8, 10)),
    ("none", -3, -1, False, slice(10, 12)),
    ("none", -3, -1, True, slice(12, 14)),
], ids=["mode6", "mode7", "hoxd70_o200_mode6", "hoxd70_o200_mode7", "oe31_mode6", "oe31_mode7"])
def test_plain_fill_matches_xla_scan_example(example, case, monkeypatch):
    jg, g, seqs = example
    matrix, o, e, semi, reads = case
    ref, got = fill_both(jg, g, seqs[reads], matrix, o, e, semi, monkeypatch)
    assert_planes_equal(ref, got, f"example {case}")


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_plain_fill_matches_xla_scan_random(seed, tmp_path, monkeypatch):
    rng = random.Random(seed)
    gf = fuzz.random_gfa(rng, n_nodes=16, n_paths=4, cover_all=True)
    path = tmp_path / "graph.gfa"
    path.write_text(gfa_text(gf))
    jg = JaxPathGraph.from_gfa(jax_gfa.parse_gfa(str(path)))
    g = PathGraph.from_gfa(gfa.parse_gfa(str(path)))
    reads = [fuzz.random_read(rng, gf) for _ in range(3)]
    matrix, o, e = [("none", -4, -2), ("HOXD70", -200, -2), ("none", -3, -1)][seed % 3]
    for semi in (False, True):
        ref, got = fill_both(jg, g, reads, matrix, o, e, semi, monkeypatch, pad_to=40)
        assert_planes_equal(ref, got, f"random{seed} semi={semi}")
