"""The port's modes-6/7 endings, plane extraction, walk and lines against
the JAX engine's.

``endings_gap_global`` / ``endings_gap_semi`` against the JAX engine's
per-read ``_endings_gap_global`` / ``_endings_gap_semi`` on final
columns with planted ties (the largest path wins a tie, the first row
reaching the maximum wins in mode 7); ``final_gap_column`` and
``extract_gap_planes``; ``walk_gap`` against ``_walk_gap`` on the same
planes; ``count_to_source_table`` against ``_count_to_source``; and the
printed lines of ``run_batch`` against the JAX ``run_batch``, on the
example graph and on random covered DAGs, where the JAX engine raises
for a walk that leaves its best path and the port must raise the same.
Exact equality throughout.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recgraph_tpu.graph.pathgraph import PathGraph as JaxPathGraph
from recgraph_tpu.graph.pathgraph import pathwise_meta
from recgraph_tpu.io import fasta
from recgraph_tpu.io import gfa as jax_gfa
from recgraph_tpu.ops import encode as jax_encode
from recgraph_tpu.ops import pathwise_gap_engine as jax_engine
from recgraph_tpu.scoring import ScoreMatrix as JaxScoreMatrix
from recgraph_tpu_torch import fuzz
from recgraph_tpu_torch.graph.pathgraph import PathGraph
from recgraph_tpu_torch.io import gfa
from recgraph_tpu_torch.ops import pathwise_gap_engine
from recgraph_tpu_torch.ops.encode import path_device_graph
from recgraph_tpu_torch.scoring import ScoreMatrix

from test_torch_gap67_meta import gfa_text

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def example(example_paths):
    seqs, _ = fasta.get_sequences(example_paths[0])
    return (JaxPathGraph.from_gfa(jax_gfa.parse_gfa(example_paths[1])),
            PathGraph.from_gfa(gfa.parse_gfa(example_paths[1])), seqs)


def planted_final_columns(g, B, seed):
    """Final columns int32[B, n, P] with many ties: small random values,
    one read all equal, one with the best value planted on two paths of
    two rows."""
    rng = np.random.default_rng(seed)
    fc = rng.integers(-3, 3, size=(B, g.n, g.paths_number)).astype(np.int32)
    fc[0] = 1
    fc[1, 5, [2, 7]] = 40
    fc[1, 9, [3, 4]] = 40
    return fc


def test_endings_with_ties_match_jax(example):
    jg, g, _ = example
    fc = planted_final_columns(g, 6, 5)
    f_pred, f_ap = pathwise_gap_engine._end_tables(g, "cpu")
    bp = pathwise_gap_engine.endings_gap_global(torch.from_numpy(fc), f_pred, f_ap)
    node7, bp7 = pathwise_gap_engine.endings_gap_semi(
        torch.from_numpy(fc), torch.from_numpy(np.asarray(g.alphas, np.int64)),
        torch.from_numpy(g.paths_nodes))
    for b in range(fc.shape[0]):
        assert int(bp[b]) == jax_engine._endings_gap_global(fc[b], jg)
        assert (int(node7[b]), int(bp7[b])) == jax_engine._endings_gap_semi(fc[b], jg)


def test_final_column_and_planes_match_jax(example):
    jg, g, _ = example
    rng = np.random.default_rng(3)
    n, P, B, Lp = g.n, g.paths_number, 3, 16
    Dm, X, Y = (rng.integers(-50, 50, size=(n, B, P, Lp)).astype(np.int32) for _ in range(3))
    L = np.array([16, 9, 12], np.int32)
    bp = np.array([0, 22, 7], np.int32)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        pathwise_gap_engine.final_gap_column(t(Dm), t(L)).numpy(),
        np.asarray(jax_engine.final_gap_column(jnp.asarray(Dm), jnp.asarray(L))))
    got = pathwise_gap_engine.extract_gap_planes(t(Dm), t(X), t(Y),
                                                 t(np.asarray(g.alphas, np.int64)), t(bp))
    ref = jax_engine.extract_gap_planes(jnp.asarray(Dm), jnp.asarray(X), jnp.asarray(Y),
                                        jnp.asarray(jg.alphas), jnp.asarray(bp))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("mode", [6, 7])
def test_walk_matches_jax(example, mode, monkeypatch):
    """Both walks over the same planes (the JAX fill's), from the same
    ends: every emitted code, the step counts, stop rows and errors."""
    monkeypatch.setenv("RECGRAPH_NO_PALLAS67", "1")
    jg, g, seqs = example
    reads = seqs[20:24]
    semi = mode == 7
    jseq, jL = jax_encode.encode_reads(reads)
    Dm, X, Y = jax_engine.fill_gap_device(jg, JaxScoreMatrix.create("none", 2, -4), jseq,
                                          -4, -2, semi)
    fc = np.asarray(jax_engine.final_gap_column(Dm, jL))
    ends = [jax_engine._endings_gap_semi(fc[b], jg) if semi
            else (0, jax_engine._endings_gap_global(fc[b], jg)) for b in range(len(reads))]
    nodes = np.array([e[0] for e in ends], np.int32)
    bps = np.array([e[1] for e in ends], np.int32)
    f_pred = np.zeros(jg.paths_number, np.int32)
    for node, paths in jg.preds_and_paths(jg.n - 1):
        f_pred[paths] = node
    start = nodes if semi else f_pred[bps]
    planes = jax_engine.extract_gap_planes(Dm, X, Y, jnp.asarray(jg.alphas), jnp.asarray(bps))
    pred_of = pathwise_meta(jg)[1].T[bps]
    Lp_all = max(len(s) for s in reads)
    W = 2 * (jg.n + Lp_all) + 8
    ref = [np.asarray(a) for a in jax_engine._walk_gap(
        *planes, jnp.asarray(jg.alphas), jnp.int32(jg.paths_number), jnp.asarray(bps),
        jnp.asarray(jg.node_start), jnp.asarray(pred_of), jnp.asarray(start), jL,
        global_mode=not semi, max_steps=W)]
    dg = path_device_graph(g, "cpu")
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    dirs, k, stop, err = pathwise_gap_engine.walk_gap(
        *(t(p) for p in planes), t(np.asarray(g.alphas, np.int64)), g.paths_number, t(bps),
        dg.node_start, dg.pred_of.t()[t(bps).long()], t(start), t(jL), not semi, W)
    np.testing.assert_array_equal(k.numpy(), ref[1])
    np.testing.assert_array_equal(stop.numpy(), ref[2])
    np.testing.assert_array_equal(err.numpy(), ref[3])
    for b in range(len(reads)):
        np.testing.assert_array_equal(dirs[b, : ref[1][b]].numpy(), ref[0][b, : ref[1][b]])


def test_count_to_source_matches_jax(example):
    jg, g, _ = example
    table = pathwise_gap_engine.count_to_source_table(g)
    for i in range(0, g.n - 1, 37):
        for p in range(g.paths_number):
            try:
                ref = jax_engine._count_to_source(jg, i, p)
            except RuntimeError:
                ref = -1
            assert table[i, p] == ref, (i, p)


@pytest.mark.parametrize("mode", [6, 7])
def test_run_batch_lines_match_jax(example, mode, monkeypatch):
    monkeypatch.setenv("RECGRAPH_NO_PALLAS67", "1")
    jg, g, seqs = example
    reads = seqs[30:34]
    ref = jax_engine.run_batch(mode, reads, jg, JaxScoreMatrix.create("none", 2, -4), -4, -2)
    got = pathwise_gap_engine.run_batch(mode, reads, g, ScoreMatrix.create("none", 2, -4),
                                        -4, -2, "cpu", chunk_bytes=1)
    assert got == ref


@pytest.mark.parametrize("seed", [1, 6, 8])
def test_run_batch_random_dags_match_jax(seed, tmp_path, monkeypatch):
    """Equal lines, or the same RuntimeError where a walk leaves its best
    path (the reference hangs or crashes there)."""
    monkeypatch.setenv("RECGRAPH_NO_PALLAS67", "1")
    rng = random.Random(1000 + seed)
    gf = fuzz.random_gfa(rng, cover_all=True)
    path = tmp_path / "graph.gfa"
    path.write_text(gfa_text(gf))
    jg = JaxPathGraph.from_gfa(jax_gfa.parse_gfa(str(path)))
    g = PathGraph.from_gfa(gfa.parse_gfa(str(path)))
    reads = [fuzz.random_read(rng, gf) for _ in range(4)]
    for mode in (6, 7):
        try:
            ref = jax_engine.run_batch(mode, reads, jg, JaxScoreMatrix.match_mismatch(2, -4),
                                       -4, -2)
        except RuntimeError as exc:
            with pytest.raises(RuntimeError) as got:
                pathwise_gap_engine.run_batch(mode, reads, g, ScoreMatrix.match_mismatch(2, -4),
                                              -4, -2, "cpu")
            assert str(got.value) == str(exc)
            continue
        assert pathwise_gap_engine.run_batch(mode, reads, g, ScoreMatrix.match_mismatch(2, -4),
                                             -4, -2, "cpu") == ref
