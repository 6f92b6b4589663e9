"""The port's pathwise endings, walk and record builder against the JAX
engine's (``_endings_*_dev``, ``_walk_pathwise``, ``_gaf_from_walk``).

Both walk the same best-path planes (the port's plain fill, which
tests/test_torch_pathwise_fill.py holds equal to the JAX fill), at full
width in modes 4 and 5 on the example corpus and through windowed planes
(``ws``) on a long-read corpus.  Exact equality: walks are int32 codes
and rows, records are GAF bytes.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recgraph_tpu.graph.pathgraph import PathGraph as JaxPathGraph
from recgraph_tpu.io import fasta
from recgraph_tpu.io import gfa as jax_gfa
from recgraph_tpu.ops import encode as jax_encode
from recgraph_tpu.ops import pathwise_engine as jax_engine
from recgraph_tpu.ops import pathwise_window as jax_window
from recgraph_tpu.scoring import ScoreMatrix
from recgraph_tpu_torch.graph.pathgraph import PathGraph
from recgraph_tpu_torch.io import gfa
from recgraph_tpu_torch.ops import encode, pathwise_engine, pathwise_window

from test_torch_pathwise_window import long_reads

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))

# the port's CPU path runs thousands of tiny ops; more intra-op threads only
# contend with the other test workers on the CPU
torch.set_num_threads(1)


def graphs(gfa_path):
    return (JaxPathGraph.from_gfa(jax_gfa.parse_gfa(gfa_path)),
            PathGraph.from_gfa(gfa.parse_gfa(gfa_path)))


def check_walks(jg, g, reads, A, L, semiglobal, ws=None):
    """Endings, plane extraction, walk and records of both packages on
    the port's planes A[B, P, n, W]; returns the records."""
    sm = ScoreMatrix.create("none", 2, -4)
    dg = encode.path_device_graph(g, "cpu")
    jdg = jax_encode._build_path_device_graph(jg)
    table = torch.as_tensor(sm.table, dtype=torch.int32)
    jA, jL = jnp.asarray(A.numpy()), jnp.asarray(L.numpy())
    seq, _ = encode.encode_reads(reads, pad_to=max(map(len, reads)))
    if ws is None:
        fc, jfc = pathwise_engine._final_column(A, L), jax_engine._final_column(jA, jL)
    else:
        jws = jnp.asarray(ws.numpy())
        fc = pathwise_window._final_column_win(A, ws, L)
        jfc = jax_window._final_column_win(jA, jws, jL)
    np.testing.assert_array_equal(fc.numpy(), np.asarray(jfc))
    if semiglobal:
        got = pathwise_engine._endings_semiglobal_dev(fc, dg.paths_on.t())
        ref = jax_engine._endings_semiglobal_dev(jnp.asarray(jfc), jdg.paths_on.T)
    else:
        got = pathwise_engine._endings_global_dev(fc, *pathwise_engine._end_meta(g, "cpu"))
        ref = jax_engine._endings_global_dev(jnp.asarray(jfc), *jax_engine._end_meta(jg))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    bp, node, score = got
    planes = pathwise_engine._extract_plane(A, bp)
    np.testing.assert_array_equal(
        planes.numpy(), np.asarray(jax_engine._extract_plane(jA, jnp.asarray(bp.numpy()))))

    max_steps = dg.n + seq.shape[1] + 4
    pred_of_bp = dg.pred_of.t()[bp.long()]
    out = pathwise_engine.walk_pathwise(
        planes, seq, L, table, dg.node_start, dg.codes, pred_of_bp, node,
        not semiglobal, max_steps, ws=ws)
    ref = jax_engine._walk_pathwise(
        jnp.asarray(planes.numpy()), jnp.asarray(seq.numpy()), jL,
        jnp.asarray(sm.table, dtype=jnp.int32), jnp.asarray(jg.node_start), jdg.codes,
        jnp.asarray(pred_of_bp.numpy()), jnp.asarray(node.numpy()),
        global_mode=not semiglobal, max_steps=max_steps,
        ws=None if ws is None else jws)
    dirs, rows, steps, stop = (t.numpy() for t in out)
    rdirs, rrows, rsteps, rstop = (np.asarray(t) for t in ref)
    np.testing.assert_array_equal(steps, rsteps)
    np.testing.assert_array_equal(stop, rstop)
    recs = []
    for b, s in enumerate(reads):
        k = int(steps[b])
        assert k > 0
        np.testing.assert_array_equal(dirs[b, :k], rdirs[b, :k])
        np.testing.assert_array_equal(rows[b, :k], rrows[b, :k])
        args = (int(stop[b]), int(bp[b]), int(node[b]), int(score[b]), s)
        rec = pathwise_engine._gaf_from_walk(dirs[b], rows[b], k, args[0], g, *args[1:])
        jrec = jax_engine._gaf_from_walk(rdirs[b], rrows[b], k, args[0], jg, *args[1:])
        assert rec.to_string() == jrec.to_string()
        recs.append(rec)
    return recs


@pytest.mark.parametrize("mode", [4, 5])
def test_endings_and_walk_match_jax(example_paths, mode):
    jg, g = graphs(example_paths[1])
    reads = fasta.get_sequences(example_paths[0])[0][:6]
    sm = ScoreMatrix.create("none", 2, -4)
    dg = encode.path_device_graph(g, "cpu")
    seq, L = encode.encode_reads(reads)
    A = pathwise_engine.fill_pathwise_plain(
        dg, torch.as_tensor(sm.table, dtype=torch.int32), seq, mode == 5)
    check_walks(jg, g, reads, A, L, mode == 5)


def test_windowed_walk_matches_jax(tmp_path):
    from make_synthetic import make

    make(str(tmp_path), n_back=600, n_reads=1, seed=11)
    gfa_path = str(tmp_path / "graph.gfa")
    jg, g = graphs(gfa_path)
    reads = long_reads(gfa_path, 2, 5)
    sm = ScoreMatrix.create("none", 2, -4)
    dg = encode.path_device_graph(g, "cpu")
    seq, L = encode.encode_reads(reads)
    Aw, ws, _ = pathwise_window.fill_pathwise_win_plain(
        dg, torch.as_tensor(sm.table, dtype=torch.int32), seq, L, 256,
        pathwise_window.rmin_tensor(dg))
    check_walks(jg, g, reads, Aw, L, False, ws=ws)
