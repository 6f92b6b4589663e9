"""The port's own host layer against the JAX package's: GFA parsing, the
POA graph arrays, scoring tables, FASTA reading, reverse complements,
the native walk emitter's bytes and the GAF writer.

Exact equality throughout: arrays, strings and bytes.
"""

import os
import random

import numpy as np
import pytest

from recgraph_tpu import native as jax_native
from recgraph_tpu import scoring as jax_scoring
from recgraph_tpu.graph.poagraph import PoaGraph as JaxPoaGraph
from recgraph_tpu.io import fasta as jax_fasta
from recgraph_tpu.io import gfa as jax_gfa
from recgraph_tpu.io.gaf import GafWriter as JaxGafWriter
from recgraph_tpu_torch import fuzz, native, scoring
from recgraph_tpu_torch.align.pipeline import _hofp_ids
from recgraph_tpu_torch.graph.poagraph import PoaGraph
from recgraph_tpu_torch.io import fasta, gfa
from recgraph_tpu_torch.io.gaf import GafRecord, GafWriter
from recgraph_tpu_torch.ops import poa_engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRETCH_GFA_ARGS = (700, 1, 42)    # tools/make_synthetic.make: the stretch graph


def _graph_files(example_paths, tmp_path):
    yield "example", example_paths[1]
    import sys

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import contextlib
    import io

    import make_synthetic

    d = str(tmp_path / "stretch")
    with contextlib.redirect_stdout(io.StringIO()):
        make_synthetic.make(d, *STRETCH_GFA_ARGS)
    yield "stretch", os.path.join(d, "graph.gfa")


def _assert_graphs_equal(a, b, name):
    assert a.lnz == b.lnz, name
    for f in ("codes", "node_start"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{name}.{f}")
        assert getattr(a, f).dtype == getattr(b, f).dtype, (name, f)
    assert a.preds == b.preds and a.handle_pos == b.handle_pos, name
    for x, y in zip(a.padded_preds(), b.padded_preds()):
        np.testing.assert_array_equal(x, y, err_msg=name)
    np.testing.assert_array_equal(a.r_values(), b.r_values(), err_msg=name)
    assert [a.min_pred(i) for i in range(1, a.n)] == [b.min_pred(i) for i in range(1, b.n)]


def test_gfa_and_poagraph_match_jax(example_paths, tmp_path):
    """Example, stretch and seeded random graphs, both strands."""
    files = list(_graph_files(example_paths, tmp_path))
    for name, path in files:
        p, q = gfa.parse_gfa(path), jax_gfa.parse_gfa(path)
        assert p.segments == q.segments and p.edges == q.edges
        assert [(x.name, x.nodes) for x in p.paths] == [(x.name, x.nodes) for x in q.paths]
        for amb in (False, True):
            _assert_graphs_equal(PoaGraph.from_gfa(p, amb_mode=amb),
                                 JaxPoaGraph.from_gfa(q, amb_mode=amb), f"{name}/{amb}")
    for seed in (5, 6, 7):
        gf = fuzz.random_gfa(random.Random(seed), n_nodes=30, n_paths=5, cover_all=True)
        qf = jax_gfa.Gfa(segments=dict(gf.segments), edges=list(gf.edges), paths=[
            jax_gfa.GfaPath(p.name, list(p.nodes)) for p in gf.paths])
        for amb in (False, True):
            _assert_graphs_equal(PoaGraph.from_gfa(gf, amb_mode=amb),
                                 JaxPoaGraph.from_gfa(qf, amb_mode=amb), f"random{seed}")


@pytest.mark.parametrize("matrix", ["none", "HOXD70", "HOXD55"])
def test_score_matrix_matches_jax(matrix):
    for m, x in ((2, -4), (1, -1), (5, -3)):
        a = scoring.ScoreMatrix.create(matrix, m, x).table
        b = jax_scoring.ScoreMatrix.create(matrix, m, x).table
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert scoring.GAP == jax_scoring.GAP and scoring.N == jax_scoring.N
    np.testing.assert_array_equal(scoring.encode("$ACGTN-F"), jax_scoring.encode("$ACGTN-F"))


def test_fasta_and_rev_compl_match_jax(example_paths, tmp_path):
    odd = tmp_path / "odd.fa"
    odd.write_text(">r1 some comment\nacg-t\nNNa\n\n>r2\tx\r\nTTTT\r\n>r3\n")
    for path in (example_paths[0], str(odd)):
        got = fasta.get_sequences(path)
        assert got == jax_fasta.get_sequences(path)
        for s in got[0]:
            assert fasta.rev_and_compl(s) == jax_fasta.rev_and_compl(s)
    with pytest.raises(ValueError, match="wrong char"):
        fasta.rev_and_compl("$ACX")
    with pytest.raises(FileNotFoundError):
        fasta.get_sequences(str(tmp_path / "missing.fa"))


def test_native_library_builds_into_the_port(tmp_path):
    so = native.build()
    assert so.startswith(native.BUILD_DIR) and os.path.exists(so)
    assert os.path.dirname(os.path.dirname(so)) == os.path.dirname(
        os.path.abspath(native.__file__))
    assert native.library_path() == so


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_walk_emitter_matches_jax(example_paths, mode):
    """The port's copy of the walk emitter gives the JAX package's native
    emitter's bytes, singly and batched, on the example walks."""
    seqs, _ = fasta.get_sequences(example_paths[0])
    seqs = seqs[:6]
    g = PoaGraph.from_gfa(gfa.parse_gfa(example_paths[1]))
    sm = scoring.ScoreMatrix.create("none", 2, -4)
    btas = [int(1 + 0.01 * len(s)) for s in seqs]
    states = poa_engine.run_batch_walks(mode, seqs, g, sm, -4, -2, btas, "cpu")
    hofp = _hofp_ids(g)
    dirs2d = np.zeros((len(states), max(len(s.dirs) for s in states)), np.int32)
    rows2d = np.zeros_like(dirs2d)
    params = np.zeros((len(states), 6), np.int64)
    for k, st in enumerate(states):
        args = (st.dirs, st.rows, st.stop_row, st.query_start, st.last_row,
                st.last_col_abs, hofp, len(seqs[k]), k % 2 == 1)
        one = native.gaf_emit_poa_walk(*args)
        assert one is not None and one == jax_native.gaf_emit_poa_walk(*args)
        dirs2d[k, : len(st.dirs)] = st.dirs
        rows2d[k, : len(st.rows)] = st.rows
        params[k] = (len(st.dirs), st.stop_row, st.query_start, st.last_row,
                     st.last_col_abs, len(seqs[k]))
    for amb in (False, True):
        got = native.gaf_emit_poa_walk_batch(dirs2d, rows2d, params, hofp, amb)
        ref = jax_native.gaf_emit_poa_walk_batch(dirs2d, rows2d, params, hofp, amb)
        assert got == ref
    # a 64-byte per-read buffer rejects every read: the caller emits singly
    assert native.gaf_emit_poa_walk_batch(dirs2d, rows2d, params, hofp, False,
                                          percap=64) == [None] * len(states)


def test_gaf_writer_matches_jax(tmp_path, capsys):
    rec = GafRecord(query_name="q", query_length=5, query_start=0, query_end=5,
                    strand="+", path=[3, 4], path_length=5, path_start=0, path_end=4,
                    residue_matches_number=5, alignment_block_length="*",
                    mapping_quality="*", comments="5M")
    lines = [rec.to_string(), "a\tb", "c"]
    for writer_cls, name in ((GafWriter, "port.gaf"), (JaxGafWriter, "jax.gaf")):
        path = tmp_path / name
        path.write_text("stale\n")
        w = writer_cls(str(path))
        for k, ln in enumerate(lines):
            w.write(ln, k + 1)
        w2 = writer_cls(str(path))
        w2.write("appended", 2)            # number != 1 appends to an existing file
    assert (tmp_path / "port.gaf").read_bytes() == (tmp_path / "jax.gaf").read_bytes()
    assert (tmp_path / "port.gaf").read_text().splitlines() == lines + ["appended"]
    capsys.readouterr()
    for writer_cls in (GafWriter, JaxGafWriter):
        w = writer_cls()
        for k, ln in enumerate(lines):
            w.write(ln, k + 1)
    out = capsys.readouterr().out.splitlines()
    assert out == lines + lines
