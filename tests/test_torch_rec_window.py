"""The opt-in windowed mode-8 pair (``RECGRAPH_REC_WINDOW=1``) and the
``RECGRAPH_SPLIT_FULL`` full-scan cross-check of the port, against the
JAX package on the CPU.

- The plain reverse window fill (the plain version of kernel S2) against
  ``recombination_window._fill_pathwise_rev_win``: every cell of Awr,
  every window start and the exit account, at W 32 and 128 (the windows
  move) and at W = Lp (equal to the full-width reverse fill inside the
  reads), and on delta-leak reverse graphs at W 16, past every read and
  past Lp; each also replayed from S2's (src, add, floor) table.
- ``full_from_win`` and ``composite_bound``; the windowed reverse walk
  against JAX's walk over the expanded plane, and JAX's own windowed walk
  departing from it past column W (ROADMAP F4: it reads the read at
  min(j + 1, W - 1)).
- Records: pure-haplotype reads equal the full-width run and JAX's
  windowed run; glued reads (recombinants) equal JAX's windowed run with
  its reverse walk patched to walk the expanded plane, counters too.
- The gate; the full scan against JAX's, the guided search, itself in
  chunks, and through the engine; ``_candidate_columns``; the
  Lp - 2 <= 8 route of the dispatcher.

Graphs are small (``make(d, 80, 1, 11)``), ``LONG_READ_LP`` is patched
down and the W ladder starts at 128 in both packages.  Every comparison is
exact: int32 cells, f32 split scores compared bit for bit, GAF bytes.
"""

import os
import random
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recgraph_tpu import metrics as jax_metrics
from recgraph_tpu.graph.pathgraph import PathGraph as JaxPathGraph
from recgraph_tpu.io import gfa as jax_gfa
from recgraph_tpu.ops import encode as jax_encode
from recgraph_tpu.ops import pathwise_engine as jax_pe
from recgraph_tpu.ops import recombination_engine as jax_rec
from recgraph_tpu.ops import recombination_window as jax_rw
from recgraph_tpu.scoring import ScoreMatrix as JaxScoreMatrix
from recgraph_tpu_torch import fuzz, metrics
from recgraph_tpu_torch.graph.pathgraph import PathGraph
from recgraph_tpu_torch.io import gfa
from recgraph_tpu_torch.ops import encode, pathwise_engine
from recgraph_tpu_torch.ops import recombination_engine as rec
from recgraph_tpu_torch.ops import recombination_window as rw
from recgraph_tpu_torch.scoring import ScoreMatrix

from test_rev_fill_leak_rows import fragment_gfa

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))

torch.set_num_threads(1)
FIELDS = ("codes", "node_start", "paths_on", "alphas", "rep_of", "pred_of", "qsrc_of")
COSTS = (4, 0.1, 1.0)
W0 = 128   # one rung below the reads' width, then full width


def port_rev_graph(jrg):
    jdg = jax_rec._build_rev_device_graph(jrg)
    arrays = {f: np.asarray(getattr(jdg, f)) for f in FIELDS}
    return jdg, encode.PathDeviceGraph.from_numpy(
        dict(arrays, n=jdg.n, paths_number=jdg.paths_number), "cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """2 pure-haplotype reads and 2 glued ones (half of one haplotype,
    half of another) of ~155 bp with 2 % substitutions (tests/
    test_rec_window.py's recipe) on both packages' graphs.  Of the glued
    reads, haplotypes 0 and 4 pass the window with a record that differs
    from full width, 0 and 3 fail a rescore and rerun at full width."""
    from make_synthetic import make

    d = str(tmp_path_factory.mktemp("recwin"))
    make(d, n_back=80, n_reads=1, seed=11)
    path = os.path.join(d, "graph.gfa")
    rng = random.Random(5)
    walks, segs = {}, {}
    for ln in open(path):
        f = ln.rstrip("\n").split("\t")
        if f[0] == "P":
            walks[f[1]] = [int(x[:-1]) for x in f[2].split(",")]
        elif f[0] == "S":
            segs[int(f[1])] = f[2]
    hap = ["".join(segs[x] for x in walks[k]) for k in sorted(walks)]
    noisy = lambda s: "$" + "".join(rng.choice("ACGT") if rng.random() < 0.02 else c for c in s)
    glued = {(a, b): noisy(hap[a][: len(hap[a]) // 2] + hap[b][len(hap[b]) // 2 :])
             for a in range(len(hap)) for b in range(len(hap)) if a != b}
    pure = [noisy(hap[k]) for k in range(2)]
    glued = [glued[0, 4], glued[0, 3]]
    jg = JaxPathGraph.from_gfa(jax_gfa.parse_gfa(path))
    g = PathGraph.from_gfa(gfa.parse_gfa(path))
    return dict(g=g, rg=g.reverse(), jg=jg, jrg=jg.reverse(), pure=pure, glued=glued)


def rev_fill_both(jrg, reads, W):
    """(port, JAX) windowed reverse fills of ``reads`` (and the port's
    through S2's table) at width W."""
    jdg, dgr = port_rev_graph(jrg)
    table = ScoreMatrix.create("none", 2, -4).table
    seq, L = jax_encode.encode_reads(reads)
    ref = jax_rw._fill_pathwise_rev_win(jdg, jnp.asarray(table, jnp.int32), seq, L, W)
    args = (dgr, torch.as_tensor(table, dtype=torch.int32), torch.from_numpy(np.array(seq)),
            torch.from_numpy(np.array(L)), W)
    return (rw.fill_pathwise_rev_win_plain(*args), rw.fill_pathwise_rev_win_plain(*args, True),
            tuple(np.asarray(x) for x in ref), (dgr, args))


@pytest.mark.parametrize("graph", ["long", "leak"])
def test_plain_rev_win_fill_matches_jax(corpus, graph):
    if graph == "leak":
        cases = []
        for seed in (1, 2, 55):   # clone and constant-0 (ghost) lanes
            gf = fragment_gfa(seed)
            reads = fuzz.fragment_reads(random.Random(seed * 31 + 5), gf, k=3)
            # no read longer than W, W past Lp on two of the graphs
            cases.append((JaxPathGraph.from_gfa(gf).reverse(), reads, (16,)))
    else:
        # the reads of the records test: W 128 shares its JAX compile
        reads = corpus["pure"] + corpus["glued"]
        Lp = (max(map(len, reads)) + 7) // 8 * 8
        cases = [(corpus["jrg"], reads, (32, 128, Lp))]
    moved = 0
    for jrg, reads, widths in cases:
        for W in widths:
            got, via_table, ref, (dgr, args) = rev_fill_both(jrg, reads, W)
            for a, t, b in zip(got, via_table, ref):
                assert a.dtype == torch.int32
                np.testing.assert_array_equal(a.numpy(), b)
                np.testing.assert_array_equal(t.numpy(), b)
            moved += len(np.unique(ref[1])) > 2
            if graph == "long" and W == args[2].shape[1]:
                # at full coverage the windows stay at 0 and the reads'
                # cells equal the full-width reverse fill
                assert (ref[1] == 0).all()
                full = rec.fill_pathwise_rev_plain(dgr, *args[1:4], True).numpy()
                for b, Lb in enumerate(args[3].tolist()):
                    np.testing.assert_array_equal(ref[0][b, :, :, 1:Lb], full[b, :, :, 1:Lb])
    if graph == "long":
        assert moved == 2   # W 32 and 128 move the windows


def test_full_from_win_and_composite_bound_match_jax(corpus):
    rng = np.random.default_rng(7)
    B, n, W, Lp = 3, 5, 16, 48
    Xw = rng.integers(-50, 50, size=(B, n, W)).astype(np.int32)
    ws = (rng.integers(0, (Lp - W) // 8 + 1, size=(B, n)) * 8).astype(np.int32)
    for fill in (rec.NEG, 0):
        ref = jax_rw.full_from_win(jnp.asarray(Xw), jnp.asarray(ws),
                                   jnp.full((B, 1, Lp), fill, jnp.int32))
        got = rw.full_from_win(torch.from_numpy(Xw), torch.from_numpy(ws), fill, Lp)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    F, G = (np.where(rng.random((B, Lp)) < 0.3, rec.NEG,
                     rng.integers(-99, 99, (B, Lp))).astype(np.int32) for _ in range(2))
    Rf = np.array([-40, rec.NEG, 3], np.int32)
    Rr = np.array([-7, -60, rec.NEG], np.int32)
    L = np.array([48, 30, 9], np.int32)
    for smax in (0, 2):
        ref = jax_rw.composite_bound(*(jnp.asarray(x) for x in (F, G, Rf, Rr, L)), jnp.int32(smax))
        got = rw.composite_bound(*(torch.from_numpy(x) for x in (F, G, Rf, Rr, L)), smax)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_windowed_walk_reverse_matches_jax_on_expanded_planes(corpus):
    """The port's windowed reverse walk equals JAX's walk over the plane
    ``full_from_win`` expands (which reads base j + 1); JAX's own ``ws=``
    walk reads base min(j + 1, W - 1) and departs from it past column W."""
    reads = corpus["glued"]
    W = 32
    _, dgr = port_rev_graph(corpus["jrg"])
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table, dtype=torch.int32)
    seq, L = encode.encode_reads(reads)
    Awr, wsr, _ = rw.fill_pathwise_rev_win_plain(dgr, table, seq, L, W)
    B, n = wsr.shape
    rp = torch.tensor([0, 1], dtype=torch.int32)
    plane = Awr[torch.arange(B), rp.long()]
    si = torch.full((B,), n // 2, dtype=torch.int32)
    sj = wsr[torch.arange(B), si.long()] + 1
    succ = dgr.pred_of.t()[rp.long()]
    max_steps = n + seq.shape[1] + 4
    got = rec.walk_reverse(plane, seq, L, table, dgr.node_start, dgr.codes, succ, si, sj, True,
                           max_steps, ws=wsr)
    jargs = (seq.numpy(), L.numpy(), table.numpy(), np.asarray(corpus["rg"].node_start),
             dgr.codes.numpy(), succ.numpy(), si.numpy(), sj.numpy())
    full = jax_rw.full_from_win(jnp.asarray(plane.numpy()), jnp.asarray(wsr.numpy()),
                                jnp.full((B, 1, seq.shape[1]), rec.NEG, jnp.int32))
    ref = jax_rec._walk_reverse(full, *(jnp.asarray(x) for x in jargs), global_mode=True,
                                max_steps=max_steps)
    ref_ws = jax_rec._walk_reverse(jnp.asarray(plane.numpy()), *(jnp.asarray(x) for x in jargs),
                                   global_mode=True, max_steps=max_steps,
                                   ws=jnp.asarray(wsr.numpy()))
    for a, b in zip(got, ref):
        k = a.shape[1] if a.dim() > 1 else None
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[:, :k] if k else np.asarray(b))
    assert (np.asarray(ref_ws[0]) != np.asarray(ref[0])).any()   # F4


def _seed_hints(corpus, monkeypatch):
    """Both packages' window hints: only this graph's mode-8 ladder, at W0
    (fresh dicts for the test, the modules' own restored after it)."""
    jdg = jax_encode.path_device_graph(corpus["jg"])
    monkeypatch.setattr(jax_pe, "_pw_w_hint",
                        {jax_pe._graph_hint_key(corpus["jg"], jdg) + ("rec8",): W0})
    dg = encode.path_device_graph(corpus["g"], "cpu")
    monkeypatch.setattr(pathwise_engine, "_pw_w_hint",
                        {pathwise_engine._graph_hint_key(corpus["g"], dg) + ("rec8",): W0})


def _port_records(corpus, reads, **kw):
    return [r.to_string() for r in rec.run_batch_walks(
        8, reads, corpus["g"], corpus["rg"], ScoreMatrix.create("none", 2, -4), *COSTS, "cpu",
        **kw)]


def test_windowed_records_match_jax(corpus, monkeypatch):
    """The pure reads equal the full-width run; all four equal JAX's
    windowed run with its reverse walk over the expanded plane (F4), the
    counters too; the glued reads take the documented caveat (0 and 4)
    and the rescore refusal with the full-width rerun (0 and 3)."""
    reads = corpus["pure"] + corpus["glued"]
    full = _port_records(corpus, reads, no_window=True)
    monkeypatch.setattr(pathwise_engine, "LONG_READ_LP", 128)
    monkeypatch.setattr(jax_pe, "LONG_READ_LP", 128)
    monkeypatch.setenv("RECGRAPH_REC_WINDOW", "1")
    walk = jax_rec._walk_reverse

    def expanded(plane, seq, *a, ws=None, **kw):
        if ws is not None:
            plane = jax_rw.full_from_win(
                plane, ws, jnp.full((plane.shape[0], 1, seq.shape[1]), rec.NEG, jnp.int32))
        return walk(plane, seq, *a, **kw)

    monkeypatch.setattr(jax_rec, "_walk_reverse", expanded)
    _seed_hints(corpus, monkeypatch)
    jax_metrics.FALLBACKS.clear()
    ref = [r.to_string() for r in jax_rec.run_batch_walks(
        8, reads, corpus["jg"], corpus["jrg"], JaxScoreMatrix.create("none", 2, -4), *COSTS)]
    _seed_hints(corpus, monkeypatch)
    metrics.reset_phases()
    got = _port_records(corpus, reads)
    assert got == ref
    assert metrics.PHASES["fill"] > 0
    for name in ("rec_win_rescore", "rec_win_fullwidth"):
        assert metrics.EVENTS[name] == jax_metrics.FALLBACKS[name]
    assert got[:2] == full[:2]
    assert metrics.EVENTS["rec_win_rescore"] > 0 and metrics.EVENTS["rec_win_fullwidth"] == 1
    assert got[2] != full[2] and got[3] == full[3]   # the caveat; the rerun


def test_gate(corpus, monkeypatch):
    """The window runs only in mode 8, with the variable at 1, on reads
    of at least LONG_READ_LP columns and without ``no_window``."""
    class Routed(Exception):
        pass

    def routed(*a, **k):
        raise Routed

    monkeypatch.setattr(rec, "_run_batch_walks_win8", routed)
    monkeypatch.setattr(pathwise_engine, "LONG_READ_LP", 128)
    g, rg, sm = corpus["g"], corpus["rg"], ScoreMatrix.create("none", 2, -4)
    reads = [corpus["pure"][0][:130]]
    run = lambda mode, **kw: rec.run_batch_walks(mode, reads, g, rg, sm, *COSTS, "cpu", **kw)
    monkeypatch.delenv("RECGRAPH_REC_WINDOW", raising=False)
    assert len(run(8)) == 1
    monkeypatch.setenv("RECGRAPH_REC_WINDOW", "1")
    assert len(run(9)) == 1
    assert len(run(8, no_window=True)) == 1
    with pytest.raises(Routed):
        run(8)
    monkeypatch.setattr(pathwise_engine, "LONG_READ_LP", 1024)
    assert len(run(8)) == 1
    monkeypatch.setenv("RECGRAPH_REC_WINDOW", "true")
    monkeypatch.setattr(pathwise_engine, "LONG_READ_LP", 128)
    assert len(run(8)) == 1


@pytest.mark.parametrize("mode", [8, 9])
def test_split_full_matches_jax_and_guided(corpus, monkeypatch, mode):
    """The full scan (``RECGRAPH_SPLIT_FULL``) on the corpus's four reads,
    the glued ones recombining: its candidate columns, and its outputs
    equal to JAX's scan, the guided search and the scan in chunks of 128
    reverse rows; the dispatcher's Lp - 2 <= 8 route; in mode 8, through
    the engine, the records of the guided search."""
    g, rg, jg = corpus["g"], corpus["rg"], corpus["jg"]
    reads = corpus["pure"] + corpus["glued"]
    R, r, rbw = COSTS
    sm = ScoreMatrix.create("none", 2, -4)
    table = torch.as_tensor(sm.table, dtype=torch.int32)
    seq, L = encode.encode_reads(reads)
    Lp = seq.shape[1]
    Af = pathwise_engine.fill_pathwise_plain(encode.path_device_graph(g), table, seq, mode == 9)
    Ar = rec.fill_pathwise_rev_plain(encode.rev_device_graph(rg), table, seq, L, mode == 8)
    init_best, _ = rec._baseline(mode, pathwise_engine._final_column(Af, L).numpy(), g)
    oob = np.maximum((L.numpy() * (1.0 - rbw) / 2.0).astype(np.int64), 1)
    jcol = np.arange(Lp)
    active = (jcol[None, :] >= oob[:, None]) & (jcol[None, :] < (L.numpy() - oob)[:, None])
    inputs = rec.split_inputs(Af, Ar, torch.from_numpy(g.paths_nodes))
    geom = rec._SplitGeometry(g, rg)
    jgeom = jax_rec._SplitGeometry(jg, corpus["jrg"])
    jin = tuple(jnp.asarray(x.numpy()) for x in inputs)
    cols = rec._candidate_columns(inputs, geom, R, r, active, init_best, Lp)
    ref_cols = jax_rec._candidate_columns(jin, jgeom.dfs_i, jgeom.dfe_i, R, r, active, init_best,
                                          Lp)
    assert (cols is None) == (ref_cols is None)
    if cols is not None:
        np.testing.assert_array_equal(cols, ref_cols)
    scan = np.arange(1, Lp - 1, dtype=np.int32) if cols is None else cols
    I, B = g.n - 2, len(reads)
    ref = jax_rec._get_split(I, B)(jnp.asarray(scan), *jin, *jgeom.planes(R, r),
                                   jnp.asarray(active), jnp.asarray(init_best))
    planes = geom.planes(R, r, "cpu")
    got = rec.split_search_full(scan, inputs, planes, active, init_best)
    guided = rec._run_split_guided(inputs, geom, geom.tensors("cpu"), active, init_best, R, r)
    chunked = rec.split_search_full(scan, inputs, planes, active, init_best, Tc=128)
    for a, b, c, d in zip(got, ref, guided, chunked):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, d)
    assert got[1].any() and I > 128
    # _get_split's chunk rule
    assert rec.split_chunk(I, B) == I and rec.split_chunk(I, 4096) == 128
    jax_rec._get_split(10000, 2)
    assert (10000, rec.split_chunk(10000, 2)) in jax_rec._split_cache
    # Lp - 2 <= 8 (reads of at most 7 bases) takes the full scan without
    # the variable, as JAX's dispatcher does
    short = [x[:, :, :8].contiguous() for x in inputs]
    act8 = active[:, :8]
    monkeypatch.delenv("RECGRAPH_SPLIT_FULL", raising=False)
    metrics.reset_phases()
    got8 = rec._run_split(short, geom, geom.tensors("cpu"), act8, init_best, R, r, g.n, 8)
    full8 = rec.split_search_full(np.arange(1, 7), short, planes, act8, init_best)
    for a, c in zip(got8, full8):
        np.testing.assert_array_equal(a, c)
    assert metrics.EVENTS["split_rounds"] == 0
    if mode == 9:
        return
    # through the engine: the guided search's records
    metrics.reset_phases()
    run = lambda: [x.to_string() for x in rec.run_batch_walks(mode, corpus["glued"], g, rg, sm,
                                                                *COSTS, "cpu")]
    default = run()
    assert metrics.EVENTS["split_rounds"] > 0
    monkeypatch.setenv("RECGRAPH_SPLIT_FULL", "1")
    metrics.reset_phases()
    assert run() == default
    assert metrics.EVENTS["split_rounds"] == 0   # the guided search did not run
