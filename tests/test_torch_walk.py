"""The port's on-device walk against the JAX walk on the same planes:
linear and gap-chain walks (modes 0-3), full-width and windowed planes.

Both walkers read the planes the JAX fills produce; compacted dirs/rows,
step counts, stop cells, the band verdict and query_start must agree
exactly.  The loop iteration count may differ (the port tests for the
end of all walks every few iterations), so it is not compared.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recgraph_tpu.graph.poagraph import PoaGraph
from recgraph_tpu.io import fasta, gfa
from recgraph_tpu.ops import encode as jax_encode
from recgraph_tpu.ops import poa_engine as jax_engine
from recgraph_tpu.ops import poa_gap_engine as jax_gap
from recgraph_tpu.ops import traceback_engine as jax_tb
from recgraph_tpu.scoring import ScoreMatrix
from recgraph_tpu_torch.ops import traceback_engine as tb

from test_fuzz_random_graphs import random_gfa, random_read

# the port's CPU path runs thousands of tiny ops; more intra-op threads only
# contend with the other test workers on the CPU
torch.set_num_threads(1)


def _case(name, example_paths):
    if name == "example":
        seqs, _ = fasta.get_sequences(example_paths[0])
        return PoaGraph.from_gfa(gfa.parse_gfa(example_paths[1])), seqs[:10]
    rng = random.Random(int(name[len("random"):]))
    gf = random_gfa(rng, n_nodes=20, cover_all=True)
    return PoaGraph.from_gfa(gf), [random_read(rng, gf) for _ in range(6)]


def _compact_all(dirs, rows, steps):
    d, r = np.asarray(dirs), np.asarray(rows)
    return [tb.compact_walk(d[b], r[b], int(steps[b])) for b in range(d.shape[0])]


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("case", ["example", "random21", "random22"])
def test_walk_matches_jax(example_paths, case, mode):
    g, reads = _case(case, example_paths)
    # a narrow band on odd reads makes some band checks fail
    btas = [int(1 + 0.01 * len(s)) if k % 2 else 1 for k, s in enumerate(reads)]
    dg = jax_encode._build_poa_device_graph(g)
    seq, L = jax_encode.encode_reads(reads)
    table = jnp.asarray(ScoreMatrix.create("none", 2, -4).table)
    W = jax_tb.max_walk_steps(dg.n, seq.shape[1])
    if mode == 0:
        bta = jax_encode.encode_read_aux(btas)
        score, last_row, last_col, packed, lefts, rights = jax_engine._fill_global(
            dg, table, seq, L, bta)
        band = (lefts, rights, L)
    else:
        score, last_row, last_col, packed = jax_engine._fill_local(dg, table, seq, L)
        band = None
    ref = jax_tb.walk_poa(packed, packed, packed, last_row, last_col, gap=False,
                          max_steps=W, band=band)
    t = lambda x: torch.from_numpy(np.array(x))
    got = tb.walk_poa(t(packed), t(last_row), t(last_col), W,
                      band=None if band is None else tuple(map(t, band)))
    _assert_walks_equal(got, ref, W, banded=mode == 0)


def _assert_walks_equal(got, ref, W, banded):
    dirs, rows, steps, stop_row, stop_col, band_ok, qstart, it = got
    assert it <= W
    for name, a, b in (("steps", steps, ref[2]), ("stop_row", stop_row, ref[3]),
                       ("stop_col", stop_col, ref[4]), ("qstart", qstart, ref[6])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    if banded:
        np.testing.assert_array_equal(band_ok.numpy(), np.asarray(ref[5]))
    else:
        assert band_ok is None and ref[5] is None
    for (d, r), (dj, rj) in zip(_compact_all(dirs, rows, steps),
                                _compact_all(ref[0], ref[1], ref[2])):
        np.testing.assert_array_equal(d, dj)
        np.testing.assert_array_equal(r, rj)
    # the int32 wire format round-trips through the host unpack
    pk = tb.pack_walk32(dirs[:, :it], rows[:, :it]).numpy()
    ud, ur = tb.unpack_walk(pk)
    keep = dirs[:, :it].numpy() != -1
    np.testing.assert_array_equal(ud[keep], dirs[:, :it].numpy()[keep])
    np.testing.assert_array_equal(ur[keep], rows[:, :it].numpy()[keep])


@pytest.mark.parametrize("mode", [2, 3])
def test_gap_walk_matches_jax(example_paths, mode):
    """Gap chains: X/Y enter, continue and exit, CHAIN_FLAG steps, and the
    band check that skips chain-interior cells."""
    for case in ("example", "random21", "random22"):
        _check_gap_walk(example_paths, case, mode)


def _check_gap_walk(example_paths, case, mode):
    g, reads = _case(case, example_paths)
    btas = [int(1 + 0.01 * len(s)) if k % 2 else 1 for k, s in enumerate(reads)]
    dg = jax_encode._build_poa_device_graph(g)
    seq, L = jax_encode.encode_reads(reads)
    table = jnp.asarray(ScoreMatrix.create("none", 2, -4).table)
    W = jax_tb.max_walk_steps(dg.n, seq.shape[1])
    # a cheap gap open makes long gap chains
    o, e = jnp.int32(-1), jnp.int32(-1)
    if mode == 2:
        out = jax_gap._fill_gap_global(
            dg, table, seq, L, jax_encode.encode_read_aux(btas), o, e)
        score, last_row, last_col, packed, px, py, lefts, rights = out[:8]
        band = (lefts, rights, L)
    else:
        score, last_row, last_col, packed, px, py = jax_gap._fill_gap_local(
            dg, table, seq, L, o, e)
        band = None
    ref = jax_tb.walk_poa(packed, px, py, last_row, last_col, gap=True,
                          max_steps=W, band=band)
    t = lambda x: torch.from_numpy(np.array(x))
    got = tb.walk_poa(t(packed), t(last_row), t(last_col), W,
                      band=None if band is None else tuple(map(t, band)),
                      packed_x=t(px), packed_y=t(py))
    _assert_walks_equal(got, ref, W, banded=mode == 2)
    if mode == 2 and case == "example":   # a cheap gap open makes chains
        d = got[0]
        assert bool(((d >= 0) & (d != tb.HOLE) & (d & tb.CHAIN_FLAG != 0)).any())


@pytest.mark.parametrize("mode", [0, 2])
def test_windowed_walk_matches_jax(example_paths, mode):
    """Windowed planes: cells at col - ws[row], 'O' outside the window."""
    for case in ("example", "random21"):
        _check_windowed_walk(example_paths, case, mode)


def _check_windowed_walk(example_paths, case, mode):
    g, reads = _case(case, example_paths)
    btas = [1, 3, 9, 20, 2, 5, 1, 2, 3, 4][: len(reads)]
    dg = jax_encode._build_poa_device_graph(g)
    seq, L = jax_encode.encode_reads(reads)
    bta = jax_encode.encode_read_aux(btas)
    table = jnp.asarray(ScoreMatrix.create("none", 2, -4).table)
    steps = jax_tb.max_walk_steps(dg.n, seq.shape[1])
    if mode == 0:
        score, last_row, last_col, packed, lefts, rights, ws, _ = (
            jax_engine._fill_global_windowed(dg, table, seq, L, bta, W=32))
        px = py = packed
    else:
        score, last_row, last_col, packed, px, py, lefts, rights, ws, _ = (
            jax_gap._fill_gap_global_windowed(
                dg, table, seq, L, bta, jnp.int32(-4), jnp.int32(-2), W=32))
    band = (lefts, rights, L)
    ref = jax_tb.walk_poa(packed, px, py, last_row, last_col, gap=mode == 2,
                          max_steps=steps, ws=ws, band=band)
    t = lambda x: torch.from_numpy(np.array(x))
    gap = dict(packed_x=t(px), packed_y=t(py)) if mode == 2 else {}
    got = tb.walk_poa(t(packed), t(last_row), t(last_col), steps,
                      band=tuple(map(t, band)), ws=t(ws), **gap)
    _assert_walks_equal(got, ref, steps, banded=True)
