"""The port's windowed fills (long reads, modes 0 and 2) against the JAX
package's XLA windowed fills, and the W ladder against the full-width
fill, on the CPU.

Short reads at small windows (W = 32, 64) make both overflowing and
fitting reads occur cheaply.  Exact equality throughout: every output
is an int32 DP value, an index or a flag.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recgraph_tpu.graph.poagraph import PoaGraph
from recgraph_tpu.io.gfa import Gfa, GfaPath
from recgraph_tpu.ops import poa_engine as jax_engine
from recgraph_tpu.ops import poa_gap_engine as jax_gap
from recgraph_tpu.scoring import ScoreMatrix
from recgraph_tpu_torch.ops import cuda_poa_global_win, poa_engine, poa_gap_engine

from test_torch_gap_fill import GLOBAL_NAMES, _case
from test_torch_poa_fill import _assert_outputs_equal, _inputs

# the port's CPU path runs thousands of tiny ops; more intra-op threads only
# contend with the other test workers on the CPU
torch.set_num_threads(1)

WIN_NAMES = ["score", "last_row", "last_col_abs", "packed", "lefts", "rights", "ws"]


def _wide_band(case, example_paths):
    """A case whose bands vary from narrow to wider than the window."""
    g, reads, _ = _case(case, example_paths)
    return g, reads, [1, 3, 9, 20, 40, 2][: len(reads)]


@pytest.mark.parametrize("case", ["example", "random31", "random32"])
def test_fill_global_windowed_plain_matches_jax(example_paths, case):
    g, reads, btas = _wide_band(case, example_paths)
    sm = ScoreMatrix.create("none", 2, -4)
    jx, pt = _inputs(g, reads, btas, sm)
    for W in (32, 64):
        ref = jax_engine._fill_global_windowed(*jx, W=W)
        got = poa_engine.fill_global_windowed_plain(*pt, W)
        _assert_outputs_equal(got[:7], ref[:7], WIN_NAMES)
        np.testing.assert_array_equal(got[7].numpy(), np.asarray(ref[7]))
        assert got[7].dtype == torch.bool


@pytest.mark.parametrize("case", ["example", "random31", "random33"])
def test_fill_gap_global_windowed_plain_matches_jax(example_paths, case):
    g, reads, btas = _wide_band(case, example_paths)
    sm = ScoreMatrix.create("none", 2, -4)
    jx, pt = _inputs(g, reads, btas, sm)
    for W in (32, 64):
        for o, e in ((-4, -2), (1, -2)):
            ref = jax_gap._fill_gap_global_windowed(*jx, jnp.int32(o), jnp.int32(e), W=W)
            got = poa_gap_engine.fill_gap_global_windowed_plain(*pt, o, e, W)
            _assert_outputs_equal(got[:9], ref[:9], GLOBAL_NAMES + ["ws"])
            np.testing.assert_array_equal(got[9].numpy(), np.asarray(ref[9]))


def _long_case():
    """A 400-bp backbone with SNP bubbles, and three reads of it with 2 %
    substitutions: longer than the ladder's first window (W = 256)."""
    rng = random.Random(77)
    gf = Gfa()
    prev, backbone, nid = [], [], 0
    for k in range(50):
        nid += 1
        main = nid
        gf.segments[main] = "".join(rng.choice("ACGT") for _ in range(8))
        cur = [main]
        if k % 4 == 2:
            nid += 1
            gf.segments[nid] = "".join(rng.choice("ACGT") for _ in range(8))
            cur.append(nid)
        gf.edges += [(p, c) for p in prev for c in cur]
        backbone.append(main)
        prev = cur
    gf.paths.append(GfaPath("p0", backbone))
    g = PoaGraph.from_gfa(gf)
    ref = "".join(gf.segments[x] for x in backbone)
    reads = ["$" + "".join(rng.choice("ACGT") if rng.random() < 0.02 else c for c in ref)
             for _ in range(3)]
    return g, reads, [int(1 + 0.01 * len(s)) for s in reads]


def _assert_window_equals_full(full, win, ws, lefts, rights):
    for b in range(full.shape[0]):
        for i in range(full.shape[1]):
            lo, hi, w = int(lefts[b, i]), int(rights[b, i]), int(ws[b, i])
            if hi > lo:
                assert torch.equal(full[b, i, lo:hi], win[b, i, lo - w: hi - w]), (b, i)


@pytest.mark.parametrize("mode", [0, 2])
def test_ladder_equals_full_width_inside_band(mode):
    """The ladder settles on a window below Lp and gives the full-width
    fill's scores, end cells and band, and its planes inside the band."""
    g, reads, btas = _long_case()
    sm = ScoreMatrix.create("none", 2, -4)
    _, (dg, table, seq, L, bta) = _inputs(g, reads, btas, sm)
    assert seq.shape[1] > 256
    poa_engine._long_w_hint.clear()
    if mode == 0:
        full = poa_engine.fill_global_plain(dg, table, seq, L, bta)
        W, win = poa_engine.fill_global_long(dg, table, seq, L, bta, max(btas))
        planes = (3,)
    else:
        full = poa_gap_engine.fill_gap_global_plain(dg, table, seq, L, bta, -4, -2)
        W, win = poa_gap_engine.fill_gap_global_long(dg, table, seq, L, bta, max(btas), -4, -2)
        planes = (3, 4, 5)
    ws = win[-1]
    assert ws is not None and win[3].shape[2] == W == 256
    for k in (0, 1, 2, planes[-1] + 1, planes[-1] + 2):
        assert torch.equal(full[k], win[k]), k
    for k in planes:
        _assert_window_equals_full(full[k], win[k], ws, full[planes[-1] + 1],
                                   full[planes[-1] + 2])
    assert poa_engine._long_w_hint == {(mode, dg.n): 256}
    poa_engine._long_w_hint.clear()


@pytest.mark.parametrize("mode", [0, 2])
def test_ladder_splits_a_chunk_that_outgrows_the_budget(monkeypatch, mode):
    """A chunk sized for the ladder's first rung splits into parts that
    fit the budget once a rung widens past it; each part climbs on, and
    the walks equal those of the unsplit chunk."""
    g, reads, btas = _long_case()
    sm = ScoreMatrix.create("none", 2, -4)
    Lp = (max(map(len, reads)) + 7) // 8 * 8
    monkeypatch.setattr(poa_engine, "LONG_READ_LP", 256)  # these reads take the ladder
    mod = poa_engine if mode == 0 else poa_gap_engine
    name = "fill_global_windowed_plain" if mode == 0 else "fill_gap_global_windowed_plain"
    plain, calls = getattr(mod, name), []

    def record(*args):
        calls.append((args[2].shape[0], args[-1]))   # (reads, W)
        return plain(*args)

    monkeypatch.setattr(mod, name, record)
    poa_engine._long_w_hint.clear()
    whole = poa_engine.run_batch_walks(mode, reads, g, sm, -4, -2, btas, "cpu")
    assert calls == [(3, 256)]
    calls.clear()
    poa_engine._long_w_hint[(mode, g.n)] = 16
    monkeypatch.setitem(poa_engine.CHUNK_BYTES, "cpu",
                        3 * poa_engine.read_bytes(mode, g.n, Lp, 16))
    assert poa_engine.chunk_reads(mode, g.n, Lp, max(btas), "cpu") == 3
    split = poa_engine.run_batch_walks(mode, reads, g, sm, -4, -2, btas, "cpu")
    assert calls[0] == (3, 16) and len(calls) >= 4, calls
    assert all(b == 1 and W > 16 for b, W in calls[1:]), calls
    for a, b in zip(whole, split, strict=True):
        for f in ("score", "last_row", "last_col_abs", "stop_row", "query_start",
                  "band_check_ok"):
            assert getattr(a, f) == getattr(b, f), f
        assert (a.dirs == b.dirs).all() and (a.rows == b.rows).all()
    poa_engine._long_w_hint.clear()


def test_ladder_ends_at_full_width():
    """When no window below Lp fits, the ladder runs the full-width fill
    and returns ws = None; a too-small W sets the over flag."""
    g, reads, _ = _long_case()
    btas = [200] * len(reads)
    sm = ScoreMatrix.create("none", 2, -4)
    _, (dg, table, seq, L, bta) = _inputs(g, reads, btas, sm)
    poa_engine._long_w_hint.clear()
    W, out = poa_engine.fill_global_long(dg, table, seq, L, bta, max(btas))
    assert out[-1] is None and W == seq.shape[1]
    full = poa_engine.fill_global_plain(dg, table, seq, L, bta)
    for a, b in zip(out[:6], full):
        assert torch.equal(a, b)
    assert poa_engine._long_w_hint[(0, dg.n)] == seq.shape[1]
    assert bool(poa_engine.fill_global_windowed_plain(dg, table, seq, L, bta, 64)[7].all())
    with pytest.raises(ValueError, match="CUDA"):
        cuda_poa_global_win.fill_global_win_cuda(dg, table, seq, L, bta, 256)
    poa_engine._long_w_hint.clear()
