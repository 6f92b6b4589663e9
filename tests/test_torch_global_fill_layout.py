"""The host side of the mode-0 fill K1 and the windowed mode-2 fill K6 on
the CPU.

K1 and K6 take K5's warp layout (``cuda_poa_gap_local.plan``: the warps a
read, the columns a lane, the register or full form; one read a block;
K6's over its W stored columns), checked here at the launch shapes of
``chip_smoke.py``'s CLI runs and at each form's edges.  Both keep K4's
rows in the device scratch (``stored_rows(..., every_row=True)``).  K6
solves each row's (M, X) recurrence with K4's chain on the row's window
(``poa_gap_engine.x_chain_band_plain`` with ``ws``); the plain windowed
fill with ``chain=`` mirrors it and is held here to the JAX engine's
windowed fill for both signs of the penalties, on windows that move by
+8, by -8 and back by more than their width, with reads that overflow,
and past the prefix maximum's range (the clamped chain).  K1's row 0 sums
sm('-', seq[j]) where the other rows sum sm(seq[j], '-'): an asymmetric
table pins it.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recgraph_tpu.graph.poagraph import PoaGraph as JaxPoaGraph
from recgraph_tpu.ops import poa_engine as jax_engine
from recgraph_tpu.ops import poa_gap_engine as jax_gap
from recgraph_tpu.scoring import ScoreMatrix
from recgraph_tpu_torch import fuzz
from recgraph_tpu_torch.graph.poagraph import PoaGraph
from recgraph_tpu_torch.ops import cuda_poa_gap_global as k4
from recgraph_tpu_torch.ops import cuda_poa_gap_local as k5
from recgraph_tpu_torch.ops import poa_engine, poa_gap_engine
from recgraph_tpu_torch.ops.encode import poa_device_graph

from test_fuzz_random_graphs import random_gfa, random_read
from test_torch_gap_fill import GLOBAL_NAMES, _case
from test_torch_poa_fill import _assert_outputs_equal, _inputs

torch.set_num_threads(1)
H100_SMS = 132
Plan = k5.Plan
WIN_NAMES = GLOBAL_NAMES + ["ws"]


def test_plan_at_main_path_shapes():
    """The smoke's launch shapes: K1 on 3,047 and 859 stretch reads (one
    warp a read of 5 columns a lane), K6 on 437 long reads at W 256 (two
    warps) and on 219, 218 and 75 at W 512 (four warps)."""
    for B, width, want in ((3047, 152, Plan(1, 5, False)), (859, 152, Plan(1, 5, False)),
                           (437, 256, Plan(2, 5, False)), (219, 512, Plan(4, 5, False)),
                           (218, 512, Plan(4, 5, False)), (75, 512, Plan(4, 5, False))):
        pl = k5.plan(B, width, H100_SMS)
        assert pl == want, (B, width)
        assert 32 * pl.warps * pl.cw >= width and 32 * pl.warps <= k5.MAX_THREADS


def test_plan_at_layout_edges():
    """The edges the ``cuda`` tests launch K1 and K6 at: K1 at 1, 32, 224
    (one warp of 1, 1 and 7 columns a lane), 225 (two warps) and 3,585
    columns (the full form); K6 at the smallest windows (8 and 16: one
    column a lane) and at W 4,096 (the full form over the window)."""
    assert k5.plan(6, 1, H100_SMS) == Plan(1, 1, False)
    assert k5.plan(6, 32, H100_SMS) == Plan(1, 1, False)
    assert k5.plan(6, 224, H100_SMS) == Plan(1, 7, False)
    assert k5.plan(6, 225, H100_SMS) == Plan(2, 5, False)
    assert k5.plan(6, 3585, H100_SMS) == Plan(16, 9, True)
    assert k5.plan(4, 8, H100_SMS) == k5.plan(4, 16, H100_SMS) == Plan(1, 1, False)
    assert k5.plan(4, 4096, H100_SMS) == Plan(16, 9, True)


def test_stored_rows_on_a_bubble():
    """On a two-arm bubble K1 and K6 store exactly the far predecessors:
    the flank's last row (the second arm's first row follows the first
    arm's last) and the first arm's last row (the join row's row i-1 is
    the second arm's last)."""
    dg = poa_device_graph(PoaGraph.from_gfa(fuzz.bubble_gfa(20, 6, seed=3)), "cpu")
    store_at, srow, S = k5.stored_rows(dg, every_row=True)
    h = dg.host()
    pidx, mask = np.asarray(h["pred_idx"]), np.asarray(h["pred_mask"])
    far = {int(p) for i in range(dg.n) for p, ok in zip(pidx[i], mask[i]) if ok and p != i - 1}
    assert far == {6, 26} and S == 2
    assert {int(r) for r in torch.nonzero(store_at >= 0).flatten()} == far


def _shift_case(name):
    """(graph, reads, btas, W) whose windows move by +8 and by -8 (a random
    graph: rows of other branches lie between a row and its predecessor)
    or back by more than W (the bubble), with one overflowing read."""
    if name == "bubble":
        gf = fuzz.bubble_gfa(40, 12, seed=3)
        rng = random.Random(5)
        reads = [fuzz.random_read(rng, gf) for _ in range(3)]
        return JaxPoaGraph.from_gfa(gf), reads, [1, 2, 60], 32
    rng = random.Random(54)
    gf = random_gfa(rng, n_nodes=20, n_paths=6, cover_all=True)
    reads = [random_read(rng, gf) for _ in range(4)]
    reads.append("$" + "".join(rng.choice("ACGT") for _ in range(120)))   # overflows
    return JaxPoaGraph.from_gfa(gf), reads, [1, 3, 9, 20, 1], 32


@pytest.mark.parametrize("name", ["random", "bubble"])
def test_windowed_chain_fill_matches_jax(name):
    """The windowed mode-2 fill through K6's chain (prefix-max and
    clamped) equals the JAX engine's windowed fill on every output, for
    both signs of the gap open, on windows that move by +8 and -8, back
    by more than W, and with a read that overflows its window."""
    g, reads, btas, W = _shift_case(name)
    jx, pt = _inputs(g, reads, btas, ScoreMatrix.create("none", 2, -4))
    for o, e in ((-4, -2), (1, -2)):
        ref = jax_gap._fill_gap_global_windowed(*jx, jnp.int32(o), jnp.int32(e), W=W)
        ws = np.asarray(ref[8])[:, :-1]
        d = ws[:, 1:] - ws[:, :-1]
        assert np.asarray(ref[9]).any()
        if name == "bubble":
            assert (d <= -W).any()
        else:
            assert (d == 8).any() and (d == -8).any()
        for chain in (True, "clamped"):
            got = poa_gap_engine.fill_gap_global_windowed_plain(*pt, o, e, W, chain=chain)
            _assert_outputs_equal(got[:9], ref[:9], WIN_NAMES)
            np.testing.assert_array_equal(got[9].numpy(), np.asarray(ref[9]))


def test_windowed_clamped_chain_past_range():
    """Past K4's range ((|o| + |e|) (2n + 2Lp + 2) >= 2^26) the windowed
    fill's clamped chain, what K6 runs there, equals the JAX engine's
    windowed fill (and the plain map scan), W = 32."""
    g, reads, btas, W = _shift_case("random")
    jx, pt = _inputs(g, reads, btas, ScoreMatrix.create("none", 2, -4))
    n, Lp = pt[0].n, pt[2].shape[1]
    o, e = -((1 << 26) // (2 * n + 2 * Lp + 2)) - 1, -1
    assert not k4.check_chain_range(o, e, n, Lp)
    ref = jax_gap._fill_gap_global_windowed(*jx, jnp.int32(o), jnp.int32(e), W=W)
    for chain in (False, "clamped"):
        got = poa_gap_engine.fill_gap_global_windowed_plain(*pt, o, e, W, chain=chain)
        _assert_outputs_equal(got[:9], ref[:9], WIN_NAMES)


def test_window_chain_keeps_column_0_absolute():
    """``x_chain_band_plain`` on a window (``ws``) gives the 2x2 map scan's
    m and x on every band column of the window, with bands that start at
    the window's first column past column 0 (there c~[left] = c[left]),
    at column 0, and that run past the window's end, for both signs."""
    rng = np.random.default_rng(3)
    B, W = 6, 24
    for o, e in ((-4, -2), (1, -2), (-5, -(1 << 23))):
        c = torch.from_numpy(rng.integers(-80, 60, size=(B, W)).astype(np.int32))
        ws = torch.tensor([0, 8, 16, 40, 0, 24], dtype=torch.int32)
        left = ws + torch.tensor([0, 0, 3, 7, 5, 0], dtype=torch.int32)
        right = left + torch.tensor([10, 30, 4, 0, 19, 40], dtype=torch.int32)
        x_left = torch.from_numpy(rng.integers(-30, 5, size=B).astype(np.int32))
        j = ws[:, None] + torch.arange(W)[None, :]
        in_band = (j >= left[:, None]) & (j < right[:, None])
        is_left = j == left[:, None]
        c_left = c.gather(1, (left - ws).long()[:, None])[:, 0]
        m_left = torch.where(left == 0, x_left, torch.maximum(c_left, x_left))
        ref = poa_gap_engine._affine_row_scan(c, torch.stack([m_left, x_left], -1), is_left,
                                              in_band, o, e)
        for clamped in ((True,) if abs(e) > 100 else (False, True)):
            got = poa_gap_engine.x_chain_band_plain(c, x_left, left, right, o, e, clamped, ws=ws)
            for a, b in zip(got, ref):
                assert torch.equal(torch.where(in_band, a, 0), torch.where(in_band, b, 0)), \
                    (o, e, clamped)


def _asymmetric(sm):
    """The table with sm('-', x) != sm(x, '-') for every base x."""
    tab = np.array(sm.table, dtype=np.int32)
    gap = poa_engine.GAP
    tab[gap, :4] = [-3, -5, -2, -6]
    tab[:4, gap] = [-4, -1, -7, -3]
    return tab


@pytest.mark.parametrize("case", ["example", "random31"])
def test_global_fill_asymmetric_table_matches_jax(example_paths, case):
    """K1's plain fill equals the JAX engine's mode-0 fill with a table
    whose gap row and gap column differ (row 0's gap sums are its own),
    with bands from column 0 on every row of one read (band slack 1,000),
    among them rows whose min_pred is not their row i-1 (the base case
    reads m[min_pred] at its band start)."""
    g, reads, _ = _case(case, example_paths)
    btas = [1000] + [int(1 + 0.01 * len(s)) for s in reads[1:]]
    jx, pt = _inputs(g, reads, btas, ScoreMatrix.create("none", 2, -4))
    tab = _asymmetric(ScoreMatrix.create("none", 2, -4))
    jx = (jx[0], jnp.asarray(tab), *jx[2:])
    pt = (pt[0], torch.from_numpy(tab), *pt[2:])
    ref = jax_engine._fill_global(*jx)
    got = poa_engine.fill_global_plain(*pt)
    _assert_outputs_equal(got, ref, ["score", "last_row", "last_col_abs", "packed", "lefts",
                                     "rights"])
    minp = np.asarray(pt[0].host()["min_pred"])
    far = [i for i in range(1, pt[0].n - 1) if minp[i] != i - 1]
    assert far and (got[4][0, far] == 0).all()
