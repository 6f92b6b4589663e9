"""The host side of the mode-2 fill K4 and the mode-1 fill K2 on the CPU.

K4 and K2 take K5's warp layout (``cuda_poa_gap_local.plan``: the warps a
read, the columns a lane, the register or full form; one read a block),
checked here at the launch shapes of ``chip_smoke.py``'s CLI runs and at
each form's edges.  ``cuda_poa_gap_local.stored_rows`` picks the rows whose
scratch rows the kernels write to device memory: for K4 every
predecessor of a row other than its row i-1 (``every_row``), for K2 K5's
rows (the far predecessors of start rows; a non-start row's one
predecessor is its row i-1).  ``poa_gap_engine.x_chain_band_plain``, the
banded prefix-max form of the in-row (M, X) recurrence that K4 computes,
and its clamped form give the reference's 2x2 map scan and the JAX
engine's fill exactly, for both signs of the penalties; the selectors
``cuda_poa_gap_global.check_chain_range`` and
``cuda_poa_gap_local.check_chain_range`` take the clamped chain past the
range where the prefix maximum is exact, where the plain fill's map scan
still equals the JAX fill.
"""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recgraph_tpu.graph.poagraph import PoaGraph as JaxPoaGraph
from recgraph_tpu.ops import poa_gap_engine as jax_gap
from recgraph_tpu.scoring import ScoreMatrix
from recgraph_tpu_torch import fuzz
from recgraph_tpu_torch.graph.poagraph import PoaGraph
from recgraph_tpu_torch.io import gfa
from recgraph_tpu_torch.ops import cuda_poa_gap_global as k4
from recgraph_tpu_torch.ops import cuda_poa_gap_local as k5
from recgraph_tpu_torch.ops import poa_gap_engine
from recgraph_tpu_torch.ops.encode import poa_device_graph

from test_fuzz_random_graphs import random_gfa, random_read
from test_torch_gap_fill import GLOBAL_NAMES, LOCAL_NAMES, _case
from test_torch_poa_fill import _assert_outputs_equal, _inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)
H100_SMS = 132
Plan = k5.Plan


def test_plan_at_main_path_shapes():
    """The smoke's launch shapes: K4 on stretch chunks of 1,241 and 72
    reads, K2 on 3,047 and 859 stretch reads (one warp a read, 5 columns
    a lane: every read's warp resident at once) and on 64 long reads at
    full width (16 warps of 5 columns a lane)."""
    for B, Lp, want in ((1241, 152, Plan(1, 5, False)), (72, 152, Plan(1, 5, False)),
                        (3047, 152, Plan(1, 5, False)), (859, 152, Plan(1, 5, False)),
                        (64, 2440, Plan(16, 5, False))):
        pl = k5.plan(B, Lp, H100_SMS)
        assert pl == want, (B, Lp)
        assert 32 * pl.warps * pl.cw >= Lp and 32 * pl.warps <= k5.MAX_THREADS


def test_plan_at_layout_edges():
    """The edges the ``cuda`` tests launch K2 and K4 at: 1 column (one
    column a lane), 224 (one warp of 7 columns a lane), 225 (two warps),
    3,584 (16 warps of 7) and 3,585 (the full form in one window of
    4,608 columns), 4,904 (two windows)."""
    assert k5.plan(5, 1, H100_SMS) == Plan(1, 1, False)
    assert k5.plan(6, 224, H100_SMS) == Plan(1, 7, False)
    assert k5.plan(6, 225, H100_SMS) == Plan(2, 5, False)
    assert k5.plan(6, 3584, H100_SMS) == Plan(16, 7, False)
    assert k5.plan(6, 3585, H100_SMS) == Plan(16, 9, True)
    full = k5.plan(2, 4904, H100_SMS)
    assert full.full and -(-4904 // (32 * full.warps * full.cw)) == 2


def _graph(name):
    if name == "example":
        return PoaGraph.from_gfa(gfa.parse_gfa(os.path.join(ROOT, "example", "graph.gfa")))
    return PoaGraph.from_gfa(fuzz.random_gfa(random.Random(41), n_nodes=60, n_paths=5,
                                             cover_all=True))


@pytest.mark.parametrize("name", ["example", "random"])
def test_stored_rows_k4_every_far_predecessor(name):
    """K4 stores every row that some row (start or not) lists as a
    predecessor other than its row i-1, once, and reads it there; the
    full form stores every row."""
    dg = poa_device_graph(_graph(name), "cpu")
    h = dg.host()
    pidx, mask = np.asarray(h["pred_idx"]), np.asarray(h["pred_mask"])
    far = {(i, int(p)) for i in range(dg.n) for p, ok in zip(pidx[i], mask[i])
           if ok and p != i - 1}
    store_at, srow, S = k5.stored_rows(dg, every_row=True)
    stored = {int(r) for r in torch.nonzero(store_at >= 0).flatten()}
    assert stored == {p for _, p in far} and far and S == len(stored)
    assert sorted(int(store_at[r]) for r in stored) == list(range(S))
    for i, q in zip(*np.nonzero(mask)):
        want = int(store_at[pidx[i, q]]) if (int(i), int(pidx[i, q])) in far else -1
        assert int(srow[i, q]) == want
    assert not (srow[~torch.as_tensor(mask)] >= 0).any()
    store_full, srow_full, S_full = k5.stored_rows(dg, full=True, every_row=True)
    assert S_full == dg.n and torch.equal(store_full, torch.arange(dg.n, dtype=torch.int32))


def test_stored_rows_k2_is_k5s():
    """K2 keeps K5's rows (the far predecessors of start rows): every
    non-start row's one predecessor is its row i-1, which both keep in
    registers; K4's set holds K5's."""
    for name in ("example", "random"):
        dg = poa_device_graph(_graph(name), "cpu")
        h = dg.host()
        pidx, mask, start = (np.asarray(h[k]) for k in ("pred_idx", "pred_mask", "node_start"))
        for i in range(1, dg.n - 1):
            if not start[i]:
                assert [int(p) for p, ok in zip(pidx[i], mask[i]) if ok] == [i - 1], (name, i)
        k5_rows = set(torch.nonzero(k5.stored_rows(dg)[0] >= 0).flatten().tolist())
        k4_rows = set(torch.nonzero(k5.stored_rows(dg, every_row=True)[0] >= 0)
                      .flatten().tolist())
        assert k5_rows <= k4_rows


def test_x_chain_band_matches_affine_scan():
    """K4's banded chain, prefix-max and clamped, gives the 2x2 (max,+)
    scan's m and x on every band column, for random bands (from column 0
    and past it, empty ones too), both signs of the penalties; the
    clamped form also where the scan's clamp acts (e = -2^23)."""
    rng = np.random.default_rng(12)
    B, W = 6, 37
    j = torch.arange(W)[None, :]
    for o, e in ((-4, -2), (1, -2), (0, -1), (-3, -1), (2, 1), (-4, 3), (-5, -(1 << 23))):
        c = torch.from_numpy(rng.integers(-80, 60, size=(B, W)).astype(np.int32))
        left = torch.from_numpy(rng.integers(0, 8, size=B).astype(np.int32))
        left[0] = 0
        right = torch.minimum(left + torch.from_numpy(rng.integers(0, W, size=B)).to(torch.int32),
                              torch.tensor(W, dtype=torch.int32))
        x_left = torch.from_numpy(rng.integers(-30, 5, size=B).astype(np.int32))
        in_band = (j >= left[:, None]) & (j < right[:, None])
        is_left = j == left[:, None]
        c_left = c.gather(1, left.long()[:, None].clamp(max=W - 1))[:, 0]
        m_left = torch.where(left == 0, x_left, torch.maximum(c_left, x_left))
        ref = poa_gap_engine._affine_row_scan(c, torch.stack([m_left, x_left], -1), is_left,
                                              in_band, o, e)
        forms = (True,) if abs(e) > 100 else (False, True)
        for clamped in forms:
            got = poa_gap_engine.x_chain_band_plain(c, x_left, left, right, o, e, clamped)
            for a, b in zip(got, ref):
                assert torch.equal(torch.where(in_band, a, 0), torch.where(in_band, b, 0)), \
                    (o, e, clamped)


@pytest.mark.parametrize("matrix", ["none", "HOXD70"])
def test_band_chain_fill_matches_jax(example_paths, matrix):
    """The mode-2 fill through K4's chain (prefix-max and clamped) equals
    the JAX engine's fill on every output, on two random graphs (one with
    12 predecessors in a row), for both signs of the gap open."""
    sm = ScoreMatrix.create(matrix, 2, -4)
    for case in ("random31", "random303"):
        g, reads, btas = _case(case, example_paths)
        jx, pt = _inputs(g, reads, btas, sm)
        for o, e in ((-4, -2), (1, -2)):
            ref = jax_gap._fill_gap_global(*jx, jnp.int32(o), jnp.int32(e))[:8]
            for chain in (True, "clamped"):
                got = poa_gap_engine.fill_gap_global_plain(*pt, o, e, chain=chain)
                _assert_outputs_equal(got, ref, GLOBAL_NAMES)


def test_chain_selectors():
    """K4 takes its prefix-max chain while (|o| + |e|) (2n + 2Lp + 2) <
    2^26, K5 while (|o| + |e|) Lp < 2^27; past that each takes its clamped
    chain: K4 at the CLI's penalties on the stretch (n 2,249, Lp 152) and
    long (n 3,798, Lp 2,440) corpora is fast, at -O 100000 -E 1 clamped
    on both; K5 at -O 100000 -E 1 clamped from 1,343 columns."""
    assert k4.check_chain_range(-4, -2, 2249, 152) and k4.check_chain_range(-4, -2, 3798, 2440)
    assert not k4.check_chain_range(-100000, -1, 2249, 152)
    assert not k4.check_chain_range(-100000, -1, 3798, 2440)
    X = 2 * 2249 + 2 * 152 + 2
    edge = (1 << 26) // X                       # |o| + |e| at the edge
    assert k4.check_chain_range(-(edge - 1), -1, 2249, 152) == ((edge * X) < (1 << 26))
    assert not k4.check_chain_range(-edge, -1, 2249, 152)
    assert k4.check_chain_range(3, 5, 2249, 152) and not k4.check_chain_range(1 << 21, 0, 10, 10)
    assert k5.check_chain_range(-4, -2, 2440) and k5.check_chain_range(-100000, -1, 1342)
    assert not k5.check_chain_range(-100000, -1, 1343)


def test_map_scan_fill_matches_jax_past_range():
    """Past K5's range the plain fill's 2x2 map scan (``chain=False``, what
    the cuda tests hold the clamped kernel to) and its clamped chain equal
    the JAX engine's fill: (o, e) = (-2^20, 0) on a read of 128 columns,
    (|o| + |e|) x Lp = 2^27, on a small random graph."""
    rng = random.Random(5)
    gf = random_gfa(rng, n_nodes=10, n_paths=3, cover_all=True)
    g = JaxPoaGraph.from_gfa(gf)
    reads = [random_read(rng, gf) for _ in range(2)] + ["$" + "ACGT" * 31 + "ACG"]
    jx, pt = _inputs(g, reads, [1] * len(reads), ScoreMatrix.create("none", 2, -4))
    o, e = -(1 << 20), 0
    assert pt[2].shape[1] == 128 and not k5.check_chain_range(o, e, 128)
    ref = jax_gap._fill_gap_local(*jx[:4], jnp.int32(o), jnp.int32(e))
    for chain in (False, "clamped"):
        got = poa_gap_engine.fill_gap_local_plain(*pt[:4], o, e, chain=chain)
        _assert_outputs_equal(got, ref, LOCAL_NAMES)
