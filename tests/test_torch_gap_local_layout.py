"""The host side of the mode-3 fill K5 on the CPU.

``cuda_poa_gap_local.plan`` lays out a launch: the warps a read, the
columns a lane and the register or full form (one read a block).  It is
checked at the launch shapes of ``chip_smoke.py``'s CLI runs and at the
edges of each form.  ``cuda_poa_gap_local.stored_rows`` picks the rows
whose m and y the kernel writes to its device scratch: every predecessor
of a start row other than its row i-1 (which the register form keeps in
registers), and no other row.  ``poa_gap_engine.x_chain_band_plain`` on
[0, Lp) from x = 0, the prefix-max form of the in-row (M, X) recurrence
that K5 computes, gives
the JAX engine's fill exactly, for both signs of the penalties; past the
range where that holds the wrapper takes the kernel's clamped chain.
"""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recgraph_tpu.ops import poa_gap_engine as jax_gap
from recgraph_tpu_torch import fuzz
from recgraph_tpu_torch.graph.poagraph import PoaGraph
from recgraph_tpu_torch.io import gfa
from recgraph_tpu_torch.ops import cuda_poa_gap_local as k5
from recgraph_tpu_torch.ops import poa_gap_engine
from recgraph_tpu_torch.ops.encode import poa_device_graph
from recgraph_tpu.scoring import ScoreMatrix

from test_torch_gap_fill import LOCAL_NAMES, _case
from test_torch_poa_fill import _assert_outputs_equal, _inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)
H100_SMS = 132


@pytest.mark.parametrize("B,Lp,warps,cw,full", [
    (1241, 152, 1, 5, False),     # stretch chunk, mode 3: a warp a read, all resident
    (72, 152, 1, 5, False),       # the stretch corpus' last chunk
    (46, 2440, 16, 5, False),     # long reads at full width: 16 warps a read
    (18, 2440, 16, 5, False),
])
def test_plan_at_main_path_shapes(B, Lp, warps, cw, full):
    pl = k5.plan(B, Lp, H100_SMS)
    assert (pl.warps, pl.cw, pl.full) == (warps, cw, full)
    assert 32 * pl.warps * pl.cw >= Lp                 # the warps cover the read
    assert pl.cw in (k5.CHAIN_COLS if not pl.full else (k5.FULL_COLS,))
    assert 32 * pl.warps <= k5.MAX_THREADS


def test_plan_at_layout_edges():
    """One warp up to 224 columns (the fewest odd columns a lane), w warps
    past it (5 columns a lane up to 16 x 160, then 7 up to 16 x 224), the
    full form (9 columns a lane) past that; one read a block whatever
    the reads."""
    sms = H100_SMS
    assert k5.plan(8, 2, sms) == k5.Plan(1, 1, False)        # a 1-bp read
    assert k5.plan(8, 32, sms) == k5.Plan(1, 1, False)
    assert k5.plan(8, 33, sms) == k5.Plan(1, 3, False)       # one column past a warp of 1
    assert k5.plan(8, 161, sms) == k5.Plan(1, 7, False)
    assert k5.plan(8, 224, sms) == k5.Plan(1, 7, False)
    assert k5.plan(8, 225, sms) == k5.Plan(2, 5, False)      # just past one warp a read
    assert k5.plan(8, 321, sms) == k5.Plan(3, 5, False)      # one column past 2 segments
    assert k5.plan(8, 2560, sms) == k5.Plan(16, 5, False)
    assert k5.plan(8, 2561, sms) == k5.Plan(12, 7, False)
    assert k5.plan(8, 3584, sms) == k5.Plan(16, 7, False)
    assert k5.plan(8, 3585, sms) == k5.Plan(16, 9, True)     # the full form: windows
    assert k5.plan(8, 41001, sms) == k5.Plan(16, 9, True)
    assert k5.plan(3047, 152, sms) == k5.Plan(1, 5, False)   # many reads: still one a block
    assert k5.plan(100000, 152, sms) == k5.Plan(1, 5, False)


def _far_preds(dg):
    """{(start row i, pred p) with p != i - 1} from the host arrays."""
    h = dg.host()
    pidx, mask, start = (np.asarray(h[k]) for k in ("pred_idx", "pred_mask", "node_start"))
    return {(i, int(p)) for i in range(dg.n) if start[i]
            for p, ok in zip(pidx[i], mask[i]) if ok and p != i - 1}


@pytest.mark.parametrize("name", ["example", "random"])
def test_stored_rows_flag_every_far_predecessor(name):
    """Every predecessor of a start row other than its row i-1 has a
    scratch row of its own, a slot reads it there, and no other row is
    stored; the full form stores every row."""
    if name == "example":
        g = PoaGraph.from_gfa(gfa.parse_gfa(os.path.join(ROOT, "example", "graph.gfa")))
    else:
        g = PoaGraph.from_gfa(fuzz.random_gfa(random.Random(41), n_nodes=60, n_paths=5,
                                              cover_all=True))
    dg = poa_device_graph(g, "cpu")
    store_at, srow, S = k5.stored_rows(dg)
    far = _far_preds(dg)
    stored = {int(r) for r in torch.nonzero(store_at >= 0).flatten()}
    assert stored == {p for _, p in far} and far
    assert S == len(stored)
    assert sorted(int(store_at[r]) for r in stored) == list(range(S))   # compact, one each
    pidx = np.asarray(dg.host()["pred_idx"])
    for i, q in zip(*torch.nonzero(srow >= 0, as_tuple=True)):
        i, q = int(i), int(q)
        assert (i, int(pidx[i, q])) in far
        assert int(srow[i, q]) == int(store_at[int(pidx[i, q])])
    assert int((srow >= 0).sum()) == sum(
        1 for i in range(dg.n) for q in range(pidx.shape[1])
        if (i, int(pidx[i, q])) in far and np.asarray(dg.host()["pred_mask"])[i, q])
    store_full, srow_full, S_full = k5.stored_rows(dg, full=True)
    assert S_full == dg.n and torch.equal(store_full, torch.arange(dg.n, dtype=torch.int32))
    assert torch.equal(srow_full, torch.where(dg.pred_mask, dg.pred_idx, -1).to(torch.int32))


def test_x_chain_matches_affine_scan():
    """The prefix-max chain gives the 2x2 (max,+) scan's m and x on
    random rows from column 0, both signs of the penalties."""
    rng = np.random.default_rng(11)
    B, W = 5, 41
    for o, e in ((-4, -2), (1, -2), (0, -1), (-3, -1), (2, 1), (-4, 3)):
        c = torch.from_numpy(rng.integers(0, 60, size=(B, W)).astype(np.int32))
        jcol = torch.arange(W)[None, :].expand(B, W)
        L = torch.from_numpy(rng.integers(2, W + 1, size=B))
        valid = jcol < L[:, None]
        ref = poa_gap_engine._affine_row_scan(c, torch.zeros((B, 2), dtype=torch.int32),
                                              jcol == 0, valid, o, e)
        zb = torch.zeros(B, dtype=torch.int32)
        got = poa_gap_engine.x_chain_band_plain(c, zb, zb, torch.full_like(zb, W), o, e)
        for a, b in zip(got, ref):
            keep = valid & (jcol > 0)
            assert torch.equal(torch.where(keep, a, 0), torch.where(keep, b, 0)), (o, e)


def test_chain_range_guard():
    """K5's wrapper selects its chain: the prefix-max chain while
    (|o| + |e|) x Lp < 2^27, the clamped chain from 2^27 on, where the
    reference's scan may clamp to NEG (the CLI's -O 100000 -E 1 from
    1,343 columns on: reads of 1,342 bp and their leading '$'); it no longer refuses a fill there."""
    assert k5.check_chain_range(-4, -2, 152)
    assert k5.check_chain_range(-(1 << 20), 0, (1 << 7) - 1)       # one below the limit
    assert k5.check_chain_range(3, -5, (1 << 24) - 1)
    assert k5.check_chain_range(-100000, -1, 1342)
    for o, e, Lp in ((-(1 << 20), 0, 1 << 7), (3, -5, 1 << 24), (1 << 26, 1 << 26, 1),
                     (-4, -2, 22369622), (-100000, -1, 1343)):
        assert not k5.check_chain_range(o, e, Lp)
    g = PoaGraph.from_gfa(gfa.parse_gfa(os.path.join(ROOT, "example", "graph.gfa")))
    dg = poa_device_graph(g, "cpu")
    seq = torch.zeros((1, 8), dtype=torch.int32)
    L = torch.full((1,), 8, dtype=torch.int32)
    table = torch.zeros((7, 7), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA"):   # past the range it goes to the card
        k5.fill_gap_local_cuda(dg, table, seq, L, -(1 << 24), -(1 << 24))


@pytest.mark.parametrize("matrix", ["none", "HOXD70"])
def test_chain_fill_matches_jax(example_paths, matrix):
    """The mode-3 fill through the chain form equals the JAX engine's
    fill on every output, on the example graph and a random one."""
    sm = ScoreMatrix.create(matrix, 2, -4)
    for case in ("example", "random31"):
        g, reads, btas = _case(case, example_paths)
        jx, pt = _inputs(g, reads, btas, sm)
        for o, e in ((-4, -2), (1, -2)):
            ref = jax_gap._fill_gap_local(*jx[:4], jnp.int32(o), jnp.int32(e))
            got = poa_gap_engine.fill_gap_local_plain(*pt[:4], o, e, chain=True)
            _assert_outputs_equal(got, ref, LOCAL_NAMES)
