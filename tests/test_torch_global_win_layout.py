"""The host side of the windowed mode-0 fill K3 on the CPU, and its plain
version held to the JAX engine's windowed fill.

K3 is the window form of K1's kernel (``csrc/poa_global.cu``): it takes
K1's warp layout over its W stored columns (``cuda_poa_gap_local.plan(B,
W, sms)``), checked here at the launch shapes of ``chip_smoke.py``'s long
mode-0 run and at each form's edges, and keeps K1's rows in the device
scratch (``stored_rows(..., every_row=True)``), each at its own window
start.  The kernel is held on the card to
``poa_engine.fill_global_windowed_plain``; that plain version is held
here to ``recgraph_tpu``'s ``_fill_global_windowed`` on every output, on
windows that move by +8, by -8 and back by more than their width, with
reads that overflow their window, and with a table whose gap row and gap
column differ (row 0 sums sm('-', seq[j]), the other rows sm(seq[j],
'-')).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recgraph_tpu.ops import poa_engine as jax_engine
from recgraph_tpu.scoring import ScoreMatrix
from recgraph_tpu_torch import fuzz
from recgraph_tpu_torch.graph.poagraph import PoaGraph
from recgraph_tpu_torch.ops import cuda_poa_gap_local as k5
from recgraph_tpu_torch.ops import poa_engine
from recgraph_tpu_torch.ops.encode import poa_device_graph

from test_torch_global_fill_layout import _asymmetric, _shift_case
from test_torch_poa_fill import _assert_outputs_equal, _inputs

torch.set_num_threads(1)
H100_SMS = 132
Plan = k5.Plan
NAMES = ["score", "last_row", "last_col_abs", "packed", "lefts", "rights", "ws"]


def test_plan_at_main_path_shapes():
    """The smoke's long mode-0 ladder: K3 on 512 reads at W 256 (two warps
    of 5 columns a lane) and at W 512 (four warps)."""
    for W, want in ((256, Plan(2, 5, False)), (512, Plan(4, 5, False))):
        pl = k5.plan(512, W, H100_SMS)
        assert pl == want, W
        assert 32 * pl.warps * pl.cw >= W and 32 * pl.warps <= k5.MAX_THREADS


def test_plan_at_form_edges():
    """K3's forms by window width: one warp at 1, 3, 5 and 7 columns a lane
    up to 224 columns (the smallest window, 8, at one), several warps from
    225 (5 columns a lane up to 16 x 160, then 7), and the full form past
    16 warps x 224 columns."""
    assert k5.plan(4, 8, H100_SMS) == Plan(1, 1, False)
    assert k5.plan(4, 96, H100_SMS) == Plan(1, 3, False)
    assert k5.plan(4, 160, H100_SMS) == Plan(1, 5, False)
    assert k5.plan(4, 224, H100_SMS) == Plan(1, 7, False)
    assert k5.plan(4, 225, H100_SMS) == Plan(2, 5, False)
    assert k5.plan(4, 2560, H100_SMS) == Plan(16, 5, False)
    assert k5.plan(4, 2561, H100_SMS) == Plan(12, 7, False)
    assert k5.plan(4, 3584, H100_SMS) == Plan(16, 7, False)
    assert k5.plan(4, 3585, H100_SMS) == Plan(16, 9, True)


def test_stored_rows_window_form_on_a_bubble():
    """On a two-arm bubble K3's register forms store exactly the far
    predecessors (the flank's last row and the first arm's last), and its
    full form every row: n scratch rows, its G kept apart in [B, Lp]."""
    dg = poa_device_graph(PoaGraph.from_gfa(fuzz.bubble_gfa(20, 6, seed=3)), "cpu")
    h = dg.host()
    pidx, mask = np.asarray(h["pred_idx"]), np.asarray(h["pred_mask"])
    far = {int(p) for i in range(dg.n) for p, ok in zip(pidx[i], mask[i]) if ok and p != i - 1}
    store_at, srow, S = k5.stored_rows(dg, every_row=True)
    assert S == len(far) == 2
    assert {int(r) for r in torch.nonzero(store_at >= 0).flatten()} == far
    for i in range(dg.n):
        for q, (p, ok) in enumerate(zip(pidx[i], mask[i])):
            want = int(store_at[p]) if ok and p != i - 1 else -1
            assert int(srow[i, q]) == want, (i, q)
    store_at, srow, S = k5.stored_rows(dg, full=True, every_row=True)
    assert S == dg.n and torch.equal(store_at, torch.arange(dg.n, dtype=torch.int32))


@pytest.mark.parametrize("table", ["none", "asymmetric"])
@pytest.mark.parametrize("name", ["random", "bubble"])
def test_windowed_fill_matches_jax(name, table):
    """The windowed mode-0 fill equals the JAX engine's on all eight
    outputs: windows that move by +8 and -8 (a random graph) or back by
    more than W (the bubble), a read that overflows its window, the plain
    table and one whose gap row and gap column differ (row 0's G)."""
    g, reads, btas, W = _shift_case(name)
    sm = ScoreMatrix.create("none", 2, -4)
    jx, pt = _inputs(g, reads, btas, sm)
    if table == "asymmetric":
        tab = _asymmetric(sm)
        jx = (jx[0], jnp.asarray(tab), *jx[2:])
        pt = (pt[0], torch.from_numpy(tab), *pt[2:])
    ref = jax_engine._fill_global_windowed(*jx, W=W)
    ws = np.asarray(ref[6])[:, :-1]
    d = ws[:, 1:] - ws[:, :-1]
    assert np.asarray(ref[7]).any()
    if name == "bubble":
        assert (d <= -W).any()
    else:
        assert (d == 8).any() and (d == -8).any()
    got = poa_engine.fill_global_windowed_plain(*pt, W)
    _assert_outputs_equal(got[:7], ref[:7], NAMES)
    np.testing.assert_array_equal(got[7].numpy(), np.asarray(ref[7]))
    assert got[7].dtype == torch.bool
