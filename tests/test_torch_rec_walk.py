"""The port's walks of modes 8/9 against the JAX engine's: the reverse
walk (``walk_reverse`` against ``_walk_reverse``) from the split point,
and the forward walk from the split column (``walk_pathwise`` with
``start_j`` against ``_walk_pathwise``).

Inputs: the planes, split points and walk starts of the 6 example reads
of ``test_torch_rec_split.py`` (every one splits in mode 8, two in mode
9; the others start their forward walk at the mode's no-recombination
ending and their reverse walk at (0, 0), as the JAX engine passes them).
Exact equality: every output is a direction code, a row or a count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recgraph_tpu.ops import pathwise_engine as jax_pathwise
from recgraph_tpu.ops import recombination_engine as jax_rec
from recgraph_tpu_torch.ops import encode, pathwise_engine, recombination_engine as rec
from recgraph_tpu_torch.scoring import ScoreMatrix

from test_torch_rec_split import COSTS, planes, setup  # noqa: F401  (fixture)

torch.set_num_threads(1)


@pytest.mark.parametrize("mode,costs", [(8, "default"), (9, "default"), (8, "R10_r2_B05")])
def test_walks_match_jax(setup, mode, costs):
    g, rg, _, _, _ = setup
    Af, Ar, seq, L, finalcol = planes(setup, mode)
    R, r, rbw = COSTS[costs]
    n, B = g.n, len(finalcol)
    Lnp = L.numpy()
    oob = np.maximum((Lnp * (1.0 - rbw) / 2.0).astype(np.int64), 1)
    jcol = np.arange(seq.shape[1])
    active = (jcol[None, :] >= oob[:, None]) & (jcol[None, :] < (Lnp - oob)[:, None])
    init_best, base_paths = rec._baseline(mode, finalcol, g)
    geom = rec._SplitGeometry(g, rg)
    best, taken, fen, rsn, fp, rp, col = rec._run_split_guided(
        rec.split_inputs(Af, Ar, torch.from_numpy(g.paths_nodes)), geom, geom.tensors("cpu"),
        active, init_best, R, r)
    fpf = np.where(taken, fp, base_paths).astype(np.int32)
    rpf = np.where(taken, rp, base_paths).astype(np.int32)
    start_i, start_j = rec._walk_starts(mode, g, finalcol, taken, fen, col, fpf, Lnp)
    dg, dgr = encode.path_device_graph(g), encode.rev_device_graph(rg)
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table, dtype=torch.int32)
    W = n + seq.shape[1] + 4
    fplane = pathwise_engine._extract_plane(Af, torch.from_numpy(fpf))
    rplane = pathwise_engine._extract_plane(Ar, torch.from_numpy(rpf))
    pred_of_bp = dg.pred_of.t()[torch.from_numpy(fpf).long()]
    succ_of_rp = dgr.pred_of.t()[torch.from_numpy(rpf).long()]
    j = lambda t: jnp.asarray(np.asarray(t))

    got = pathwise_engine.walk_pathwise(
        fplane, seq, L, table, dg.node_start, dg.codes, pred_of_bp, torch.from_numpy(start_i),
        mode == 8, W, start_j=torch.from_numpy(start_j))
    ref = jax_pathwise._walk_pathwise(
        j(fplane), j(seq), j(L), j(table), j(g.node_start), j(dg.codes), j(pred_of_bp),
        j(start_i), global_mode=(mode == 8), max_steps=W, start_j=j(start_j))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    got = rec.walk_reverse(rplane, seq, L, table, dgr.node_start, dg.codes, succ_of_rp,
                           torch.from_numpy(rsn), torch.from_numpy(col), mode == 8, W)
    ref = jax_rec._walk_reverse(
        j(rplane), j(seq), j(L), j(table), j(rg.node_start), j(dg.codes), j(succ_of_rp),
        j(rsn), j(col), global_mode=(mode == 8), max_steps=W)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert taken.sum() == (B if mode == 8 else 2)
