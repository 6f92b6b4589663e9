"""The port's split search of modes 8/9 against the JAX engine's:
``_path_argmax`` (with planted ties), ``_column_ub``, the column summary
(``col_summary_plain``, the plain version of kernel S1, against
``_col_summary_fn``), ``_baseline`` and the bound-guided search
``_run_split_guided``, which the port runs per read and which must give
the same (best, taken, fen, rsn, fp, rp, col) at any round width, pairs
per round and sub-batch.  What the wrapper of S1's guided entry computes
in torch (its order-preserving f32 key, the column order) and the
invariant the smoke checks on the card are held here too.

Inputs: the score planes of 6 example reads (every one takes a split in
mode 8, two in mode 9) from the port's plain fills
(which ``test_torch_rec_fill.py`` and ``test_torch_pathwise_fill.py`` pin
to the JAX fills), made anew per mode.  Exact equality, f32 included:
the port computes each f32 expression in the JAX engine's order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recgraph_tpu.graph.pathgraph import PathGraph as JaxPathGraph
from recgraph_tpu.io import gfa as jax_gfa
from recgraph_tpu.ops import recombination_engine as jax_rec
from recgraph_tpu_torch.graph.pathgraph import PathGraph
from recgraph_tpu_torch.io import fasta, gfa
from recgraph_tpu_torch.ops import (
    cuda_split_summary, encode, pathwise_engine, recombination_engine as rec,
)
from recgraph_tpu_torch.scoring import ScoreMatrix

torch.set_num_threads(1)
COSTS = {"default": (4, 0.1, 1.0), "R10_r2_B05": (10, 2.0, 0.5), "ties": (0, 0.0, 1.0)}


@pytest.fixture(scope="module")
def setup(example_paths):
    seqs, _ = fasta.get_sequences(example_paths[0])
    g = PathGraph.from_gfa(gfa.parse_gfa(example_paths[1]))
    jg = JaxPathGraph.from_gfa(jax_gfa.parse_gfa(example_paths[1]))
    # reads 16 and 50 take a split in mode 9 too (tests/goldens/mode9.gaf)
    return g, g.reverse(), jg, jg.reverse(), seqs[:4] + [seqs[16], seqs[50]]


_planes_cache = {}


def planes(setup, mode):
    """(Af, Ar, seq, L, finalcol numpy) of the 6 reads, per mode."""
    if mode not in _planes_cache:
        g, rg, _, _, reads = setup
        table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table, dtype=torch.int32)
        seq, L = encode.encode_reads(reads)
        Af = pathwise_engine.fill_pathwise_plain(encode.path_device_graph(g), table, seq,
                                                 mode == 9)
        Ar = rec.fill_pathwise_rev_plain(encode.rev_device_graph(rg), table, seq, L, mode == 8)
        _planes_cache[mode] = (Af, Ar, seq, L, pathwise_engine._final_column(Af, L).numpy())
    return _planes_cache[mode]


def jax_inputs(Af, Ar, paths_on):
    """The JAX engine's split inputs over the interior rows."""
    n = Af.shape[2]
    out = []
    for A in (Af, Ar):
        mx, arg = jax_rec._path_argmax(jnp.asarray(A.numpy()))
        v = jnp.take_along_axis(jnp.broadcast_to(jnp.asarray(paths_on)[None],
                                                 (A.shape[0], n, A.shape[1])), arg, axis=2)
        out += [mx[:, 1 : n - 1], arg[:, 1 : n - 1], v[:, 1 : n - 1]]
    return tuple(out)


def test_path_argmax_matches_jax_with_planted_ties(setup):
    rng = np.random.default_rng(3)
    A = rng.integers(-2, 2, size=(3, 6, 5, 16)).astype(np.int32)   # most cells tie
    A[0, :, 0, 0] = 1                                               # every path ties
    cases = [torch.from_numpy(A), planes(setup, 8)[1]]
    for At in cases:
        mx, arg = rec._path_argmax(At)
        jmx, jarg = jax_rec._path_argmax(jnp.asarray(At.numpy()))
        np.testing.assert_array_equal(mx.numpy(), np.asarray(jmx))
        np.testing.assert_array_equal(arg.numpy(), np.asarray(jarg))
    assert int(rec._path_argmax(cases[0])[1][0, 0, 0]) == 5         # the larger path id


@pytest.mark.parametrize("mode", [8, 9])
def test_split_inputs_and_column_ub_match_jax(setup, mode):
    g, rg, _, _, _ = setup
    Af, Ar, *_ = planes(setup, mode)
    ours = rec.split_inputs(Af, Ar, torch.from_numpy(g.paths_nodes))
    theirs = jax_inputs(Af, Ar, g.paths_nodes)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    geom = rec._SplitGeometry(g, rg)
    wf, wr = rec._sign_weights(geom, 0.1)
    ub = rec._column_ub(ours[0], ours[2], ours[3], ours[5], torch.from_numpy(wf),
                        torch.from_numpy(wr))
    jub = jax_rec._column_ub(theirs[0], theirs[2], theirs[3], theirs[5], jnp.asarray(wf),
                             jnp.asarray(wr))
    np.testing.assert_array_equal(ub.numpy(), np.asarray(jub))


@pytest.mark.parametrize("costs", ["default", "ties"])
def test_col_summary_matches_jax(setup, costs):
    """16 columns of 4 reads, one of them with no valid pair anywhere."""
    g, rg, _, _, _ = setup
    Af, Ar, *_ = planes(setup, 8)
    inputs = list(rec.split_inputs(Af[:4], Ar[:4], torch.from_numpy(g.paths_nodes)))
    inputs[5] = inputs[5].clone()
    inputs[5][3] = False
    R, r, _ = COSTS[costs]
    geom = rec._SplitGeometry(g, rg)
    B, I, Lp = inputs[0].shape
    cols = np.linspace(1, Lp - 2, 16).astype(np.int32)
    run = jax_rec._col_summary_fn(I, I, len(cols))
    ref = run(jnp.asarray(cols), *(jnp.asarray(x.numpy()) for x in inputs),
              jnp.asarray(geom.dfs_i.astype(np.float32)),
              jnp.asarray(geom.dfe_i.astype(np.float32)),
              jnp.asarray(geom.ids_i), jnp.asarray(geom.fw_edge), jnp.asarray(geom.rv_edge),
              jnp.asarray([np.float32(R), np.float32(r)], jnp.float32))
    bidx = torch.arange(B, dtype=torch.int32).repeat_interleave(len(cols))
    got = rec.col_summary_plain(*inputs, geom.tensors("cpu"), R, r, bidx,
                                torch.from_numpy(cols).repeat(B))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy().reshape(B, -1), np.asarray(b))
    assert (got[0].numpy().reshape(B, -1)[3] == np.float32(rec.NEGF)).all()


@pytest.mark.parametrize("mode,costs", [(8, "default"), (9, "default"), (8, "R10_r2_B05")])
def test_baseline_and_guided_split_match_jax(setup, mode, costs):
    g, rg, jg, jrg, _ = setup
    Af, Ar, seq, L, finalcol = planes(setup, mode)
    R, r, rbw = COSTS[costs]
    init_best, base_paths = rec._baseline(mode, finalcol, g)
    for b in range(len(finalcol)):
        assert (init_best[b], base_paths[b]) == jax_rec._baseline(mode, finalcol[b], jg)
    Lnp = L.numpy()
    oob = np.maximum((Lnp * (1.0 - rbw) / 2.0).astype(np.int64), 1)
    jcol = np.arange(seq.shape[1])
    active = (jcol[None, :] >= oob[:, None]) & (jcol[None, :] < (Lnp - oob)[:, None])
    ref = jax_rec._run_split_guided(jax_inputs(Af, Ar, g.paths_nodes),
                                    jax_rec._SplitGeometry(jg, jrg), active, init_best, R, r,
                                    g.n - 2, seq.shape[1])
    geom = rec._SplitGeometry(g, rg)
    inputs = rec.split_inputs(Af, Ar, torch.from_numpy(g.paths_nodes))
    for kw in (dict(), dict(round_cols=3, sub_batch=2), dict(round_cols=64, sub_batch=1),
               dict(round_cols=2, round_pairs=40)):
        got = rec._run_split_guided(inputs, geom, geom.tensors("cpu"), active, init_best, R, r,
                                    **kw)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    assert ref[1].any()                   # some read takes a split


def test_guided_key_orders_like_f32():
    """S1's guided entry raises M_b with an atomicMax on this int key:
    it orders negative and positive values, NEGF, -inf and ties as f32
    does, and is its own inverse on the bits."""
    vals = np.array([-np.inf, np.float32(rec.NEGF), -1e30, -7.5, -7.5, -1.0, -1e-30, -0.0, 0.0,
                     1e-30, 0.25, 3.0, 3.0, 1e30, np.inf], np.float32)
    keys = cuda_split_summary.f32_key(torch.from_numpy(vals)).numpy()
    assert keys.dtype == np.int32
    order = np.argsort(keys, kind="stable")
    assert (np.diff(vals[order]) >= 0).all() and (np.diff(keys) >= 0).all()
    assert keys[3] == keys[4] and keys[11] == keys[12] and keys[7] < keys[8]
    assert cuda_split_summary.KEY_NEG_INF == keys[0] and keys[0] < keys[1]
    back = cuda_split_summary.f32_key(torch.from_numpy(keys).view(torch.float32))
    np.testing.assert_array_equal(back.numpy().view(np.float32), vals)


def test_guided_column_order_with_ties():
    """The guided entry's columns: ub - R in f32 as the plain search
    computes it, -inf where masked (inactive, column 0, columns >= Lp -
    1), in falling order with ties to the lower column, the unmasked
    ones first and counted."""
    rng = np.random.default_rng(5)
    ub = rng.integers(-3, 3, size=(4, 12)).astype(np.float32) * np.float32(0.5)
    ub[1] = 1.0                                        # every column ties
    ub[2, 3] = -np.inf                                 # an overflowed bound
    active = rng.random((4, 12)) < 0.8
    active[3] = False                                  # no column
    u = cuda_split_summary.masked_ub(torch.from_numpy(ub), torch.from_numpy(active), 4)
    plain = np.where(active, ub - np.float32(4), -np.inf)
    plain[:, :1] = plain[:, 11:] = -np.inf
    np.testing.assert_array_equal(u.numpy(), plain.astype(np.float32))
    ubs, order, ncand = cuda_split_summary.column_order(u)
    want = np.argsort(-plain, axis=1, kind="stable")
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(ubs.numpy(), np.take_along_axis(plain, want, 1))
    np.testing.assert_array_equal(ncand.numpy(), (plain > -np.inf).sum(1))
    assert list(order[1, : ncand[1]].numpy()) == sorted(order[1, : ncand[1]].numpy())
    assert ncand[3] == 0


def test_guided_invariant_on_plain_search(setup):
    """The invariant the smoke checks on the card: every column with ub +
    0.5 >= the read's final threshold was evaluated.  It holds for the
    plain search's evaluated columns in modes 8 and 9, and a needed
    column left out breaks it."""
    g, rg, _, _, _ = setup
    geom = rec._SplitGeometry(g, rg)
    for mode in (8, 9):
        Af, Ar, seq, L, finalcol = planes(setup, mode)
        init_best, _ = rec._baseline(mode, finalcol, g)
        active = np.ones(seq.shape, bool)
        inputs = rec.split_inputs(Af, Ar, torch.from_numpy(g.paths_nodes))
        ub, cols, done = rec._search_columns(inputs, geom, geom.tensors("cpu"), active,
                                             init_best, 4, 0.1)
        assert done.any() and not rec.split_unevaluated(ub, done, cols[0], init_best).any()
        M = np.where(done, cols[0], -np.inf).max(axis=1).astype(np.float32)
        needed = done & (ub + np.float32(0.5) >= np.maximum(M, init_best)[:, None])
        b, j = np.argwhere(needed & (cols[0] < M[:, None]))[0]   # M_b stays as it was
        done[b, j] = False
        assert rec.split_unevaluated(ub, done, cols[0], init_best)[b] == 1
