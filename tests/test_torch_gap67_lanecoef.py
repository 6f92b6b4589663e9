"""The lane coefficients of the CUDA column program (K12) on the CPU.

``pathwise_gap_engine.chain_coefs`` orders a hard row's lanes hubs first
(the row alpha and the owning and firing blocks' tb lanes, the only
lanes read across lanes) and gives each its owner's tb slot, fix slot
and flags; ``hard_cols_chain_plain`` runs the column program from those
coefficients alone, as the kernel does: the hubs chained column by
column, every other lane from its own state and the hubs' values.  It
is held to ``hard_cols_plain`` and to the TPU kernel itself,
``pallas_gap67_hardrow.hard_cols_lc(..., interpret=True)``, on every
hard row of the example graph, the stretch recipe at n_back = 60 and
three random covered DAGs; on a row of 40 hub lanes (a node with 40
predecessor blocks) to ``hard_cols_plain``.  Exact equality: every
value is an int32 DP cell.
"""

import contextlib
import io
import os
import random
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recgraph_tpu.ops import pallas_gap67_hardrow as jax_pg67
from recgraph_tpu_torch import fuzz
from recgraph_tpu_torch.graph.pathgraph import PathGraph
from recgraph_tpu_torch.io import fasta, gfa
from recgraph_tpu_torch.ops import encode, pathwise_gap_engine as pge
from recgraph_tpu_torch.scoring import ScoreMatrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

torch.set_num_threads(1)
O, E = -4, -2


def _graph(name, tmp_path):
    """(PathGraph, reads) of a case."""
    if name == "example":
        g = PathGraph.from_gfa(gfa.parse_gfa(os.path.join(ROOT, "example", "graph.gfa")))
        return g, fasta.get_sequences(os.path.join(ROOT, "example", "reads.fa"))[0][:1]
    if name == "stretch60":
        from make_synthetic import make

        with contextlib.redirect_stdout(io.StringIO()):
            make(str(tmp_path), n_back=60, n_reads=4, seed=7, n_paths=6)
        g = PathGraph.from_gfa(gfa.parse_gfa(str(tmp_path / "graph.gfa")))
        return g, fasta.get_sequences(str(tmp_path / "reads.fa"))[0][:1]
    if name == "fan40":
        gf = fuzz.fan_gfa(40)
        rng = random.Random(40)
        return PathGraph.from_gfa(gf), [fuzz.random_read(rng, gf) for _ in range(2)]
    rng = random.Random(int(name[6:]))
    gf = fuzz.random_gfa(rng, n_nodes=16, n_paths=5, cover_all=True)
    return PathGraph.from_gfa(gf), [fuzz.random_read(rng, gf) for _ in range(3)]


def _hard_rows(tabs):
    m = tabs.meta
    return [i for i in range(1, m.n - 1) if not m.easy[i]]


@pytest.mark.parametrize("name", ["example", "fan40"])
def test_chain_coefs_put_hubs_first(tmp_path, name):
    """Every hard row's slots are a permutation of its paths, hubs first:
    the row alpha and the tb lanes of the owning and firing blocks; every
    tb and fix slot is a hub, and only hubs are tb or firing tb lanes."""
    g, _ = _graph(name, tmp_path)
    tabs = pge.gap_tables(g, "cpu")
    m = tabs.meta
    P = m.P
    for i in _hard_rows(tabs):
        path, tbs, fxs, fl = tabs.chain[i].numpy()
        H, a_slot, isa_slot = tabs.rows[i, 6:9].tolist()
        own = tabs.lanes[i, 0].numpy()
        hubs = {int(m.alphas[i])} | {int(m.btb[i, s]) for s in set(own[own >= 0])} \
            | {int(m.btb[i, s]) for s in np.flatnonzero(m.bfire[i])}
        assert sorted(path) == list(range(P))
        assert list(path[:H]) == sorted(hubs)
        assert path[a_slot] == m.alphas[i]
        assert ((tbs < H) & (fxs < H)).all()
        assert not (fl[H:] & (pge.CF_HOT | pge.CF_HOTL)).any()
        assert (isa_slot == -1) == (not m.bisa[i].any())
    assert int(tabs.rows[:, 6].max()) == (40 if name == "fan40" else 9)


@pytest.mark.parametrize("name,semi", [
    ("example", False), ("example", True), ("stretch60", False), ("random31", False),
    ("random32", True), ("random33", False), ("fan40", True),
])
def test_chain_plain_matches_hard_cols_plain_and_k12(tmp_path, name, semi):
    """On every hard row: the column program from the lane coefficients
    equals ``hard_cols_plain`` and (but for fan40, whose 40 blocks would
    cost another interpreter compile) the TPU kernel K12 in the Pallas
    interpreter, and its columns are the plain fill's."""
    g, reads = _graph(name, tmp_path)
    tabs = pge.gap_tables(g, "cpu")
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table, dtype=torch.int32)
    seq, _ = encode.encode_reads(reads)
    B, Lp = seq.shape
    C = Lp - 1
    Lpm = -(-C // jax_pg67.TILE) * jax_pg67.TILE
    pad = lambda t: jnp.asarray(np.pad(t.numpy(), ((0, Lpm - C),) + ((0, 0),) * (t.dim() - 1)))  # noqa: E731
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    Dm, X, Y = pge.fill_gap_plain(tabs, table, seq, O, E, semi)
    m = tabs.meta
    hard = _hard_rows(tabs)
    assert hard
    for i in hard:
        sub = table[int(m.codes[i])][seq.long()]
        U, Dc, Dfd, Ypre, _ = pge.stage_hard_row(tabs, Dm, Y, i, sub, O, E)
        (tb, nd, fire, isa, after), ai = pge.hard_row_scalars(tabs, i)
        lc = tabs.lanes[i][:, :, None].expand(-1, -1, B).contiguous()
        x0 = X[i, :, :, 0].t().contiguous()
        ref = pge.hard_cols_plain(U, Dc, Dfd, Ypre, lc, x0, tb, nd, fire, isa, after, ai, O, E)
        V, W = pge.chain_inputs(U, Dc, Dfd, Ypre, lc[0])
        H, a_slot, isa_slot = tabs.rows[i, 6:9].tolist()
        got = pge.hard_cols_chain_plain(V, W, tabs.chain[i], H, a_slot, isa_slot, x0, O, E)
        for name_, a, r in (("x", got[0], ref[0]), ("d", got[1], ref[1])):
            np.testing.assert_array_equal(a.numpy(), r.numpy(), err_msg=f"row {i} {name_}")
        if name != "fan40":
            scal = jnp.asarray([ai, O, E, Lpm, 0, 0, 0, 0], dtype=jnp.int32)
            k12 = jax_pg67.hard_cols_lc(pad(U), pad(Dc), pad(Dfd), pad(Ypre), j(lc), j(x0),
                                        j(tb), j(nd), j(fire), j(isa), j(after), scal,
                                        interpret=True)
            for name_, a, k in (("x", got[0], k12[0]), ("d", got[1], k12[1])):
                np.testing.assert_array_equal(a.numpy(), np.asarray(k)[:C],
                                              err_msg=f"row {i} {name_} vs K12")
        np.testing.assert_array_equal(got[0].permute(2, 1, 0).numpy(), X[i, :, :, 1:].numpy())
        np.testing.assert_array_equal(got[1].permute(2, 1, 0).numpy(), Dm[i, :, :, 1:].numpy())
