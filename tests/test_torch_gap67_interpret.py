"""The port's plain modes-6/7 fill against the TPU kernels themselves,
run through the Pallas interpreter on the CPU.

``pathwise_gap_engine.fill_gap_plain`` against JAX ``fill_gap_device``
with ``pallas_gap67_fill.INTERPRET`` set (the full-fill kernel K11, which
its eligibility gate admits here) on the stretch recipe at n_back = 60
(40 hard rows), and ``hard_cols_plain`` against
``pallas_gap67_hardrow.hard_cols_lc(..., interpret=True)`` (K12) on the
staged inputs of the example graph's hard rows.  Exact equality: every
value is an int32 DP cell.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recgraph_tpu.graph.pathgraph import PathGraph as JaxPathGraph
from recgraph_tpu.io import fasta
from recgraph_tpu.io import gfa as jax_gfa
from recgraph_tpu.metrics import FALLBACKS
from recgraph_tpu.ops import encode as jax_encode
from recgraph_tpu.ops import pallas_gap67_fill as jax_pgf
from recgraph_tpu.ops import pallas_gap67_hardrow as jax_pg67
from recgraph_tpu.ops import pathwise_gap_engine as jax_engine
from recgraph_tpu.scoring import ScoreMatrix as JaxScoreMatrix
from recgraph_tpu_torch.graph.pathgraph import PathGraph
from recgraph_tpu_torch.io import gfa
from recgraph_tpu_torch.ops import encode, pathwise_gap_engine
from recgraph_tpu_torch.scoring import ScoreMatrix

from test_torch_gap67_fill import assert_planes_equal

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stretch60(tmp_path_factory):
    from make_synthetic import make

    d = tmp_path_factory.mktemp("stretch60")
    make(str(d), n_back=60, n_reads=4, seed=7, n_paths=6)
    seqs, _ = fasta.get_sequences(str(d / "reads.fa"))
    path = str(d / "graph.gfa")
    return (JaxPathGraph.from_gfa(jax_gfa.parse_gfa(path)),
            PathGraph.from_gfa(gfa.parse_gfa(path)), seqs[:2])


@pytest.mark.parametrize("semi", [False, True], ids=["mode6", "mode7"])
def test_plain_fill_matches_k11_interpret(stretch60, semi, monkeypatch):
    jg, g, reads = stretch60
    sm = JaxScoreMatrix.create("none", 2, -4)
    monkeypatch.delenv("RECGRAPH_NO_PALLAS67", raising=False)
    monkeypatch.delenv("RECGRAPH_NO_PALLAS67_FILL", raising=False)
    monkeypatch.setattr(jax_pgf, "INTERPRET", True)
    assert jax_pgf.eligible(jax_engine.gap_meta(jg), 128, sm.table, -4, -2)
    before = FALLBACKS.get("gap67_pallas_fill", 0)
    jseq, _ = jax_encode.encode_reads(reads, pad_to=128)
    ref = [np.asarray(a) for a in jax_engine.fill_gap_device(jg, sm, jseq, -4, -2, semi)]
    assert FALLBACKS.get("gap67_pallas_fill", 0) == before, "the Pallas fill fell back"
    seq, _ = encode.encode_reads(reads, pad_to=128)
    got = pathwise_gap_engine.fill_gap_device(g, ScoreMatrix.create("none", 2, -4), seq, -4, -2,
                                              semi, device="cpu")
    assert_planes_equal(ref, [a.numpy() for a in got], f"stretch60 semi={semi}")


def test_hard_cols_plain_matches_k12_interpret(example_paths):
    g = PathGraph.from_gfa(gfa.parse_gfa(example_paths[1]))
    seqs, _ = fasta.get_sequences(example_paths[0])
    o, e = -4, -2
    tabs = pathwise_gap_engine.gap_tables(g, "cpu")
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table, dtype=torch.int32)
    seq, _ = encode.encode_reads(seqs[:3])
    B, Lp = seq.shape
    Dm, X, Y = pathwise_gap_engine.fill_gap_plain(tabs, table, seq, o, e, False)
    m = tabs.meta
    hard = [i for i in range(1, m.n - 1) if not m.easy[i]]
    # the first hard rows and the one with the most blocks
    rows = hard[:2] + [max(hard, key=lambda i: (int(m.bvalid[i].sum()), i))]
    C = Lp - 1
    Lpm = -(-C // jax_pg67.TILE) * jax_pg67.TILE
    pad = lambda t: jnp.asarray(np.pad(t.numpy(), ((0, Lpm - C),) + ((0, 0),) * (t.dim() - 1)))  # noqa: E731
    for i in rows:
        sub = table[int(m.codes[i])][seq.long()]
        U, Dc, Dfd, Ypre, _ = pathwise_gap_engine.stage_hard_row(tabs, Dm, Y, i, sub, o, e)
        (tb, nd, fire, isa, after), ai = pathwise_gap_engine.hard_row_scalars(tabs, i)
        lc = tabs.lanes[i][:, :, None].expand(-1, -1, B).contiguous()
        x0 = X[i, :, :, 0].t().contiguous()
        xs, ds = pathwise_gap_engine.hard_cols_plain(U, Dc, Dfd, Ypre, lc, x0, tb, nd, fire,
                                                     isa, after, ai, o, e)
        scal = jnp.asarray([ai, o, e, Lpm, 0, 0, 0, 0], dtype=jnp.int32)
        j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
        xr, dr = jax_pg67.hard_cols_lc(pad(U), pad(Dc), pad(Dfd), pad(Ypre), j(lc), j(x0),
                                       j(tb), j(nd), j(fire), j(isa), j(after), scal,
                                       interpret=True)
        np.testing.assert_array_equal(xs.numpy(), np.asarray(xr)[:C], err_msg=f"row {i} x")
        np.testing.assert_array_equal(ds.numpy(), np.asarray(dr)[:C], err_msg=f"row {i} d")
        # and the assembled row is the plain fill's
        np.testing.assert_array_equal(xs.permute(2, 1, 0).numpy(), X[i, :, :, 1:].numpy())
        np.testing.assert_array_equal(ds.permute(2, 1, 0).numpy(), Dm[i, :, :, 1:].numpy())
