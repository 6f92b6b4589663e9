"""The port's plain windowed pathwise fill (the plain version of kernel
K10) against the JAX engine's ``pathwise_window._fill_pathwise_win``.

Long reads on ``make(d, 600, 1, 11)`` (the JAX package's own windowed
corpus, tests/test_pathwise_window.py): every cell of Aw, every window
start and every exit bound equal, at W 256 (the guard passes) and at
W 32 (it fails), plus the final column the endings read.  Exact
equality: every value is an int32.
"""

import os
import random
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recgraph_tpu.graph.pathgraph import PathGraph as JaxPathGraph
from recgraph_tpu.io import gfa as jax_gfa
from recgraph_tpu.ops import encode as jax_encode
from recgraph_tpu.ops import pathwise_engine as jax_engine
from recgraph_tpu.ops import pathwise_window as jax_window
from recgraph_tpu.scoring import ScoreMatrix
from recgraph_tpu_torch import metrics
from recgraph_tpu_torch.ops import cuda_pathwise_win, encode, pathwise_engine, pathwise_window

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))

# the port's CPU path runs thousands of tiny ops; more intra-op threads only
# contend with the other test workers on the CPU
torch.set_num_threads(1)
FIELDS = ("codes", "node_start", "paths_on", "alphas", "rep_of", "pred_of")


def long_reads(gfa_path, k, seed):
    """k full-haplotype reads with 2 % substitutions (the recipe of
    tests/test_pathwise_window.py and bench.py's long corpus)."""
    rng = random.Random(seed)
    walks, segs = {}, {}
    with open(gfa_path) as fh:
        for ln in fh:
            f = ln.rstrip("\n").split("\t")
            if f[0] == "P":
                walks[f[1]] = [int(x[:-1]) for x in f[2].split(",")]
            elif f[0] == "S":
                segs[int(f[1])] = f[2]
    reads = []
    for _ in range(k):
        s = "".join(segs[x] for x in walks[rng.choice(sorted(walks))])
        reads.append("$" + "".join(rng.choice("ACGT") if rng.random() < 0.02 else c
                                   for c in s))
    return reads


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from make_synthetic import make

    d = str(tmp_path_factory.mktemp("pwwin"))
    make(d, n_back=600, n_reads=1, seed=11)
    g = JaxPathGraph.from_gfa(jax_gfa.parse_gfa(os.path.join(d, "graph.gfa")))
    reads = long_reads(os.path.join(d, "graph.gfa"), 2, 5)
    assert min(map(len, reads)) >= pathwise_engine.LONG_READ_LP
    sm = ScoreMatrix.create("none", 2, -4)
    jdg = jax_encode._build_path_device_graph(g)
    seq, L = jax_encode.encode_reads(reads, pad_to=max(map(len, reads)))
    arrays = {f: np.asarray(getattr(jdg, f)) for f in FIELDS}
    dg = encode.PathDeviceGraph.from_numpy(
        dict(arrays, n=jdg.n, paths_number=jdg.paths_number), "cpu")
    port_in = (dg, torch.as_tensor(sm.table, dtype=torch.int32),
               torch.from_numpy(np.array(seq)), torch.from_numpy(np.array(L)))
    jax_in = (jdg, jnp.asarray(sm.table, dtype=jnp.int32), seq, L)
    return g, jax_in, port_in


@pytest.mark.parametrize("W", [256, 32])
def test_plain_window_fill_matches_jax(corpus, W):
    g, (jdg, jtable, jseq, jL), (dg, table, seq, L) = corpus
    rmin = pathwise_window.rmin_tensor(dg)
    ref = jax_window._fill_pathwise_win(jdg, jtable, jseq, jL, W, jnp.asarray(jax_window._rmin(jdg)))
    got = pathwise_window.fill_pathwise_win_plain(dg, table, seq, L, W, rmin)
    for a, b, what in zip(got, ref, ("Aw", "ws", "bound")):
        assert a.dtype == torch.int32, what
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=what)
    fc_ref = np.asarray(jax_window._final_column_win(*ref[:2], jL))
    fc = pathwise_window._final_column_win(got[0], got[1], L)
    np.testing.assert_array_equal(fc.numpy(), fc_ref)
    # the guard: the windowed best strictly beats the exit bound at
    # W 256 for every read, and fails for some read at W 32
    _, _, score = jax_engine._endings_global_dev(fc_ref, *jax_engine._end_meta(g))
    passed = np.asarray(score) > np.asarray(ref[2])
    assert passed.all() if W == 256 else not passed.all()


def test_window_best_runs_plain_on_cpu(corpus):
    """A CPU tensor takes the plain fill and launches nothing; the
    kernel's wrapper refuses CPU tensors and widths outside [8, Lp]."""
    _, _, (dg, table, seq, L) = corpus
    rmin = pathwise_window.rmin_tensor(dg)
    metrics.reset_phases()
    got = pathwise_window.fill_pathwise_win_best(dg, table, seq[:1], L[:1], 64, rmin)
    assert sum(metrics.LAUNCHES.values()) == 0
    ref = pathwise_window.fill_pathwise_win_plain(dg, table, seq[:1], L[:1], 64, rmin)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(ValueError, match="needs CUDA"):
        cuda_pathwise_win.fill_pathwise_win_cuda(dg, table, seq, L, 64, rmin)
    with pytest.raises(ValueError, match="window width"):
        pathwise_window.fill_pathwise_win_plain(dg, table, seq, L, seq.shape[1] + 8, rmin)
