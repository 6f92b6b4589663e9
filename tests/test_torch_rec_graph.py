"""The port's reverse graph, displacement distances and reverse-fill
metadata (modes 8/9) against the JAX package's ``graph.pathgraph``, and
its copies of the fragment-graph generator against the test module's.

Inputs: the example graph (n = 1,331, 23 paths) and the fragment graphs
of ``fuzz.LEAK_SEEDS``, whose reverse graphs reach every delta-leak
branch of ``pathwise_meta_rev``.  Exact equality: every array is an
integer or boolean graph table.
"""

import random

import numpy as np
import pytest
import torch

from recgraph_tpu.graph import pathgraph as jax_pathgraph
from recgraph_tpu.io import gfa as jax_gfa
from recgraph_tpu_torch import fuzz
from recgraph_tpu_torch.graph import pathgraph
from recgraph_tpu_torch.io import gfa
from recgraph_tpu_torch.ops import encode

from test_rev_fill_leak_rows import SEEDS, _leak_branches, _random_reads, fragment_gfa

torch.set_num_threads(1)


def _graphs(name, example_paths):
    """[(port PathGraph, JAX PathGraph)] of the named corpus."""
    if name == "example":
        return [(pathgraph.PathGraph.from_gfa(gfa.parse_gfa(example_paths[1])),
                 jax_pathgraph.PathGraph.from_gfa(jax_gfa.parse_gfa(example_paths[1])))]
    return [(pathgraph.PathGraph.from_gfa(fuzz.fragment_gfa(s)),
             jax_pathgraph.PathGraph.from_gfa(fragment_gfa(s))) for s in fuzz.LEAK_SEEDS]


def _same_graph(a, b):
    assert a.lnz == b.lnz and a.paths_number == b.paths_number
    for f in ("codes", "node_start", "paths_nodes", "alphas", "nodes_id_pos"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert sorted(a.pred_edges) == sorted(b.pred_edges)
    for i in a.pred_edges:
        assert [(p, m.tolist()) for p, m in a.preds_and_paths(i)] == \
            [(p, m.tolist()) for p, m in b.preds_and_paths(i)]


@pytest.mark.parametrize("name", ["example", "fragments"])
def test_reverse_distances_and_meta_match_jax(example_paths, name):
    for g, jg in _graphs(name, example_paths):
        rg, jrg = g.reverse(), jg.reverse()
        _same_graph(rg, jrg)
        np.testing.assert_array_equal(g.distance_from_end(), jg.distance_from_end())
        np.testing.assert_array_equal(rg.distance_from_start_on_reverse(),
                                      jrg.distance_from_start_on_reverse())
        np.testing.assert_array_equal(pathgraph.nodes_displacement_matrix(g, rg),
                                      jax_pathgraph.nodes_displacement_matrix(jg, jrg))
        for a, b in zip(pathgraph.pathwise_meta_rev(rg), jax_pathgraph.pathwise_meta_rev(jrg)):
            np.testing.assert_array_equal(a, b)


def test_fragment_copies_match_tests_and_cover_every_leak_branch():
    """fuzz.fragment_gfa / fragment_reads / LEAK_SEEDS are the test
    module's, and their reverse graphs reach all four leak branches."""
    assert fuzz.LEAK_SEEDS == SEEDS
    hit = set()
    for seed in SEEDS:
        a, b = fuzz.fragment_gfa(seed), fragment_gfa(seed)
        assert a.segments == b.segments and a.edges == b.edges
        assert [(p.name, p.nodes) for p in a.paths] == [(p.name, p.nodes) for p in b.paths]
        assert fuzz.fragment_reads(random.Random(seed), a) == \
            _random_reads(random.Random(seed), b)
        hit |= _leak_branches(jax_pathgraph.PathGraph.from_gfa(b).reverse())
    assert hit == {"case1_common", "case1_ai_cov", "case1_junk", "ghost"}


def test_rev_device_graph_and_ghost_lanes():
    """rev_device_graph carries qsrc_of; group_table gives the constant-0
    lanes of a ghost-alpha row (qsrc -1, no rep and no successor) no
    group, and still raises on a forward graph's lane without one."""
    ghost_rows = 0
    for seed in fuzz.LEAK_SEEDS:
        rg = pathgraph.PathGraph.from_gfa(fuzz.fragment_gfa(seed)).reverse()
        dgr = encode.rev_device_graph(rg)
        assert encode.rev_device_graph(rg) is dgr
        rep, pred, qsrc = pathgraph.pathwise_meta_rev(rg)
        np.testing.assert_array_equal(dgr.qsrc_of.numpy(), qsrc)
        np.testing.assert_array_equal(dgr.pred_of.numpy(), pred)
        grep, gpred, pslot = (t.numpy() for t in encode.group_table(dgr))
        zero = rg.paths_nodes & (qsrc < 0)
        ghost_rows += int(zero[1:-1].any(axis=1).sum())
        assert (pslot[zero] == -1).all()
        live = rg.paths_nodes & (qsrc >= 0)
        live[[0, -1]] = False
        assert (pslot[live] >= 0).all()
        rows, lanes = np.nonzero(live)
        assert (grep[rows, pslot[rows, lanes]] == rep[rows, lanes]).all()
        assert (gpred[rows, pslot[rows, lanes]] == pred[rows, lanes]).all()
    assert ghost_rows > 0
    g = pathgraph.PathGraph.from_gfa(fuzz.fragment_gfa(fuzz.LEAK_SEEDS[0]))
    arrays = encode.build_path_device_graph(g).to_numpy()
    arrays["rep_of"][1, np.flatnonzero(g.paths_nodes[1])[0]] = -1
    with pytest.raises(ValueError, match="in no group"):
        encode.group_table(encode.PathDeviceGraph.from_numpy(arrays))
