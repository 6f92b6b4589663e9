"""recgraph_tpu_torch's pathwise graph, device encoding and group table
against the JAX package's (modes 4/5).

Exact equality throughout: every field is an int or bool array.
"""

import random

import numpy as np
import pytest
import torch

from recgraph_tpu.graph import pathgraph as jax_pathgraph
from recgraph_tpu.io import gfa as jax_gfa
from recgraph_tpu.ops import encode as jax_encode
from recgraph_tpu.ops import pallas_pathwise
from recgraph_tpu.ops import pathwise_window as jax_window
from recgraph_tpu_torch import fuzz
from recgraph_tpu_torch.graph import pathgraph
from recgraph_tpu_torch.io import gfa
from recgraph_tpu_torch.ops import encode, pathwise_window

from test_fuzz_random_graphs import random_gfa

# the port's CPU path runs thousands of tiny ops; more intra-op threads only
# contend with the other test workers on the CPU
torch.set_num_threads(1)

GRAPHS = ["example", "random5"]
DEVICE_FIELDS = ("codes", "node_start", "paths_on", "alphas", "rep_of", "pred_of")


def _pair(name, example_paths):
    """(JAX PathGraph, port PathGraph) of one corpus."""
    if name == "example":
        return (jax_pathgraph.PathGraph.from_gfa(jax_gfa.parse_gfa(example_paths[1])),
                pathgraph.PathGraph.from_gfa(gfa.parse_gfa(example_paths[1])))
    # a 5-path random DAG; nodes off every path keep the P + 1 alpha
    kw = dict(n_nodes=30, n_paths=5)
    return (jax_pathgraph.PathGraph.from_gfa(random_gfa(random.Random(55), **kw)),
            pathgraph.PathGraph.from_gfa(fuzz.random_gfa(random.Random(55), **kw)))


def _jax_device_numpy(g):
    dg = jax_encode._build_path_device_graph(g)
    out = {f: np.asarray(getattr(dg, f)) for f in DEVICE_FIELDS}
    out.update(n=dg.n, paths_number=dg.paths_number, qsrc_of=dg.qsrc_of)   # None: forward
    return dg, out


@pytest.mark.parametrize("name", GRAPHS)
def test_pathgraph_and_meta_match_jax(example_paths, name):
    ref, got = _pair(name, example_paths)
    assert got.lnz == ref.lnz and got.paths_number == ref.paths_number
    assert got.paths_number == (23 if name == "example" else 5)
    for f in ("codes", "node_start", "paths_nodes", "alphas", "nodes_id_pos"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.pred_edges.keys() == ref.pred_edges.keys()
    for i in ref.pred_edges:
        assert [p for p, _ in got.preds_and_paths(i)] == [p for p, _ in ref.preds_and_paths(i)]
        for (_, a), (_, b) in zip(got.preds_and_paths(i), ref.preds_and_paths(i)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(pathgraph.pathwise_meta(got), jax_pathgraph.pathwise_meta(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", GRAPHS)
def test_path_device_graph_matches_jax(example_paths, name):
    ref_g, got_g = _pair(name, example_paths)
    _, ref = _jax_device_numpy(ref_g)
    built = encode.build_path_device_graph(got_g, "cpu").to_numpy()
    carried = encode.PathDeviceGraph.from_numpy(ref, "cpu").to_numpy()
    for got in (built, carried):
        assert got.keys() == ref.keys()
        for k, v in ref.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v, k
    dg = encode.path_device_graph(got_g, "cpu")
    assert encode.path_device_graph(got_g, torch.device("cpu")) is dg
    assert dg.rep_of.dtype == torch.int32 and dg.paths_on.dtype == torch.bool


@pytest.mark.parametrize("name", GRAPHS)
def test_group_table_matches_pallas_meta(example_paths, name):
    """The kernels' group table is the Pallas kernels' (rep, pred) group
    metadata without its padding of the rows to a grid-step multiple."""
    ref_g, got_g = _pair(name, example_paths)
    jdg, _ = _jax_device_numpy(ref_g)
    grep_ref, gpred_ref, Gd, _, n_pad = pallas_pathwise._group_meta(jdg, 1)
    assert n_pad == jdg.n
    grep, gpred, pslot = (t.numpy() for t in encode.group_table(
        encode.path_device_graph(got_g, "cpu")))
    assert grep.shape == (jdg.n, Gd) and grep.dtype == np.int32
    np.testing.assert_array_equal(grep, grep_ref.reshape(jdg.n, Gd))
    np.testing.assert_array_equal(gpred, gpred_ref.reshape(jdg.n, Gd))
    # every on-path lane points at its own (rep, pred) group; off-path -1
    rep, pred = (np.asarray(a) for a in (jdg.rep_of, jdg.pred_of))
    on = np.asarray(jdg.paths_on)
    rows, lanes = np.nonzero(pslot >= 0)
    assert ((pslot >= 0) == (on & (rep >= 0))).all()
    np.testing.assert_array_equal(grep[rows, pslot[rows, lanes]], rep[rows, lanes])
    np.testing.assert_array_equal(gpred[rows, pslot[rows, lanes]], pred[rows, lanes])


def test_rmin_matches_jax(example_paths):
    for name in GRAPHS:
        ref_g, got_g = _pair(name, example_paths)
        jdg, _ = _jax_device_numpy(ref_g)
        got = pathwise_window.rmin_tensor(encode.path_device_graph(got_g, "cpu"))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), jax_window._rmin(jdg))
