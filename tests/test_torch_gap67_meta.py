"""The port's modes-6/7 host metadata against the JAX engine's.

``pathwise_gap_engine.gap_meta`` (the row classification, the block
tables and the hard rows' owner maps) field by field, and its lane maps
against ``pallas_gap67_fill.pack_meta``, on the example graph, the
stretch recipe at n_back = 60 and random covered DAGs; and the one
route away from the engine: a graph the reference rejects raises
``RejectedGraph`` in both packages, and the CLI of each then raises the
oracle's RuntimeError.  Exact equality throughout.
"""

import os
import random
import sys

import numpy as np
import pytest
import torch

from recgraph_tpu import cli as jax_cli
from recgraph_tpu.graph.pathgraph import PathGraph as JaxPathGraph
from recgraph_tpu.io import gfa as jax_gfa
from recgraph_tpu.ops import pallas_gap67_fill as jax_pgf
from recgraph_tpu.ops import pathwise_gap_engine as jax_engine
from recgraph_tpu_torch import cli, fuzz
from recgraph_tpu_torch.graph.pathgraph import PathGraph
from recgraph_tpu_torch.io import gfa
from recgraph_tpu_torch.ops import pathwise_gap_engine

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))

torch.set_num_threads(1)

FIELDS = ("n", "P", "maxb", "codes", "alphas", "node_start", "easy", "pr", "eap", "edelta",
          "emask", "fap", "fcommon_ap", "fmask", "bvalid", "bpred", "bap", "btb", "bdelta",
          "bcase1", "bmask", "bmaskq", "bfirst", "bfixmem", "bown", "bfire", "bisa", "bafter")


def gfa_text(gf):
    """GFA1 text of an in-memory graph (all-'+' links and steps)."""
    lines = [f"S\t{k}\t{v}" for k, v in sorted(gf.segments.items())]
    lines += [f"L\t{a}\t+\t{b}\t+\t0M" for a, b in gf.edges]
    lines += [f"P\t{p.name}\t{','.join(f'{x}+' for x in p.nodes)}\t*" for p in gf.paths]
    return "\n".join(lines) + "\n"


def graphs(name, example_paths, tmp_path):
    """(JAX PathGraph, the port's PathGraph) of one named graph."""
    if name == "example":
        path = example_paths[1]
    elif name == "stretch60":
        from make_synthetic import make

        make(str(tmp_path), n_back=60, n_reads=2, seed=7, n_paths=6)
        path = str(tmp_path / "graph.gfa")
    else:
        rng = random.Random(int(name[len("random"):]))
        gf = fuzz.random_gfa(rng, n_nodes=20, n_paths=5, cover_all=True)
        path = str(tmp_path / "graph.gfa")
        with open(path, "w") as fh:
            fh.write(gfa_text(gf))
    return (JaxPathGraph.from_gfa(jax_gfa.parse_gfa(path)),
            PathGraph.from_gfa(gfa.parse_gfa(path)))


@pytest.mark.parametrize("name", ["example", "stretch60", "random11", "random12", "random13"])
def test_gap_meta_matches_jax(name, example_paths, tmp_path):
    jg, g = graphs(name, example_paths, tmp_path)
    ref = jax_engine.gap_meta(jg)
    got = pathwise_gap_engine.gap_meta(g)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    # the kernel's lane maps: pack_meta's owner id, hot and hotl lanes,
    # and the fixup member id of the JAX hard-row call
    packed = jax_pgf.pack_meta(ref)
    lanes = pathwise_gap_engine.lane_maps(got)
    for k, ref_map in ((0, packed[18]), (1, packed[19]), (3, packed[20])):
        np.testing.assert_array_equal(lanes[:, k], ref_map)
    fix = ref.bfixmem
    np.testing.assert_array_equal(lanes[:, 2], np.where(fix.any(1), fix.argmax(1), -1))
    tabs = pathwise_gap_engine.gap_tables(g, "cpu")
    assert tabs.hard_rows == int((~ref.easy[1 : ref.n - 1]).sum())


def reject(g):
    """Make a node-start row's first pred block carry only a path that
    does not cover the node (the reference panics on such a graph)."""
    for i in range(1, g.n - 1):
        if not g.node_start[i]:
            continue
        off = np.flatnonzero(~g.paths_nodes[i])
        if len(off):
            p = g.preds_and_paths(i)[0][0]
            mask = np.zeros(g.paths_number, dtype=bool)
            mask[off[0]] = True
            g.pred_edges[i][p] = mask
            return g
    raise AssertionError("every node is on every path")


def test_rejected_graph_routes_to_the_oracle(example_paths, tmp_path, monkeypatch, capsys):
    jg, g = graphs("example", example_paths, tmp_path)
    with pytest.raises(jax_engine.RejectedGraph):
        jax_engine.gap_meta(reject(jg))
    with pytest.raises(pathwise_gap_engine.RejectedGraph):
        pathwise_gap_engine.gap_meta(reject(g))
    reads = tmp_path / "reads.fa"
    with open(example_paths[0]) as fh:
        reads.write_text("".join(fh.readlines()[:4]))
    for run_cli, cls, argv in ((cli.main, PathGraph, ["--device", "cpu"]),
                               (jax_cli.main, JaxPathGraph, [])):
        build = cls.from_gfa.__func__
        monkeypatch.setattr(cls, "from_gfa",
                            classmethod(lambda c, *a, b=build, **k: reject(b(c, *a, **k))))
        for mode in (6, 7):
            with pytest.raises(RuntimeError, match="empty common-paths set"):
                run_cli(["-m", str(mode), str(reads), example_paths[1], *argv])
        assert "device path unavailable" in capsys.readouterr().err
