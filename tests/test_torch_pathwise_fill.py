"""The port's plain pathwise fill (the plain version of kernel K7, which
also stands for K9a) against the JAX engine's ``_fill_pathwise``.

The JAX fill stands in for the Pallas kernels fill_pathwise_v1 and
fill_pathwise_bigp, which the JAX package's own tests pin bit-exact to
it in interpret mode.  It runs with ``encode_chain`` set by the JAX
engine's gate (2 * Lp * max|score| < 2^16): the packed replay chain
where that holds, the exact one elsewhere.  The port always takes the
exact replay.  Inputs: the example corpus (23 paths, up to 9 groups a
row), a 126-path synthetic graph and an HOXD70 case past the gate.
Exact equality: every cell is an int32 score.
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
from recgraph_tpu.ops import encode as jax_encode
from recgraph_tpu.ops import pathwise_engine as jax_engine
from recgraph_tpu.scoring import ScoreMatrix
from recgraph_tpu_torch import metrics
from recgraph_tpu_torch.ops import cuda_pathwise, encode, pathwise_engine

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))

# the port's CPU path runs thousands of tiny ops; more intra-op threads only
# contend with the other test workers on the CPU
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpora(example_paths, tmp_path_factory):
    """name -> (JAX PathGraph, reads, matrix, pad_to)."""
    from make_synthetic import make

    out = tmp_path_factory.mktemp("p126")
    make(str(out), n_back=80, n_reads=8, seed=7, n_paths=126)
    ex_seqs, _ = fasta.get_sequences(example_paths[0])
    p_seqs, _ = fasta.get_sequences(str(out / "reads.fa"))
    ex = JaxPathGraph.from_gfa(jax_gfa.parse_gfa(example_paths[1]))
    p126 = JaxPathGraph.from_gfa(jax_gfa.parse_gfa(str(out / "graph.gfa")))
    return {
        "example": (ex, ex_seqs[:8], "none", None),
        "p126": (p126, p_seqs[:4], "none", None),
        # HOXD70 at 320 columns: 2 * Lp * max|score| >= 2^16, so the JAX
        # engine takes its exact replay (the packed chain would not fit)
        "hoxd70_wide": (ex, ex_seqs[8:12], "HOXD70", 320),
    }


def run_both(case, semiglobal):
    g, reads, matrix, pad_to = case
    sm = ScoreMatrix.create(matrix, 2, -4)
    jdg = jax_encode._build_path_device_graph(g)
    seq, _ = jax_encode.encode_reads(reads, pad_to=pad_to)
    fits = 2 * seq.shape[1] * int(np.abs(sm.table).max()) < (1 << 16)
    table = jnp.asarray(sm.table, dtype=jnp.int32)
    ref = np.asarray(jax_engine._fill_pathwise(jdg, table, seq, jnp.bool_(semiglobal),
                                               encode_chain=fits))
    arrays = {f: np.asarray(getattr(jdg, f)) for f in (
        "codes", "node_start", "paths_on", "alphas", "rep_of", "pred_of")}
    dg = encode.PathDeviceGraph.from_numpy(
        dict(arrays, n=jdg.n, paths_number=jdg.paths_number), "cpu")
    got = pathwise_engine.fill_pathwise_plain(
        dg, torch.as_tensor(sm.table, dtype=torch.int32),
        torch.from_numpy(np.array(seq)), semiglobal)
    return got, ref, fits


@pytest.mark.parametrize("name", ["example", "p126", "hoxd70_wide"])
@pytest.mark.parametrize("mode", [4, 5])
def test_plain_fill_matches_jax(corpora, name, mode):
    got, ref, fits = run_both(corpora[name], mode == 5)
    assert fits == (name != "hoxd70_wide")
    assert got.dtype == torch.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_best_runs_plain_on_cpu(corpora):
    """A CPU tensor takes the plain fill and launches nothing; the
    kernel's wrapper refuses CPU tensors (it never falls back)."""
    g, reads, _, _ = corpora["example"]
    sm = ScoreMatrix.create("none", 2, -4)
    dg = encode.build_path_device_graph(_port_graph(g), "cpu")
    table = torch.as_tensor(sm.table, dtype=torch.int32)
    seq, _ = encode.encode_reads(reads[:2])
    metrics.reset_phases()
    A = pathwise_engine.fill_pathwise_best(dg, table, seq, False)
    assert sum(metrics.LAUNCHES.values()) == 0
    assert torch.equal(A, pathwise_engine.fill_pathwise_plain(dg, table, seq, False))
    with pytest.raises(ValueError, match="needs CUDA"):
        cuda_pathwise.fill_pathwise_cuda(dg, table, seq, False)


def _port_graph(jax_g):
    from recgraph_tpu_torch.graph.pathgraph import PathGraph

    return PathGraph(**{f: getattr(jax_g, f) for f in (
        "lnz", "codes", "node_start", "pred_edges", "paths_nodes", "alphas",
        "paths_number", "nodes_id_pos")})
