"""The port's plain reverse pathwise fill (the plain version of kernel
K8, which also stands for K9b) against the JAX engine's
``_fill_pathwise_rev``.

The JAX fill stands in for the Pallas kernels fill_pathwise_rev_v1 and
fill_pathwise_rev_bigp, which the JAX package's own tests pin bit-exact
to it in interpret mode.  It runs with ``encode_chain`` both ways where
the packed chain fits (2 * Lp * max|score| < 2^16) and with the exact
replay where it does not; the port always takes the exact replay.  The
graph arrays reach the port through ``PathDeviceGraph.from_numpy``,
``qsrc_of`` included.  Inputs: the example corpus (23 paths), the
fragment graphs whose reverse graphs have delta-leak rows (clone rows
and ghost-alpha rows), and an HOXD70 case past the gate.  Exact
equality: every cell is an int32 score.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recgraph_tpu.graph.pathgraph import PathGraph as JaxPathGraph
from recgraph_tpu.io import fasta
from recgraph_tpu.io import gfa as jax_gfa
from recgraph_tpu.ops import encode as jax_encode
from recgraph_tpu.ops import recombination_engine as jax_rec
from recgraph_tpu.scoring import ScoreMatrix
from recgraph_tpu_torch import fuzz, metrics
from recgraph_tpu_torch.ops import cuda_pathwise_rev, encode, recombination_engine

from test_rev_fill_leak_rows import fragment_gfa

torch.set_num_threads(1)
FIELDS = ("codes", "node_start", "paths_on", "alphas", "rep_of", "pred_of", "qsrc_of")


def _cases(name, example_paths):
    """[(JAX reverse graph, reads, matrix, pad_to)] of the named corpus."""
    if name == "fragments":
        out = []
        for seed in fuzz.LEAK_SEEDS:
            gf = fragment_gfa(seed)
            reads = fuzz.fragment_reads(random.Random(seed * 31 + 5), gf, k=3)
            out.append((JaxPathGraph.from_gfa(gf).reverse(), reads, "none", None))
        return out
    seqs, _ = fasta.get_sequences(example_paths[0])
    rg = JaxPathGraph.from_gfa(jax_gfa.parse_gfa(example_paths[1])).reverse()
    if name == "example":
        return [(rg, seqs[:6], "none", None)]
    # HOXD70 at 320 columns: 2 * Lp * max|score| >= 2^16, past the gate
    return [(rg, seqs[6:9], "HOXD70", 320)]


def port_graph(jdg):
    arrays = {f: np.asarray(getattr(jdg, f)) for f in FIELDS}
    return encode.PathDeviceGraph.from_numpy(
        dict(arrays, n=jdg.n, paths_number=jdg.paths_number), "cpu")


def run_both(case, mode8, encode_chain):
    rg, reads, matrix, pad_to = case
    sm = ScoreMatrix.create(matrix, 2, -4)
    jdg = jax_rec._build_rev_device_graph(rg)
    seq, L = jax_encode.encode_reads(reads, pad_to=pad_to)
    table = jnp.asarray(sm.table, dtype=jnp.int32)
    ref = np.asarray(jax_rec._fill_pathwise_rev(jdg, table, seq, L, jnp.bool_(mode8),
                                                encode_chain=encode_chain))
    got = recombination_engine.fill_pathwise_rev_plain(
        port_graph(jdg), torch.as_tensor(sm.table, dtype=torch.int32),
        torch.from_numpy(np.array(seq)), torch.from_numpy(np.array(L)), mode8)
    return got, ref


@pytest.mark.parametrize("name", ["example", "fragments", "hoxd70_wide"])
@pytest.mark.parametrize("mode", [8, 9])
def test_plain_rev_fill_matches_jax(example_paths, name, mode):
    for case in _cases(name, example_paths):
        fits = 2 * max(case[3] or 0, max(map(len, case[1]))) * \
            int(np.abs(ScoreMatrix.create(case[2], 2, -4).table).max()) < (1 << 16)
        assert fits == (name != "hoxd70_wide")
        for encode_chain in (False, True) if fits else (False,):
            got, ref = run_both(case, mode == 8, encode_chain)
            assert got.dtype == torch.int32 and got.shape == ref.shape
            np.testing.assert_array_equal(got.numpy(), ref)


def test_from_numpy_carries_qsrc_of(example_paths):
    (rg, _, _, _), = _cases("example", example_paths)
    jdg = jax_rec._build_rev_device_graph(rg)
    dg = port_graph(jdg)
    np.testing.assert_array_equal(dg.qsrc_of.numpy(), np.asarray(jdg.qsrc_of))
    assert dg.qsrc_of.dtype == torch.int32
    assert encode.PathDeviceGraph.from_numpy(
        dict({f: np.asarray(getattr(jdg, f)) for f in FIELDS[:-1]}, n=jdg.n,
             paths_number=jdg.paths_number)).qsrc_of is None


def test_rev_best_runs_plain_on_cpu(example_paths):
    """A CPU tensor takes the plain fill and launches nothing; the
    kernel's wrapper refuses CPU tensors (it never falls back)."""
    (rg, reads, _, _), = _cases("example", example_paths)
    dgr = port_graph(jax_rec._build_rev_device_graph(rg))
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table, dtype=torch.int32)
    seq, L = encode.encode_reads(reads[:2])
    metrics.reset_phases()
    A = recombination_engine.fill_pathwise_rev_best(dgr, table, seq, L, True)
    assert sum(metrics.LAUNCHES.values()) == 0
    assert torch.equal(A, recombination_engine.fill_pathwise_rev_plain(dgr, table, seq, L, True))
    with pytest.raises(ValueError, match="needs CUDA"):
        cuda_pathwise_rev.fill_pathwise_rev_cuda(dgr, table, seq, L, True)
