"""The port's plain fills (modes 0/1) against the JAX package's fills, on the CPU.

``poa_engine._fill_global`` / ``_fill_local`` are the plain references
the Pallas kernels are pinned to (tests/test_pallas_poa.py,
tests/test_pallas_fuzz.py); the port's ``fill_global_plain`` /
``fill_local_plain`` must equal them exactly on every output, since
every output is an int32 DP value or index.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recgraph_tpu.graph.poagraph import PoaGraph
from recgraph_tpu.io import fasta, gfa
from recgraph_tpu.ops import encode as jax_encode
from recgraph_tpu.ops import poa_engine as jax_engine
from recgraph_tpu.scoring import ScoreMatrix
from recgraph_tpu_torch import metrics
from recgraph_tpu_torch.ops import cuda_poa_global, cuda_poa_local, poa_engine
from recgraph_tpu_torch.ops.encode import PoaDeviceGraph, encode_read_aux, encode_reads

from test_fuzz_random_graphs import random_gfa, random_read

# the port's CPU path runs thousands of tiny ops; more intra-op threads only
# contend with the other test workers on the CPU
torch.set_num_threads(1)

CASES = ["example", "random11", "random12", "random13"]


def _case(name, example_paths):
    """(PoaGraph, reads, btas) from a fixed seed."""
    if name == "example":
        seqs, _ = fasta.get_sequences(example_paths[0])
        g = PoaGraph.from_gfa(gfa.parse_gfa(example_paths[1]))
        reads = seqs[:10]
        btas = [int(1 + 0.01 * len(s)) for s in reads]
    else:
        seed = int(name[len("random"):])
        rng = random.Random(seed)
        gf = random_gfa(rng, n_nodes=14 + 5 * (seed - 11), cover_all=True)
        g = PoaGraph.from_gfa(gf)
        reads = [random_read(rng, gf) for _ in range(6)]
        # a narrow band on one read exercises the band edges
        btas = [int(1 + 0.1 * len(s)) for s in reads[:-1]] + [1]
    return g, reads, btas


def _inputs(g, reads, btas, sm):
    """The same inputs for both packages; the port's graph is the JAX
    graph carried across through from_numpy."""
    dg_j = jax_encode._build_poa_device_graph(g)
    seq_j, L_j = jax_encode.encode_reads(reads)
    table_j = jnp.asarray(sm.table, dtype=jnp.int32)
    arrays = {f: np.asarray(getattr(dg_j, f)) for f in (
        "codes", "node_start", "pred_idx", "pred_mask", "min_pred", "r_values",
        "erank", "pred_rank")}
    arrays.update(sink_rows=dg_j.sink_rows, n=dg_j.n, max_preds=dg_j.max_preds,
                  compact_span=dg_j.compact_span)
    dg = PoaDeviceGraph.from_numpy(arrays, "cpu")
    seq, L = encode_reads(reads, device="cpu")
    table = torch.as_tensor(sm.table, dtype=torch.int32)
    bta_j = jax_encode.encode_read_aux(btas)
    bta = encode_read_aux(btas, "cpu")
    return (dg_j, table_j, seq_j, L_j, bta_j), (dg, table, seq, L, bta)


def _assert_outputs_equal(got, ref, names):
    assert len(got) == len(ref) == len(names)
    for name, a, b in zip(names, got, ref):
        a = a.numpy()
        b = np.asarray(b)
        assert a.dtype == np.int32, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_fill_global_plain_matches_jax(example_paths, case):
    g, reads, btas = _case(case, example_paths)
    sm = ScoreMatrix.create("none", 2, -4)
    jx, pt = _inputs(g, reads, btas, sm)
    ref = jax_engine._fill_global(*jx)
    got = poa_engine.fill_global_plain(*pt)
    _assert_outputs_equal(
        got, ref, ["score", "last_row", "last_col_abs", "packed", "lefts", "rights"]
    )
    assert not got[3][:, -1].any()         # row n-1 stays zero


@pytest.mark.parametrize("matrix", ["none", "HOXD70"])
@pytest.mark.parametrize("case", CASES)
def test_fill_local_plain_matches_jax(example_paths, case, matrix):
    g, reads, btas = _case(case, example_paths)
    sm = ScoreMatrix.create(matrix, 2, -4)
    jx, pt = _inputs(g, reads, btas, sm)
    ref = jax_engine._fill_local(*jx[:4])
    got = poa_engine.fill_local_plain(*pt[:4])
    _assert_outputs_equal(got, ref, ["best_val", "best_i", "best_j", "packed"])


def test_cpu_dispatch_runs_plain_and_launches_nothing(example_paths):
    g, reads, btas = _case("random11", example_paths)
    sm = ScoreMatrix.create("none", 2, -4)
    _, (dg, table, seq, L, bta) = _inputs(g, reads, btas, sm)
    metrics.reset_phases()
    for got, ref in (
        (poa_engine.fill_global_best(dg, table, seq, L, bta),
         poa_engine.fill_global_plain(dg, table, seq, L, bta)),
        (poa_engine.fill_local_best(dg, table, seq, L),
         poa_engine.fill_local_plain(dg, table, seq, L)),
    ):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert metrics.LAUNCHES[cuda_poa_global.KERNEL] == 0
    assert metrics.LAUNCHES[cuda_poa_local.KERNEL] == 0


def test_unported_shapes_and_devices_raise(example_paths):
    """Reads of 1,024 columns or more run in both dispatchers (no long-read
    guard is left) and equal the JAX fills; the CUDA wrappers still refuse
    CPU tensors."""
    g, reads, btas = _case("random12", example_paths)
    sm = ScoreMatrix.create("none", 2, -4)
    rng = random.Random(12)
    long_reads = reads[:2] + ["$" + "".join(rng.choice("ACGT") for _ in range(1100))]
    long_btas = btas[:2] + [20]
    jx, (dg, table, seq, L, bta) = _inputs(g, long_reads, long_btas, sm)
    assert seq.shape[1] >= poa_engine.LONG_READ_LP
    _assert_outputs_equal(
        poa_engine.fill_global_best(dg, table, seq, L, bta), jax_engine._fill_global(*jx),
        ["score", "last_row", "last_col_abs", "packed", "lefts", "rights"])
    _assert_outputs_equal(
        poa_engine.fill_local_best(dg, table, seq, L), jax_engine._fill_local(*jx[:4]),
        ["best_val", "best_i", "best_j", "packed"])
    # the CUDA wrappers take CUDA tensors only; they never run the plain path
    with pytest.raises(ValueError, match="CUDA"):
        cuda_poa_global.fill_global_cuda(dg, table, seq, L, bta)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_poa_local.fill_local_cuda(dg, table, seq, L)
