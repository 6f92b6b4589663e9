"""The port's plain affine-gap fills (modes 2/3) against the JAX package's
XLA fills, on the CPU.

``poa_gap_engine._fill_gap_global`` / ``_fill_gap_local`` are the plain
references the Pallas kernels are pinned to (tests/test_pallas_gap.py);
``fill_gap_global_plain`` / ``fill_gap_local_plain`` must equal them
exactly on every output, since every output is an int32 DP value or
index.  The penalties cover both signs: (o, e) = (+1, -2) takes the
general 2x2 (max,+) scan in both packages.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recgraph_tpu.graph.poagraph import PoaGraph
from recgraph_tpu.io import fasta, gfa
from recgraph_tpu.ops import poa_gap_engine as jax_gap
from recgraph_tpu.scoring import ScoreMatrix
from recgraph_tpu_torch import metrics
from recgraph_tpu_torch.ops import cuda_poa_gap_global, cuda_poa_gap_local, poa_gap_engine

from test_fuzz_random_graphs import random_gfa, random_read
from test_torch_poa_fill import _assert_outputs_equal, _inputs

# the port's CPU path runs thousands of tiny ops; more intra-op threads only
# contend with the other test workers on the CPU
torch.set_num_threads(1)

PENALTIES = [(-4, -2), (-1, -1), (0, -1), (1, -2)]
GLOBAL_NAMES = ["score", "last_row", "last_col_abs", "packed", "packed_x", "packed_y",
                "lefts", "rights"]
LOCAL_NAMES = ["best_val", "best_i", "best_j", "packed", "packed_x", "packed_y"]


def _case(name, example_paths):
    """(PoaGraph, reads, btas) from a fixed seed."""
    if name.startswith("example"):
        seqs, _ = fasta.get_sequences(example_paths[0])
        g = PoaGraph.from_gfa(gfa.parse_gfa(example_paths[1]), amb_mode=name.endswith("rev"))
        reads = seqs[:3] if not name.endswith("rev") else [
            "$" + "".join({"A": "T", "C": "G", "G": "C", "T": "A"}.get(c, c)
                          for c in reversed(s[1:])) for s in seqs[3:6]]
        return g, reads, [int(1 + 0.01 * len(s)) for s in reads]
    seed = int(name[len("random"):])
    rng = random.Random(seed)
    # 5-12 predecessors in the widest row: the sink row F collects every
    # path end (random303 is chip_smoke.py's graph with 12)
    if seed == 303:
        gf = random_gfa(rng, n_nodes=24, n_paths=4, cover_all=True)
    else:
        gf = random_gfa(rng, n_nodes=16 + seed % 7, n_paths=6, cover_all=True)
    g = PoaGraph.from_gfa(gf)
    reads = [random_read(rng, gf) for _ in range(5)]
    # a narrow band on one read exercises the band edges
    return g, reads, [int(1 + 0.1 * len(s)) for s in reads[:-1]] + [1]


CASES = ["example", "example_rev", "random31", "random32", "random33", "random303"]


@pytest.mark.parametrize("case", CASES)
def test_fill_gap_global_plain_matches_jax(example_paths, case):
    """Every penalty pair on the example and one random graph, both signs
    of the gap open elsewhere; the example also under HOXD70."""
    g, reads, btas = _case(case, example_paths)
    matrices = ["none", "HOXD70"] if case == "example" else ["none"]
    penalties = PENALTIES if case in ("example", "random31") else [(-4, -2), (1, -2)]
    for matrix in matrices:
        sm = ScoreMatrix.create(matrix, 2, -4)
        jx, pt = _inputs(g, reads, btas, sm)
        for o, e in penalties:
            ref = jax_gap._fill_gap_global(*jx, jnp.int32(o), jnp.int32(e))[:8]
            got = poa_gap_engine.fill_gap_global_plain(*pt, o, e)
            _assert_outputs_equal(got, ref, GLOBAL_NAMES)
            assert not got[3][:, -1].any()         # row n-1 stays zero


@pytest.mark.parametrize("matrix", ["none", "HOXD70"])
def test_fill_gap_local_plain_matches_jax(example_paths, matrix):
    """Every case, both signs of the gap open; the transposed table makes
    HOXD70 (asymmetric) a case of its own."""
    sm = ScoreMatrix.create(matrix, 2, -4)
    for case in CASES:
        g, reads, btas = _case(case, example_paths)
        jx, pt = _inputs(g, reads, btas, sm)
        for o, e in ((-4, -2), (1, -2)) if case != "example" else PENALTIES:
            ref = jax_gap._fill_gap_local(*jx[:4], jnp.int32(o), jnp.int32(e))
            got = poa_gap_engine.fill_gap_local_plain(*pt[:4], o, e)
            _assert_outputs_equal(got, ref, LOCAL_NAMES)


def test_affine_row_scan_matches_jax():
    """The doubling scan equals the JAX associative scan on random rows,
    band starts and penalties of both signs."""
    rng = np.random.default_rng(7)
    B, W = 6, 37
    for o, e in PENALTIES:
        c = rng.integers(-60, 60, size=(B, W)).astype(np.int32)
        left = rng.integers(0, W // 2, size=B)
        right = np.minimum(W, left + rng.integers(1, W, size=B))
        jcol = np.arange(W)[None, :]
        in_band = (left[:, None] <= jcol) & (jcol < right[:, None])
        is_left = jcol == left[:, None]
        v_left = rng.integers(-30, 30, size=(B, 2)).astype(np.int32)
        ref = jax_gap._affine_row_scan(
            jnp.asarray(c), jnp.asarray(v_left), jnp.asarray(is_left),
            jnp.asarray(in_band), jnp.int32(o), jnp.int32(e))
        got = poa_gap_engine._affine_row_scan(
            torch.from_numpy(c), torch.from_numpy(v_left), torch.from_numpy(is_left),
            torch.from_numpy(in_band), o, e)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(
                np.where(in_band, a.numpy(), 0), np.where(in_band, np.asarray(b), 0))


def test_cpu_gap_dispatch_runs_plain_and_launches_nothing(example_paths):
    g, reads, btas = _case("random31", example_paths)
    sm = ScoreMatrix.create("none", 2, -4)
    _, (dg, table, seq, L, bta) = _inputs(g, reads, btas, sm)
    metrics.reset_phases()
    for got, ref in (
        (poa_gap_engine.fill_gap_global_best(dg, table, seq, L, bta, -4, -2),
         poa_gap_engine.fill_gap_global_plain(dg, table, seq, L, bta, -4, -2)),
        (poa_gap_engine.fill_gap_local_best(dg, table, seq, L, -4, -2),
         poa_gap_engine.fill_gap_local_plain(dg, table, seq, L, -4, -2)),
    ):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert sum(metrics.LAUNCHES.values()) == 0
    # the CUDA wrappers take CUDA tensors only; they never run the plain path
    with pytest.raises(ValueError, match="CUDA"):
        cuda_poa_gap_global.fill_gap_global_cuda(dg, table, seq, L, bta, -4, -2)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_poa_gap_local.fill_gap_local_cuda(dg, table, seq, L, -4, -2)
