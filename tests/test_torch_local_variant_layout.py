"""K13, K15 and K17, the rows-first forms of K2's kernel, and K16, its
scores-only form, on the CPU.

- The wrappers' host side: K13 (``fill_local_v1_cuda``), K15
  (``fill_local_v2_cuda``, int32 and int16), K17 (``fill_local_v4_cuda``)
  and K16 (``fill_local_scores_cuda``) launch with K2's layout
  (``cuda_poa_gap_local.plan``) and K2's stored rows (``stored_rows``:
  the far predecessors of start rows) at the smoke's launch shapes and
  at the edges of the layout's forms, and allocate no [B, n, Lp] score
  scratch.  The launches are recorded, not run (there is no card here):
  the inputs are ``meta`` tensors, so nothing of the planes is
  allocated.
- The int16 store width K15's flush takes for a row width.
- ``poa_variants.fill_local_v1``, ``fill_local_v2``,
  ``fill_local_scores`` and ``fill_local_v4`` (the plain versions on CPU
  tensors) against ``pallas_poa.fill_local``, ``pallas_poa_v2.
  fill_local_v2`` and the tools' ``pallas_poa_v3.fill_local_scores`` and
  ``pallas_poa_v4.fill_local_v4`` in the Pallas interpreter, on seeded
  graphs with n % 8 of 0, 1 and 7 (K15 zeroes 1, 8 and 2 rows past row
  n-2, K16 and K17 1, 0 and 2): equal dtype, shape and values.
"""

import os
import random
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recgraph_tpu.graph.poagraph import PoaGraph
from recgraph_tpu.ops import encode as jax_encode
from recgraph_tpu.ops import pallas_poa, pallas_poa_v2
from recgraph_tpu.scoring import ScoreMatrix
from recgraph_tpu_torch.graph.poagraph import PoaGraph as TorchPoaGraph
from recgraph_tpu_torch.io import gfa
from recgraph_tpu_torch.ops import _kernels, cuda_poa_local, cuda_poa_variants as cv
from recgraph_tpu_torch.ops import poa_variants
from recgraph_tpu_torch.ops.cuda_poa_gap_local import Plan
from recgraph_tpu_torch.ops.encode import PoaDeviceGraph, encode_reads, poa_device_graph

from test_fuzz_random_graphs import random_gfa, random_read
from test_torch_poa_variants import _tool

torch.set_num_threads(1)

EXAMPLE_GFA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "example", "graph.gfa")
SMS = 132   # an H100's SMs
# (reads, width) -> K2's layout: the smoke's launch shapes (a stretch chunk
# and the last one, 64 long reads) and the edges of the forms (one warp at
# 7 columns a lane, two warps, 16 warps, the full form)
SHAPES = {(3047, 152): Plan(1, 5, False), (859, 152): Plan(1, 5, False),
          (64, 2440): Plan(16, 5, False), (4, 224): Plan(1, 7, False),
          (4, 225): Plan(2, 5, False), (4, 3584): Plan(16, 7, False),
          (4, 3585): Plan(16, 9, True)}


@pytest.fixture(scope="module")
def example_dg():
    return poa_device_graph(TorchPoaGraph.from_gfa(gfa.parse_gfa(EXAMPLE_GFA)),
                            "cpu")


@pytest.fixture
def launches(monkeypatch):
    """The wrappers' C calls, recorded instead of made: (kernel, args)."""
    calls = []
    monkeypatch.setattr(_kernels, "check_inputs",
                        lambda kernel, dg, *rest: _kernels.graph_args(dg))
    monkeypatch.setattr(_kernels, "check_tensors", lambda *a, **k: None)
    monkeypatch.setattr(_kernels, "launch",
                        lambda kernel, shape, dev, *args: calls.append((kernel, args)))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=SMS))
    return calls


def _meta_batch(B, Lp):
    return (torch.empty((B, Lp), dtype=torch.int32, device="meta"),
            torch.empty(B, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("B, Lp", sorted(SHAPES))
def test_variants_launch_with_k2_layout_and_stored_rows(example_dg, launches, B, Lp):
    dg = example_dg
    n = dg.n
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table, dtype=torch.int32)
    seq, L = _meta_batch(B, Lp)
    cuda_poa_local.fill_local_cuda(dg, table, seq, L)
    cv.fill_local_v1_cuda(dg, table, seq, L)
    cv.fill_local_v2_cuda(dg, table, seq, L)
    cv.fill_local_v4_cuda(dg, table, seq, L)
    cv.fill_local_scores_cuda(dg, table, seq, L)
    # int16 where its values fit (max |table| 8: below 2,048 columns)
    i16 = 8 * Lp < cv.I16_MAX_SCORE
    if i16:
        cv.fill_local_v2_cuda(dg, table, seq, L, torch.int16)
    else:
        with pytest.raises(ValueError, match="int16"):
            cv.fill_local_v2_cuda(dg, table, seq, L, torch.int16)
    (k2, a2), (k13, a13), (k15, a15), (k17, a17), (k16, a16), *more = launches
    assert (k2, k13, k15, k17, k16) == ("poa_local", "poa_local_v1", "poa_local_v2",
                                        "poa_local_v4", "poa_local_scores")
    assert [k for k, _ in more] == ["poa_local_v2"] * i16
    pl = SHAPES[(B, Lp)]
    assert a2[12:16] == (pl.cw, pl.warps, int(pl.full), a2[15])
    store_at, srow, S = cuda_poa_local.stored_rows(dg, pl.full)
    assert a2[15] == S + int(pl.full)
    rows, r34 = cv.rows_v2(n), cv.rows_v34(n)
    # K16's last output is its score plane m: it passes no packed plane, and
    # reads every row back from it, so its scratch is the full form's G row
    forms = [(a13, (n,), (n, torch.int32), a2[15]), (a15, (rows, 0), (rows, torch.int32), a2[15]),
             (a17, (r34,), (r34, torch.int32), a2[15]), (a16, (r34,), (r34, torch.int32), 1)]
    forms += [(args, (rows, cv.i16_store_cells(Lp)), (rows, torch.int16), a2[15])
              for _, args in more]
    for args, form, packed, S_ in forms:
        k = len(form)
        # K2's inputs, stored rows, layout and scratch rows, then its outputs
        assert all(x is y for x, y in zip(args[:8], a2[:8]))
        assert args[6] is srow and args[7] is store_at
        assert args[8:12] == a2[8:12] == (B, n, dg.max_preds, Lp)
        assert args[12:12 + k] == form
        assert args[12 + k:16 + k] == (*a2[12:15], S_)
        ms, out = args[16 + k], args[17 + k:]
        assert a2[16].shape == (B, a2[15], Lp)
        assert ms.shape == (B, S_, Lp) and ms.dtype == torch.int32
        assert len(out) == 4 and [t.shape for t in out[:3]] == [(B,)] * 3
        assert out[3].shape == (packed[0], B, Lp) and out[3].dtype == packed[1]
        assert not any(t.shape == (B, n, Lp) for t in args if isinstance(t, torch.Tensor))


def test_int16_store_width(example_dg, launches):
    """8 cells a 16-byte store where a row of Lp int16 cells starts 16-byte
    aligned, else 2 a 4-byte store where Lp is even, else 1; K15 passes it
    to its C entry (0 at int32)."""
    widths = {8: 8, 152: 8, 2440: 8, 156: 2, 150: 2, 2: 2, 151: 1, 1: 1, 225: 1}
    assert {Lp: cv.i16_store_cells(Lp) for Lp in widths} == widths
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table, dtype=torch.int32)
    for Lp in (151, 152, 156):
        seq, L = _meta_batch(4, Lp)
        cv.fill_local_v2_cuda(example_dg, table, seq, L, torch.int16)
        cv.fill_local_v2_cuda(example_dg, table, seq, L)
    assert [args[13] for _, args in launches] == [1, 0, 8, 0, 2, 0]


# random_gfa(random.Random(seed), n_nodes=8) -> n % 8
GRAPH_SEEDS = {0: 16, 1: 6, 7: 1}


@pytest.mark.parametrize("rem", sorted(GRAPH_SEEDS))
def test_local_v1_v2_match_jax(rem):
    """K13, K15 (int32, int16), K16 and K17's plain versions against the
    JAX kernels in the interpreter."""
    rng = random.Random(GRAPH_SEEDS[rem])
    gf = random_gfa(rng, n_nodes=8, cover_all=True)
    reads = [random_read(rng, gf) for _ in range(8)]
    dg_j = jax_encode._build_poa_device_graph(PoaGraph.from_gfa(gf))
    assert dg_j.n % 8 == rem
    arrays = {f: np.asarray(getattr(dg_j, f)) for f in (
        "codes", "node_start", "pred_idx", "pred_mask", "min_pred", "r_values",
        "erank", "pred_rank")}
    arrays.update(sink_rows=dg_j.sink_rows, n=dg_j.n, max_preds=dg_j.max_preds,
                  compact_span=dg_j.compact_span)
    dg = PoaDeviceGraph.from_numpy(arrays, "cpu")
    sm = ScoreMatrix.create("none", 2, -4)
    seq_j, L_j = jax_encode.encode_reads(reads)
    table_j = jnp.asarray(sm.table, dtype=jnp.int32)
    seq, L = encode_reads(reads, device="cpu")
    table = torch.as_tensor(sm.table, dtype=torch.int32)
    cases = [(poa_variants.fill_local_v1(dg, table, seq, L),
              pallas_poa.fill_local(dg_j, table_j, seq_j, L_j, Bt=8, interpret=True))]
    for dt in ("int32", "int16"):
        cases.append((poa_variants.fill_local_v2(dg, table, seq, L, getattr(torch, dt)),
                      pallas_poa_v2.fill_local_v2(dg_j, table_j, seq_j, L_j, Bt=8, R=8,
                                                  interpret=True, dtype=getattr(jnp, dt))))
    cases.append((poa_variants.fill_local_scores(dg, table, seq, L),
                  _tool("pallas_poa_v3").fill_local_scores(dg_j, table_j, seq_j, L_j, Bt=8, R=8,
                                                           interpret=True)))
    cases.append((poa_variants.fill_local_v4(dg, table, seq, L),
                  _tool("pallas_poa_v4").fill_local_v4(dg_j, table_j, seq_j, L_j, Bt=8,
                                                       interpret=True)))
    n = dg.n
    rows = [n, cv.rows_v2(n), cv.rows_v2(n), cv.rows_v34(n), cv.rows_v34(n)]
    for k, (got, ref) in enumerate(cases):
        assert len(got) == len(ref) == 4
        for name, a, b in zip(("best_val", "best_i", "best_j", "packed"), got, ref):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, (k, name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{k} {name}")
        assert got[3].shape[0] == rows[k]
        assert not got[3][n - 1:].any() and not got[3][0].any()
