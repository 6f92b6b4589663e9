"""The port's K13-K17 (the superseded mode-0/1 fill generations) and
``walk_local_scores`` against the JAX package's, on the CPU.

On CPU tensors ``poa_variants`` runs each kernel's plain version (the
plain fill plus its layout); the JAX kernels run in the Pallas
interpreter.  Every output must be equal, dtype and row padding
included: int32 (or K15's int16) DP values, indices and packed cells,
zeroed rows past n-2, and K14's lanes Lp..Lp+7.  The v3 and v4 kernels
live in ``tools/`` with package-relative imports, so they are loaded
from their files under the module names they were written for; nothing
of the JAX package changes.
"""

import importlib.util
import os
import random
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recgraph_tpu.graph.poagraph import PoaGraph
from recgraph_tpu.ops import encode as jax_encode
from recgraph_tpu.ops import pallas_poa, pallas_poa_v2
from recgraph_tpu.scoring import ScoreMatrix
from recgraph_tpu_torch import metrics
from recgraph_tpu_torch.ops import cuda_poa_variants as cv
from recgraph_tpu_torch.ops import poa_engine, poa_variants, traceback_engine as tb
from recgraph_tpu_torch.ops.encode import PoaDeviceGraph, encode_read_aux, encode_reads

from test_fuzz_random_graphs import random_gfa, random_read

# the port's CPU path runs thousands of tiny ops; more intra-op threads only
# contend with the other test workers on the CPU
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 63


def _tool(name):
    """tools/<name>.py loaded as recgraph_tpu.ops.<name> (its relative
    imports resolve against the JAX package)."""
    full = f"recgraph_tpu.ops.{name}"
    if full not in sys.modules:
        spec = importlib.util.spec_from_file_location(full, os.path.join(ROOT, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[full] = mod
        spec.loader.exec_module(mod)
    return sys.modules[full]


@pytest.fixture(scope="module")
def inputs():
    """One seeded random graph (20 nodes) and 8 reads, for both packages."""
    rng = random.Random(SEED)
    gf = random_gfa(rng, n_nodes=20, cover_all=True)
    g = PoaGraph.from_gfa(gf)
    reads = [random_read(rng, gf) for _ in range(8)]
    btas = [int(1 + 0.1 * len(s)) for s in reads[:-1]] + [1]   # one narrow band
    sm = ScoreMatrix.create("none", 2, -4)
    dg_j = jax_encode._build_poa_device_graph(g)
    seq_j, L_j = jax_encode.encode_reads(reads)
    arrays = {f: np.asarray(getattr(dg_j, f)) for f in (
        "codes", "node_start", "pred_idx", "pred_mask", "min_pred", "r_values",
        "erank", "pred_rank")}
    arrays.update(sink_rows=dg_j.sink_rows, n=dg_j.n, max_preds=dg_j.max_preds,
                  compact_span=dg_j.compact_span)
    dg = PoaDeviceGraph.from_numpy(arrays, "cpu")
    seq, L = encode_reads(reads, device="cpu")
    jx = (dg_j, jnp.asarray(sm.table, dtype=jnp.int32), seq_j, L_j,
          jax_encode.encode_read_aux(btas))
    pt = (dg, torch.as_tensor(sm.table, dtype=torch.int32), seq, L, encode_read_aux(btas, "cpu"))
    return jx, pt


def _equal(got, ref, names):
    assert len(got) == len(ref) == len(names)
    for name, a, b in zip(names, got, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)


LOCAL = ["best_val", "best_i", "best_j", "plane"]


def test_local_v1_matches_jax(inputs):
    jx, pt = inputs
    _equal(poa_variants.fill_local_v1(*pt[:4]),
           pallas_poa.fill_local(*jx[:4], Bt=8, interpret=True), LOCAL)


def test_global_v1_matches_jax(inputs):
    """K14, band lanes Lp and Lp + 1 and the zero lanes Lp + 2..Lp + 7
    included; the narrow band of the last read exercises the edges."""
    jx, pt = inputs
    got = poa_variants.fill_global_v1(*pt)
    _equal(got, pallas_poa.fill_global(*jx, Bt=8, interpret=True),
           ["score", "last_row", "last_col_abs", "packed"])
    Lp = pt[2].shape[1]
    assert got[3].shape[2] == Lp + 8 and not got[3][:, :, Lp + 2:].any()
    assert not got[3][-1].any()


@pytest.mark.parametrize("dtype", ["int32", "int16"])
def test_local_v2_matches_jax(inputs, dtype):
    jx, pt = inputs
    got = poa_variants.fill_local_v2(*pt[:4], getattr(torch, dtype))
    _equal(got, pallas_poa_v2.fill_local_v2(*jx[:4], Bt=8, R=8, interpret=True,
                                            dtype=getattr(jnp, dtype)), LOCAL)
    n = pt[0].n
    assert got[3].shape[0] == cv.rows_v2(n) and not got[3][n - 1:].any()


def test_local_scores_matches_jax(inputs):
    jx, pt = inputs
    got = poa_variants.fill_local_scores(*pt[:4])
    _equal(got, _tool("pallas_poa_v3").fill_local_scores(*jx[:4], Bt=8, R=8, interpret=True),
           LOCAL)
    assert got[3].shape[0] == cv.rows_v34(pt[0].n)


def test_local_v4_matches_jax(inputs):
    jx, pt = inputs
    got = poa_variants.fill_local_v4(*pt[:4])
    _equal(got, _tool("pallas_poa_v4").fill_local_v4(*jx[:4], Bt=8, interpret=True), LOCAL)
    assert got[3].shape[0] == cv.rows_v34(pt[0].n)


def test_walk_local_scores_matches_jax_and_walk_poa(inputs):
    """The port's walk over its plain score plane equals the JAX walk over
    the JAX scores-only kernel's plane, and walk_poa over the plain fill's
    packed planes (compacted walks, step counts and stop cells)."""
    jx, pt = inputs
    v3 = _tool("pallas_poa_v3")
    dg_j, table_j, seq_j, L_j, _ = jx
    dg, table, seq, L, _ = pt
    W = tb.max_walk_steps(dg.n, seq.shape[1])
    bv, bi, bj, m = poa_variants.fill_local_scores(dg, table, seq, L)
    got = tb.walk_local_scores(m, seq, table, dg.node_start, dg.codes, dg.pred_idx, bi, bj, W)
    _, bi_j, bj_j, m_j = v3.fill_local_scores(dg_j, table_j, seq_j, L_j, Bt=8, R=8,
                                              interpret=True)
    ref = v3.walk_local_scores(m_j, seq_j, table_j, dg_j.node_start, dg_j.codes,
                               dg_j.pred_idx, bi_j, bj_j, max_steps=W)
    _equal(got, ref, ["dirs", "rows", "steps", "row", "col"])

    _, _, _, packed = poa_engine.fill_local_plain(dg, table, seq, L)
    dirs, rows, steps, stop_row, stop_col = tb.walk_poa(packed, bi, bj, W)[:5]
    assert torch.equal(steps, got[2]) and steps.min() > 0
    assert torch.equal(stop_row, got[3]) and torch.equal(stop_col, got[4])
    for b in range(seq.shape[0]):
        d, r = tb.compact_walk(dirs[b].numpy(), rows[b].numpy(), int(steps[b]))
        k = int(got[2][b])
        np.testing.assert_array_equal(d, got[0][b, :k].numpy())
        np.testing.assert_array_equal(r, got[1][b, :k].numpy())


def test_int16_planes_past_their_limits_raise(inputs):
    """K15 at int16 raises where the TPU kernel's int16 planes would wrap
    (n >= 2,048, or max |table| * Lp >= 16k), on either device's path."""
    _, (dg, table, seq, L, _) = inputs
    with pytest.raises(ValueError, match="int16"):
        poa_variants.fill_local_v2(dg, table * 1000, seq, L, torch.int16)
    with pytest.raises(ValueError, match="int16"):
        cv.check_dtype(torch.int16, 2048, table, seq.shape[1])
    with pytest.raises(ValueError, match="int32 or int16"):
        poa_variants.fill_local_v2(dg, table, seq, L, torch.int64)
    cv.check_dtype(torch.int16, 2047, table, seq.shape[1])


def test_cpu_dispatch_runs_plain_and_launches_nothing(inputs):
    """CPU tensors take the plain versions; the CUDA wrappers refuse them."""
    _, pt = inputs
    metrics.reset_phases()
    poa_variants.fill_local_v1(*pt[:4])
    poa_variants.fill_global_v1(*pt)
    assert not any(metrics.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA"):
        cv.fill_local_scores_cuda(*pt[:4])
    with pytest.raises(ValueError, match="CUDA"):
        cv.fill_global_v1_cuda(*pt)


def test_kernel_ab_on_the_cpu():
    """The A/B entry point on the CPU: every variant asked for is held to
    its plain version (v3 with its walk against walk_poa's); the JAX
    tool's variants that set TPU knobs are refused with the reason."""
    from recgraph_tpu_torch import kernel_ab

    res = kernel_ab.run(2, ["v3", "v1"], "cpu")
    assert all(r["equal"] for r in res.values()) and "walk_ms" in res["v3"]
    for name in ("v4r16", "v5bt32", "v4-sweep", "xla"):
        with pytest.raises(ValueError, match="not ported"):
            kernel_ab.run(2, [name], "cpu")
