"""recgraph_tpu_torch encodings against the JAX package's, plus the
port's import and device contracts.

Exact equality throughout: every field is an int32/bool array.
"""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from recgraph_tpu.graph.poagraph import PoaGraph
from recgraph_tpu.io import fasta, gfa
from recgraph_tpu.ops import encode as jax_encode
from recgraph_tpu_torch import fuzz
from recgraph_tpu_torch.ops import encode

from test_fuzz_random_graphs import random_gfa, random_read

# the port's CPU path runs thousands of tiny ops; more intra-op threads only
# contend with the other test workers on the CPU
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [11, 12, 13]


def _graphs(example_paths):
    yield "example", PoaGraph.from_gfa(gfa.parse_gfa(example_paths[1]))
    yield "example_rev", PoaGraph.from_gfa(gfa.parse_gfa(example_paths[1]), amb_mode=True)
    for seed in SEEDS:
        rng = random.Random(seed)
        yield f"random{seed}", PoaGraph.from_gfa(random_gfa(rng, n_nodes=14 + 5 * (seed - 11)))


def _jax_graph_numpy(g):
    dg = jax_encode._build_poa_device_graph(g)
    out = {}
    for f in ("codes", "node_start", "pred_idx", "pred_mask", "min_pred",
              "r_values", "erank", "pred_rank", "sink_rows", "n", "max_preds",
              "compact_span"):
        v = getattr(dg, f)
        out[f] = v if isinstance(v, (int, tuple)) else np.asarray(v)
    return out


def _assert_graph_equal(a: dict, b: dict, name):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, (name, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}.{k}")
        else:
            assert a[k] == b[k], (name, k)


def test_device_graph_matches_jax(example_paths):
    for name, g in _graphs(example_paths):
        ref = _jax_graph_numpy(g)
        got = encode.build_poa_device_graph(g, "cpu").to_numpy()
        _assert_graph_equal(got, ref, name)
        # the JAX graph carried across through from_numpy
        carried = encode.PoaDeviceGraph.from_numpy(ref, "cpu").to_numpy()
        _assert_graph_equal(carried, ref, name + " via from_numpy")


def test_device_graph_cached_per_device(example_paths):
    g = PoaGraph.from_gfa(gfa.parse_gfa(example_paths[1]))
    dg = encode.poa_device_graph(g, "cpu")
    assert encode.poa_device_graph(g, torch.device("cpu")) is dg
    assert dg.device == torch.device("cpu")
    assert dg.codes.dtype == torch.int32 and dg.pred_mask.dtype == torch.bool


@pytest.mark.parametrize("pad_to", [None, 157])
def test_encode_reads_matches_jax(example_paths, pad_to):
    seqs, _ = fasta.get_sequences(example_paths[0])
    reads = seqs[:12] + ["$ACGTN", "$A"]
    ref_seq, ref_L = jax_encode.encode_reads(reads, pad_to=pad_to)
    seq, L = encode.encode_reads(reads, pad_to=pad_to, device="cpu")
    assert seq.dtype == torch.int32 and L.dtype == torch.int32
    assert seq.shape[1] % 8 == 0
    np.testing.assert_array_equal(seq.numpy(), np.asarray(ref_seq))
    np.testing.assert_array_equal(L.numpy(), np.asarray(ref_L))
    btas = [int(1 + 0.01 * len(s)) for s in reads]
    np.testing.assert_array_equal(
        encode.encode_read_aux(btas, "cpu").numpy(),
        np.asarray(jax_encode.encode_read_aux(btas)),
    )


@pytest.mark.parametrize("seed", [1, 101, 202])
def test_fuzz_copy_matches_tests(seed):
    """The package's seeded graph generator equals the tests' one."""
    a, b = random.Random(seed), random.Random(seed)
    ga = fuzz.random_gfa(a, n_nodes=24, n_paths=4, cover_all=True)
    gb = random_gfa(b, n_nodes=24, n_paths=4, cover_all=True)
    assert ga.segments == gb.segments and ga.edges == gb.edges
    assert [(p.name, p.nodes) for p in ga.paths] == [(p.name, p.nodes) for p in gb.paths]
    assert [fuzz.random_read(a, ga) for _ in range(4)] == [
        random_read(b, gb) for _ in range(4)
    ]


def test_port_never_imports_jax(example_paths, tmp_path):
    """Importing every module of the port and running the CPU pipeline on
    two example reads in modes 0-5, 8 and 9 leaves neither jax nor
    recgraph_tpu (or any of their submodules) in sys.modules."""
    seqs, names = fasta.get_sequences(example_paths[0])
    reads = tmp_path / "two.fa"
    reads.write_text("".join(f">{n}\n{s[1:]}\n" for n, s in zip(names[:2], seqs[:2])))
    code = (
        "import contextlib, io, pkgutil, importlib, sys, torch, recgraph_tpu_torch\n"
        "torch.set_num_threads(1)\n"
        "for m in pkgutil.walk_packages(recgraph_tpu_torch.__path__, 'recgraph_tpu_torch.'):\n"
        "    if m.name != 'recgraph_tpu_torch.__main__':\n"
        "        importlib.import_module(m.name)\n"
        "from recgraph_tpu_torch.align.pipeline import Options, run\n"
        "assert 'recgraph_tpu_torch.ops.cuda_poa_gap_global_win' in sys.modules\n"
        "assert 'recgraph_tpu_torch.ops.recombination_window' in sys.modules\n"
        "assert 'recgraph_tpu_torch.ops.cuda_pathwise_rev_win' in sys.modules\n"
        "for mode in (0, 1, 2, 3, 4, 5, 8, 9):\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        f"        run(Options({str(reads)!r}, {example_paths[1]!r}, alignment_mode=mode,\n"
        "                    device='cpu'))\n"
        "    assert len(buf.getvalue().splitlines()) == 2, mode\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib',\n"
        "             'recgraph_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    # one thread, as in the other CPU tests: the run shares the CPU with
    # the other test workers
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_device_raises_without_cuda(example_paths):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the device resolves")
    from recgraph_tpu_torch import _backend
    from recgraph_tpu_torch.align.pipeline import Options

    with pytest.raises(RuntimeError, match="cuda"):
        Options(*example_paths, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Options(*example_paths)          # the default device is cuda
    with pytest.raises(RuntimeError):
        _backend.resolve_device("cuda")
    assert _backend.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        _backend.resolve_device("mps")
    rep = _backend.report()
    assert rep["torch"] == torch.__version__ and rep["cuda_available"] is False
