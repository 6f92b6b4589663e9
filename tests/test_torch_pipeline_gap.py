"""The port's pipeline and CLI for the affine-gap modes 2 and 3 on the
CPU: goldens through the CLI, amb-strand against the JAX pipeline,
chunking, the oracle engine, and the chunk sizes of each mode.

The comparisons are byte equality of GAF output.
"""

import pytest
import torch

from recgraph_tpu_torch import cli, metrics
from recgraph_tpu_torch.align.pipeline import Options, run
from recgraph_tpu_torch.ops import poa_engine

from test_torch_pipeline import (
    _capture, _golden, _subset, check_amb_strand, check_chunking,
)

# the port's CPU path runs thousands of tiny ops; more intra-op threads only
# contend with the other test workers on the CPU
torch.set_num_threads(1)


@pytest.mark.parametrize("mode", [2, 3])
def test_golden_cpu(example_paths, tmp_path, mode):
    """``python -m recgraph_tpu_torch -m <mode> --device cpu ... -o out``
    writes the golden bytes, through the plain fills."""
    out = tmp_path / f"mode{mode}.gaf"
    metrics.reset_phases()
    _capture(cli.main, ["-m", str(mode), *example_paths, "-o", str(out), "--device", "cpu"])
    assert out.read_text() == _golden(f"mode{mode}")
    assert sum(metrics.LAUNCHES.values()) == 0 and not metrics.SHAPES
    assert metrics.PHASES["fill"] > 0 and metrics.PHASES["walk"] > 0
    metrics.count_launch("k", (1, 2, 3, 3))
    assert metrics.LAUNCHES == {"k": 1} and metrics.SHAPES == {("k", 1, 2, 3, 3): 1}
    metrics.reset_phases()
    assert not metrics.LAUNCHES and not metrics.SHAPES


@pytest.mark.parametrize("mode", [2, 3])
def test_amb_strand_matches_jax(example_paths, tmp_path, mode):
    check_amb_strand(example_paths, tmp_path, mode, 6)


@pytest.mark.parametrize("mode", [2, 3])
def test_output_does_not_depend_on_chunk_size(example_paths, monkeypatch, mode):
    check_chunking(example_paths, monkeypatch, mode, 4)


@pytest.mark.parametrize("mode", [2, 3])
def test_oracle_engine(example_paths, tmp_path, mode):
    reads = _subset(example_paths, tmp_path, 2)
    got = _capture(run, Options(reads, example_paths[1], alignment_mode=mode,
                                engine="oracle"))
    assert got.splitlines() == _golden(f"mode{mode}").splitlines()[:2]


def test_chunk_reads_sizes_by_what_each_mode_writes():
    """Modes 2/3 write three planes plus m/y scratch; long reads in modes
    0/2 store the ladder's window, not the whole read."""
    n, Lp = 2249, 152
    assert poa_engine.chunk_reads(1, n, Lp, 2, "cuda") == poa_engine.chunk_reads(
        0, n, Lp, 2, "cuda")
    assert poa_engine.chunk_reads(2, n, Lp, 2, "cuda") < poa_engine.chunk_reads(
        0, n, Lp, 2, "cuda") / 2
    poa_engine._long_w_hint.clear()
    assert poa_engine.plane_width(0, 3798, 2432, 25) == 256
    assert poa_engine.plane_width(2, 3798, 2432, 200) == 512
    assert poa_engine.plane_width(1, 3798, 2432, 25) == 2432
    assert poa_engine.plane_width(0, 3798, 512, 25) == 512
    assert poa_engine.chunk_reads(0, 3798, 2432, 25, "cuda") > 5 * poa_engine.chunk_reads(
        1, 3798, 2432, 25, "cuda")
