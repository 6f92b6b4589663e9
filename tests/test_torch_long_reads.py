"""Reads of 1,024 columns or more through the port's pipeline on the CPU,
against the JAX pipeline: modes 0 and 2 through the W ladder, mode 1 at
full width, on the 3-read long-read fixture of test_windowed_band.py.

The comparisons are byte equality of GAF output.
"""

import pytest
import torch

from recgraph_tpu.align import pipeline as jax_pipeline
from recgraph_tpu_torch.align.pipeline import Options, run

from test_torch_pipeline import _capture
from test_windowed_band import long_corpus  # noqa: F401  (fixture)

# the port's CPU path runs thousands of tiny ops; more intra-op threads only
# contend with the other test workers on the CPU
torch.set_num_threads(1)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_long_reads_match_jax(long_corpus, mode):  # noqa: F811
    reads_fa, graph_gfa, _ = long_corpus
    ref = _capture(jax_pipeline.run, jax_pipeline.Options(
        reads_fa, graph_gfa, alignment_mode=mode, engine="jax"))
    got = _capture(run, Options(reads_fa, graph_gfa, alignment_mode=mode, device="cpu"))
    assert got == ref
    assert len(got.splitlines()) == 3
