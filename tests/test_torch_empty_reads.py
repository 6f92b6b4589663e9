"""A reads file with no reads, in all ten modes (the port on the CPU).

The reference's loop over the reads writes nothing, so every mode
prints no line and finishes: ``Done in N.`` on stderr, nothing on
stdout, and with ``-o`` no line in the file.  In modes 0-3 the output
equals recgraph_tpu's on the same input.  recgraph_tpu raises in modes
4-9 (``ops/pathwise_engine.py:223 _align_lp``); the port does not copy
that.
"""

import contextlib
import io
import os
import subprocess
import sys

import pytest
import torch

from recgraph_tpu.align import pipeline as jax_pipeline
from recgraph_tpu_torch import cli

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def empty_fa(tmp_path):
    path = tmp_path / "empty.fa"
    path.write_text("")
    return str(path)


def _capture(fn, *a, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        fn(*a, **kw)
    return out.getvalue(), err.getvalue()


def _lines_in(path):
    """The lines written to ``path`` (none when the file was not made)."""
    return open(path).read().splitlines() if os.path.exists(path) else []


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_modes_0_3_match_jax(example_paths, empty_fa, tmp_path, mode):
    graph = example_paths[1]
    ref = _capture(jax_pipeline.run, jax_pipeline.Options(
        empty_fa, graph, alignment_mode=mode, engine="jax"))
    got = _capture(cli.main, ["-m", str(mode), empty_fa, graph, "--device", "cpu"])
    assert got[0] == ref[0] == ""
    # recgraph_tpu's stderr may first say how it shards the reads
    assert got[1].startswith("Done in ") and ref[1].splitlines()[-1].startswith("Done in ")
    _capture(jax_pipeline.run, jax_pipeline.Options(
        empty_fa, graph, out_file=str(tmp_path / "jax.gaf"), alignment_mode=mode, engine="jax"))
    _capture(cli.main, ["-m", str(mode), empty_fa, graph, "--device", "cpu", "-o",
                        str(tmp_path / "port.gaf")])
    assert os.path.exists(tmp_path / "port.gaf") == os.path.exists(tmp_path / "jax.gaf")
    assert _lines_in(tmp_path / "port.gaf") == _lines_in(tmp_path / "jax.gaf") == []


@pytest.mark.parametrize("mode", [4, 5, 6, 7, 8, 9])
def test_modes_4_9_write_nothing(example_paths, empty_fa, tmp_path, mode):
    graph = example_paths[1]
    out, err = _capture(cli.main, ["-m", str(mode), empty_fa, graph, "--device", "cpu"])
    assert out == "" and err.startswith("Done in ")
    gaf = tmp_path / "out.gaf"
    out, err = _capture(cli.main, ["-m", str(mode), empty_fa, graph, "--device", "cpu",
                                   "-o", str(gaf)])
    assert out == "" and err.startswith("Done in ") and _lines_in(gaf) == []


def test_cli_exits_0(example_paths, empty_fa):
    """``python -m recgraph_tpu_torch`` on no reads exits 0 and prints
    nothing on stdout."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-m", "recgraph_tpu_torch", "-m", "4", empty_fa, example_paths[1],
         "--device", "cpu"], capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout == "" and res.stderr.startswith("Done in ")
