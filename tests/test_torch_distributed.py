"""The port's scale-out on the CPU: multi-process runs through the CLI
(two ``python -m recgraph_tpu_torch`` workers joined by
``torch.distributed``, part files merged by process 0; the counterpart
of tests/test_distributed.py) and the data-parallel read split
(``parallel.mesh``) over an explicit device list, held byte for byte to
the one-device run."""

import contextlib
import io
import os
import socket
import subprocess
import sys
from unittest import mock

import pytest
import torch

from recgraph_tpu.io import fasta as jax_fasta
from recgraph_tpu_torch import cli, metrics
from recgraph_tpu_torch.align import pipeline
from recgraph_tpu_torch.align.pipeline import Options, run
from recgraph_tpu_torch.io.gaf import GafWriter
from recgraph_tpu_torch.parallel import mesh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")
DP_LINE = "data-parallel: sharding reads over 2 local devices"


def _subset(example_paths, tmp_path, k):
    seqs, names = jax_fasta.get_sequences(example_paths[0])
    path = tmp_path / f"reads{k}.fa"
    path.write_text("".join(f">{n}\n{s[1:]}\n" for n, s in zip(names[:k], seqs[:k])))
    return str(path)


def _run(opts, devices=None):
    """The port's run: (stdout, stderr, the -o file's text or None)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        run(opts, devices)
    text = None
    if opts.out_file != "standard output":
        with open(opts.out_file) as fh:
            text = fh.read()
    return out.getvalue(), err.getvalue(), text


class _Tee:
    """The run's GAF writer, writing each record both to the -o file and
    to stdout, as a run with ``-o`` and one without would: the pipeline
    differs between the two only in its writer, so one engine call gives
    both outputs."""

    def __init__(self, out_file, number_offset=0):
        self.sinks = (GafWriter(out_file, number_offset), GafWriter(number_offset=number_offset))

    def write(self, line, number):
        for w in self.sinks:
            w.write(line, number)


def _run_both(opts, devices=None):
    """:func:`_run` with ``-o`` and without, from one run: (stdout, stderr,
    the -o file's text)."""
    with mock.patch.object(pipeline, "GafWriter", _Tee):
        return _run(opts, devices)


@pytest.fixture(scope="module")
def one_device(example_paths, tmp_path_factory):
    """The one-device run of the first k example reads in a mode, once a
    module: (reads file, (stdout, stderr, the -o file's text))."""
    d = tmp_path_factory.mktemp("one_device")
    memo = {}

    def get(mode, k):
        if (mode, k) not in memo:
            reads = _subset(example_paths, d, k)
            out = str(d / f"mode{mode}_{k}.gaf")
            memo[mode, k] = reads, _run_both(Options(reads, example_paths[1], out_file=out,
                                                     alignment_mode=mode, device="cpu"))
        return memo[mode, k]

    return get


def _spawn(mode_args, reads, graph, out, nproc=2):
    """``nproc`` CLI workers; returns their (returncode, stdout, stderr)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        addr = f"localhost:{s.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", RECGRAPH_METRICS="1")
    env.pop("RECGRAPH_RESUME", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "recgraph_tpu_torch", *mode_args, reads, graph, "-o", out,
         "--device", "cpu", "--num-processes", str(nproc), "--process-id", str(k),
         "--coordinator", addr],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(nproc)]
    res = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=240)
            res.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


def _check_workers(res):
    for k, (rc, _, se) in enumerate(res):
        assert rc == 0, se[-2000:]
        assert f"recgraph-timing: pid={k}/{len(res)} setup=" in se


def test_two_process_mode1_equals_golden(example_paths, tmp_path):
    out = str(tmp_path / "out.gaf")
    _check_workers(_spawn(["-m", "1"], *example_paths, out))
    with open(os.path.join(GOLDEN_DIR, "mode1.gaf")) as fh:
        assert open(out).read() == fh.read()
    assert os.path.exists(out + ".part0") and os.path.exists(out + ".part1")


def test_two_process_mode4_equals_one_process(example_paths, tmp_path, one_device):
    reads, one = one_device(4, 12)
    out = str(tmp_path / "out.gaf")
    # a stale part from an earlier run is removed, not appended to
    with open(out + ".part1", "w") as fh:
        fh.write("stale\n")
    _check_workers(_spawn(["-m", "4"], reads, example_paths[1], out))
    # -o drops read 0's line in process 0's part, as in the one-process run
    assert open(out).read() == one[2] and len(one[2].splitlines()) == 11


def test_two_process_mode6_writes_parts(example_paths, tmp_path):
    reads = _subset(example_paths, tmp_path, 4)
    out = str(tmp_path / "out.txt")
    res = _spawn(["-m", "6"], reads, example_paths[1], out)
    _check_workers(res)
    assert all(so == "" for _, so, _ in res)
    # the one-process stdout of these reads: the first 8 lines of the
    # 52-read one-process run that mode6_full.txt holds
    with open(os.path.join(GOLDEN_DIR, "mode6_full.txt")) as fh:
        one = "".join(fh.readlines()[:8])
    # each process numbers its reads from its first read's global index
    assert open(out).read() == one and one.count("Best path sequence") == 4
    part1 = open(out + ".part1").read().splitlines()
    assert [ln.split(":")[0] for ln in part1[1::2]] == [
        "Best path sequence 2", "Best path sequence 3"]


def test_multi_process_needs_out_file(example_paths, capsys):
    # no coordinator listens: the run must stop before it tries to join
    with pytest.raises(SystemExit) as exc:
        cli.main([*example_paths, "--device", "cpu", "--num-processes", "2",
                  "--process-id", "0", "--coordinator", "localhost:1"])
    assert exc.value.code == "multi-process runs require -o <file>"
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("mode", [1, 4, 8])
def test_data_parallel_matches_one_device(example_paths, tmp_path, one_device, mode):
    reads, one = one_device(mode, 12)
    assert DP_LINE not in one[1]
    metrics.reset_phases()
    two = _run_both(Options(reads, example_paths[1], out_file=str(tmp_path / "out.gaf"),
                            alignment_mode=mode, device="cpu"), ["cpu", "cpu"])
    assert DP_LINE in two[1]
    # stdout, then the -o file, where read 0's line is dropped in modes 4 and 8
    assert two[0] == one[0] and len(one[0].splitlines()) == 12
    assert two[2] == one[2] and len(one[2].splitlines()) == (11 if mode in (4, 8) else 12)
    # each slice's phases add up in the run's
    assert metrics.PHASES["fill"] > 0 and not metrics._stack


def test_data_parallel_out_file_few_reads(example_paths, tmp_path):
    # mode 4 with -o: the truncate-at-number-1 rule applies once, to the
    # merged records, whatever slice read 0 and read 1 land in
    for k in (1, 2, 3):
        reads = _subset(example_paths, tmp_path, k)
        out = str(tmp_path / f"out{k}.gaf")
        one = _run(Options(reads, example_paths[1], out_file=out, alignment_mode=4,
                           device="cpu"))[2]
        os.remove(out)
        two = _run(Options(reads, example_paths[1], out_file=out, alignment_mode=4,
                           device="cpu"), ["cpu", "cpu"])[2]
        assert two == one and len(one.splitlines()) == max(k - 1, 1)


def test_data_parallel_flags(example_paths, tmp_path, monkeypatch, capsys):
    # the split is the caller's to ask for: a CLI run never splits, also
    # with several GPUs visible, and takes recgraph_tpu's opt-out flag
    # and variable
    reads = _subset(example_paths, tmp_path, 3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    outs = []
    for flags, env in (([], None), (["--no-data-parallel"], None), ([], "RECGRAPH_NO_DP")):
        if env:
            monkeypatch.setenv(env, "1")
        cli.main(["-m", "1", reads, example_paths[1], "--device", "cpu", *flags])
        out, err = capsys.readouterr()
        assert "data-parallel" not in err
        outs.append(out)
    assert outs[0] == outs[1] == outs[2] and len(outs[0].splitlines()) == 3


def test_split_map():
    # contiguous slices, one device after another, results in read order
    seen = []

    def double(xs, d):
        seen.append((list(xs), d))
        return [x * 2 for x in xs]

    got = mesh.split_map(double, ["cpu", "cpu", "cpu"], list(range(7)))
    assert got == [x * 2 for x in range(7)]
    assert seen == [([0, 1, 2], "cpu"), ([3, 4], "cpu"), ([5, 6], "cpu")]
    seen.clear()
    assert mesh.split_map(double, ["cpu", "cpu", "cpu"], [1]) == [2]
    assert seen == [([1], "cpu")]
