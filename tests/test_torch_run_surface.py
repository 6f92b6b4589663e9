"""The port's run-level surface on the CPU against recgraph_tpu: the GAF
writer's number offset, records read back from their lines,
RECGRAPH_RESUME=1, RECGRAPH_PROFILE=<dir> and the read split over
processes.  The comparisons are byte equality of GAF output."""

import contextlib
import io
import json
import os

import pytest
import torch

from recgraph_tpu.align import pipeline as jax_pipeline
from recgraph_tpu.io import fasta as jax_fasta
from recgraph_tpu.io import gaf as jax_gaf
from recgraph_tpu.parallel import distributed as jax_distributed
from recgraph_tpu_torch import metrics
from recgraph_tpu_torch.align.pipeline import Options, run
from recgraph_tpu_torch.io.gaf import GafRecord, GafWriter
from recgraph_tpu_torch.parallel import distributed

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.gaf")) as fh:
        return fh.read()


def _subset(example_paths, tmp_path, k):
    seqs, names = jax_fasta.get_sequences(example_paths[0])
    path = tmp_path / f"reads{k}.fa"
    path.write_text("".join(f">{n}\n{s[1:]}\n" for n, s in zip(names[:k], seqs[:k])))
    return str(path)


def _quiet(fn, *a, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        fn(*a, **kw)
    return out.getvalue(), err.getvalue()


@pytest.mark.parametrize("offset, numbers", [(5, [0, 1, 2, 3]), (0, [0, 1, 2, 3]),
                                             (1, [0, 1, 2])],
                         ids=["appends", "truncates-at-1", "offset-truncates"])
def test_gaf_writer_offset_matches_jax(tmp_path, offset, numbers):
    lines = [f"read{k}\t{k}" for k in numbers]
    files = []
    for name, writer_cls in (("jax", jax_gaf.GafWriter), ("port", GafWriter)):
        path = tmp_path / f"{name}.gaf"
        path.write_text("earlier\n")
        w = writer_cls(str(path), number_offset=offset)
        stdout, _ = _quiet(lambda: [w.write(ln, k) for ln, k in zip(lines, numbers)])
        files.append(path.read_text())
        # stdout takes every line whatever the offset
        out, _ = _quiet(lambda: [writer_cls(number_offset=offset).write(ln, k)
                                 for ln, k in zip(lines, numbers)])
        assert stdout == "" and out == "".join(ln + "\n" for ln in lines)
    assert files[0] == files[1]
    truncated = offset + numbers[0] <= 1 <= offset + numbers[-1]
    assert files[1].startswith("earlier") != truncated


def test_gaf_record_from_string_round_trips():
    for name in ("mode0", "mode3", "mode4", "mode8"):
        for line in _golden(name).splitlines():
            rec = GafRecord.from_string(line)
            assert rec.to_string() == line
            assert isinstance(rec.query_length, int) and all(isinstance(h, int)
                                                             for h in rec.path)
    for rec in (GafRecord(), GafRecord(query_name="a", path=[], comments="x\ty")):
        assert GafRecord.from_string(rec.to_string()) == rec
    with pytest.raises(ValueError, match="not a GAF line"):
        GafRecord.from_string("name\t1\t2")


@pytest.mark.parametrize("mode, n_reads, k", [(0, 52, 20), (4, 12, 5)])
def test_resume_matches_jax(example_paths, tmp_path, monkeypatch, mode, n_reads, k):
    reads = example_paths[0] if n_reads == 52 else _subset(example_paths, tmp_path, n_reads)
    graph = example_paths[1]
    full = tmp_path / "full.gaf"
    _quiet(run, Options(reads, graph, out_file=str(full), alignment_mode=mode, device="cpu"))
    partial = "".join(full.read_text().splitlines(keepends=True)[:k])
    jax_out, port_out = tmp_path / "jax.gaf", tmp_path / "port.gaf"
    jax_out.write_text(partial)
    port_out.write_text(partial)
    monkeypatch.setenv("RECGRAPH_RESUME", "1")
    _quiet(jax_pipeline.run, jax_pipeline.Options(
        reads, graph, out_file=str(jax_out), alignment_mode=mode, engine="jax",
        no_data_parallel=True))
    _, err = _quiet(run, Options(reads, graph, out_file=str(port_out), alignment_mode=mode,
                                 device="cpu"))
    assert f"resuming at read {k}/{n_reads}" in err
    assert port_out.read_bytes() == jax_out.read_bytes()
    if mode == 0:
        assert port_out.read_text() == _golden("mode0") == full.read_text()
    else:
        # modes 4/5 and 8/9 with -o: the full file lacks read 0's line, so
        # skipping k reads writes read k's line a second time
        lines = full.read_text().splitlines()
        assert port_out.read_text().splitlines() == lines[:k] + lines[k - 1:]
    # a file that holds every read: nothing left to align, nothing written
    before = port_out.read_bytes()
    _, err = _quiet(run, Options(reads, graph, out_file=str(port_out), alignment_mode=mode,
                                 device="cpu"))
    assert port_out.read_bytes() == before and "Done in 0." in err


def test_profile_writes_trace(example_paths, tmp_path, monkeypatch):
    prof = tmp_path / "prof"
    monkeypatch.setenv("RECGRAPH_PROFILE", str(prof))
    metrics.reset_phases()
    out, _ = _quiet(run, Options(*example_paths, alignment_mode=1, device="cpu"))
    assert out == _golden("mode1")
    (trace,) = os.listdir(prof)
    assert os.path.join(str(prof), trace) == metrics.trace_path(str(prof))
    with open(prof / trace) as fh:
        events = json.load(fh)["traceEvents"]
    names = {ev.get("name") for ev in events}
    assert {"phase:fill", "phase:walk", "phase:write"} <= names
    assert not metrics._tracing and metrics.PHASES["fill"] > 0


def test_host_read_slice_matches_jax():
    for n in range(10):
        for nproc in range(1, 5):
            slices = [distributed.host_read_slice(n, pid, nproc) for pid in range(nproc)]
            assert slices == [jax_distributed.host_read_slice(n, pid, nproc)
                              for pid in range(nproc)]
            assert [i for s in slices for i in range(n)[s]] == list(range(n))
    # no process group: one process owns every read
    assert distributed.host_read_slice(7) == slice(0, 7)
