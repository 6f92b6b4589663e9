"""Per-mode orchestration: parse once, align every read, emit GAF.

Counterpart of ``recgraph_tpu/align/pipeline.py`` (``Options`` and
``_bta`` :37-66, ``_poa_align`` :69-90, ``_emit_records``/``_emit_poa``
:115-174, ``run`` :202-225, the POA, pathwise and recombination branches
of ``_run_host`` :323-471, 472-508 and ``_run_poa_batched`` :534-585)
for modes 0-9.  Engines:

- ``engine="torch"``  the port's fills and walks on ``Options.device``
  (CUDA kernels on ``"cuda"``, their plain versions on ``"cpu"``);
- ``engine="oracle"`` the scalar spec, ``oracle.poa``,
  ``oracle.pathwise``, ``oracle.pathwise_gap`` and
  ``oracle.recombination``.

Reference behaviours kept at this layer: bta = b + f * len('$'+read)
with a saturating cast (main.rs:57); gap penalties o = -gap_open and
e = -gap_extension; the band warning for modes 0 and 2; amb-strand
retries (modes 0/2 on a negative score and modes 1/3 always, keeping
the reverse only when strictly better — except mode 1, which keeps the
*forward* record when its score is lower, a reference inversion,
main.rs:160-164); 1-based read numbers for the GAF writer in modes 0-3
and 0-based ones in modes 4/5 and 8/9 (main.rs:260,268), so that with
``-o`` the writer's truncate-at-number-1 rule drops read 0's line, as
the reference does.  Modes 4/5 and 8/9 have no amb-strand retry.

The run level (``run``/``_run``/``_run_host``, recgraph_tpu's
pipeline.py:202-379): ``RECGRAPH_PROFILE=<dir>`` (a torch.profiler
trace), ``RECGRAPH_RESUME=1`` (skip the reads already in ``-o``),
multi-process runs (``parallel.distributed``: part files merged by
process 0) and the data-parallel read split over devices the caller
names (``parallel.mesh``: the reads split at the engine call).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import _backend, native
from ..graph.pathgraph import PathGraph
from ..graph.poagraph import PoaGraph
from ..io import fasta, gfa
from ..io.gaf import GafWriter
from ..oracle import gaf_emit as oracle_gaf_emit
from ..oracle import pathwise as oracle_pathwise
from ..oracle import pathwise_gap as oracle_pathwise_gap
from ..oracle import poa as oracle_poa
from ..oracle import recombination as oracle_recombination
from ..metrics import phase, phase_summary, trace
from ..graph.pathgraph import nodes_displacement_matrix
from ..ops import pathwise_engine, pathwise_gap_engine, poa_engine, recombination_engine
from ..ops.poa_engine import WalkState
from ..parallel import distributed, mesh as pmesh
from ..scoring import ScoreMatrix

PORTED_MODES = tuple(range(10))
ENGINES = ("torch", "oracle")
_BAND_WARNING = "Band length probably too short, maybe try with larger b and f"
STDOUT = "standard output"
RESUMABLE_MODES = (0, 1, 2, 3, 4, 5, 8, 9)


@dataclass
class Options:
    sequence_path: str
    graph_path: str
    out_file: str = "standard output"
    alignment_mode: int = 0
    match_score: int = 2
    mismatch_score: int = 4          # CLI value; negated on use
    matrix: str = "none"
    gap_open: int = 4                # CLI value; negated on use
    gap_extension: int = 2           # CLI value; negated on use
    multi_rec_cost: float = 0.1
    base_rec_cost: int = 4
    rec_band_width: float = 1.0
    amb_strand: bool = False
    extra_b: int = 1
    extra_f: float = 0.01
    engine: str = "torch"
    device: str = "cuda"
    # scale-out: multi-process runs
    num_processes: int = 1
    process_id: int | None = None
    coordinator: str | None = None

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {self.engine!r}")
        if self.engine == "torch":
            _backend.resolve_device(self.device)


def _bta(opts: Options, seq: str) -> int:
    v = opts.extra_b + opts.extra_f * len(seq)
    return int(v) if v > 0 else 0  # Rust f32->usize saturating cast


class _RawGafLine:
    """A pre-rendered GAF line (native emitter output)."""

    __slots__ = ("line",)

    def __init__(self, line):
        self.line = line

    def to_string(self):
        return self.line


def _hofp_ids(g):
    ids = g.__dict__.get("_hofp_ids")
    if ids is None:
        ids = np.array([int(h) for h in g.handle_pos], dtype=np.int64)
        g.__dict__["_hofp_ids"] = ids
    return ids


def _emit_records(mode, states, sequences, names, amb_mode, g):
    """GAF emission for a batch of WalkStates: one native call for the
    whole batch (threaded inside the C++), per read for small batches
    and for any read the batch emitter rejects."""

    def one(i):
        return _emit_poa(mode, states[i], sequences[i], names[i], amb_mode, g)

    n = len(sequences)
    if n >= 32:
        stride = max(max((len(st.dirs) for st in states), default=0), 1)
        dirs2d = np.zeros((n, stride), dtype=np.int32)
        rows2d = np.zeros((n, stride), dtype=np.int32)
        params = np.empty((n, 6), dtype=np.int64)
        for i, st in enumerate(states):
            k = len(st.dirs)
            dirs2d[i, :k] = st.dirs
            rows2d[i, :k] = st.rows
            params[i] = (k, st.stop_row, st.query_start, st.last_row,
                         st.last_col_abs, len(sequences[i]))
        tails = native.gaf_emit_poa_walk_batch(
            dirs2d, rows2d, params, _hofp_ids(g), amb_mode
        )
        return [
            _RawGafLine(f"{names[i]}\t{t}") if t is not None else one(i)
            for i, t in enumerate(tails)
        ]
    return [one(i) for i in range(n)]


def _emit_poa(mode, st, seq, name, amb_mode, g):
    """One GAF record: the native walk emitter for a WalkState, the
    oracle's emitters for an oracle PoaState."""
    if isinstance(st, WalkState):
        tail = native.gaf_emit_poa_walk(
            st.dirs, st.rows, st.stop_row, st.query_start, st.last_row,
            st.last_col_abs, _hofp_ids(g), len(seq), amb_mode,
        )
        if tail is None:
            raise RuntimeError(f"native walk emitter rejected read {name!r}")
        return _RawGafLine(f"{name}\t{tail}")
    emit = (
        oracle_gaf_emit.gaf_of_global_abpoa,
        oracle_gaf_emit.gaf_of_local_poa,
        oracle_gaf_emit.gaf_of_gap_abpoa,
        oracle_gaf_emit.gaf_of_gap_local_poa,
    )[mode]
    return emit(st, seq, name, amb_mode, g.handle_pos)


def run(opts: Options, devices=None) -> None:
    """Top-level orchestration (reference main.rs:25-329), modes 0-9.

    ``devices``: the devices to split the reads over (``parallel.mesh.
    split_map``; byte-equal output, not a speed-up); None runs on
    ``Options.device`` alone.

    RECGRAPH_METRICS=1 prints reads/s, cells/s, the phase breakdown and
    a ``recgraph-timing`` line to stderr; RECGRAPH_PROFILE=<dir> wraps
    the run in a torch.profiler trace (``metrics.trace``).  Diagnostics
    go to stderr so the GAF stream on stdout stays clean.
    """
    if opts.alignment_mode not in PORTED_MODES:
        raise ValueError(f"mode {opts.alignment_mode}: modes are 0..9")
    profile_dir = os.environ.get("RECGRAPH_PROFILE")
    if not profile_dir:
        _run(opts, devices)
        return
    cuda = opts.engine == "torch" and any(
        torch.device(d).type == "cuda" for d in devices or [opts.device])
    with trace(profile_dir, cuda):
        _run(opts, devices)


def _data_parallel(opts: Options, devices):
    """The devices the engines split the reads over (one: no split)."""
    if devices is None:
        return [opts.device]
    devices = [_backend.resolve_device(d) for d in devices]
    if len(devices) > 1:
        print(f"data-parallel: sharding reads over {len(devices)} local devices",
              file=sys.stderr)
    return devices


def _run(opts: Options, devices) -> None:
    t0 = time.time()
    if opts.num_processes > 1 and opts.out_file == STDOUT:
        # fail fast: joining blocks until every process has joined, so a
        # doomed run must stop before it joins
        raise SystemExit("multi-process runs require -o <file>")
    pid, nproc = distributed.initialize(opts.coordinator, opts.num_processes,
                                        opts.process_id)
    try:
        devices = _data_parallel(opts, devices)
        t_setup = time.time() - t0
        _run_host(opts, pid, nproc, t0, devices)
        t_align = time.time() - t0 - t_setup
        t_gather = 0.0
        if nproc > 1:
            # the result gather, the only data that crosses processes:
            # a barrier, then process 0 concatenates the parts
            tg0 = time.time()
            distributed.barrier()
            if pid == 0:
                distributed.merge_host_outputs(opts.out_file, nproc)
            t_gather = time.time() - tg0
    finally:
        if nproc > 1:
            distributed.shutdown()
    if os.environ.get("RECGRAPH_METRICS"):
        # setup = joining the group and choosing devices; align = this
        # process's reads; gather = the end barrier and the merge (the
        # barrier charges the processes' skew to the earlier one)
        print(f"recgraph-timing: pid={pid}/{nproc} setup={t_setup:.3f} "
              f"align={t_align:.3f} gather={t_gather:.3f}", file=sys.stderr)


def _run_host(opts: Options, pid: int, nproc: int, t0: float, devices) -> None:
    """This process's reads (all of them in a one-process run): the
    multi-process part file, resume, then the mode's engine."""
    with phase("parse"):
        sequences, names = fasta.get_sequences(opts.sequence_path)
    host_offset = 0
    if nproc > 1:
        sl = distributed.host_read_slice(len(sequences), pid, nproc)
        host_offset = sl.start
        sequences, names = sequences[sl], names[sl]
        opts = dataclasses.replace(opts, out_file=f"{opts.out_file}.part{pid}")
        # the writer's truncate-at-number-1 rule never fires for a part
        # whose first read is past read 0, so stale parts are removed
        # here, unless resuming into them
        if not os.environ.get("RECGRAPH_RESUME") and os.path.exists(opts.out_file):
            os.remove(opts.out_file)
        if not sequences:
            open(opts.out_file, "w").close()
            return

    # resume: with RECGRAPH_RESUME=1 and an -o file, skip as many reads
    # as the file has non-blank lines and append
    resume_skip = 0
    if (os.environ.get("RECGRAPH_RESUME") and opts.out_file != STDOUT
            and os.path.exists(opts.out_file) and opts.alignment_mode in RESUMABLE_MODES):
        with open(opts.out_file) as fh:
            resume_skip = sum(1 for ln in fh if ln.strip())
        resume_skip = min(resume_skip, len(sequences))
        if resume_skip:
            print(f"resuming at read {resume_skip}/{len(sequences)}", file=sys.stderr)
            sequences, names = sequences[resume_skip:], names[resume_skip:]
            if not sequences:
                print("Done in 0.", file=sys.stderr)
                return
    with phase("parse"):
        parsed = gfa.parse_gfa(opts.graph_path)
    sm = ScoreMatrix.create(opts.matrix, opts.match_score, -opts.mismatch_score)
    writer = GafWriter(opts.out_file, number_offset=resume_skip + host_offset)
    mode = opts.alignment_mode
    if not sequences:
        # zero reads: no line in any mode, as the reference's loop over the
        # reads writes none; recgraph_tpu raises in modes 4-9
        # (ops/pathwise_engine.py:223 _align_lp), which the port does not copy
        pass
    elif mode in (4, 5):
        _run_pathwise(opts, mode, sequences, names, PathGraph.from_gfa(parsed), sm, writer,
                      devices)
    elif mode in (6, 7):
        # the lines go to stdout (main.rs:277); a multi-process run writes
        # them to its part file so that process 0's merge sees them
        sink = open(opts.out_file, "w") if nproc > 1 else contextlib.nullcontext(sys.stdout)
        with sink as fh:
            _run_pathwise_gap(opts, mode, sequences, PathGraph.from_gfa(parsed, is_reversed=False),
                              sm, fh, host_offset, devices)
    elif mode in (8, 9):
        _run_recombination(opts, mode, sequences, names, PathGraph.from_gfa(parsed), sm, writer,
                           devices)
    else:
        g = PoaGraph.from_gfa(parsed, amb_mode=False)
        g_rev = None

        def rev_graph():
            nonlocal g_rev
            if g_rev is None:
                g_rev = PoaGraph.from_gfa(parsed, amb_mode=True)
            return g_rev

        if opts.engine == "torch":
            _run_poa_batched(opts, mode, sequences, names, g, sm, writer, rev_graph, devices)
        else:
            _run_poa_oracle(opts, mode, sequences, names, g, sm, writer, rev_graph)

    print(f"Done in {int(time.time() - t0)}.", file=sys.stderr)
    if os.environ.get("RECGRAPH_METRICS"):
        dt = max(time.time() - t0, 1e-9)
        n_rows = len(parsed.segments) + sum(len(s) for s in parsed.segments.values())
        cells = sum(len(s) for s in sequences) * n_rows
        print(
            f"metrics: device={opts.device} reads={len(sequences)} "
            f"reads/s={len(sequences) / dt:.1f} cells/s={cells / dt:.3e} "
            f"wall_s={dt:.3f}",
            file=sys.stderr,
        )
        ps = phase_summary()
        if ps:
            print(ps, file=sys.stderr)


def _retry(mode, score):
    """Whether a read is aligned again on the reverse strand
    (main.rs:82-101,160-164,188-209,245-249)."""
    return mode in (1, 3) or score < 0


def _keep_reverse(mode, fwd_score, rev_score):
    """Whether the reverse-strand record replaces the forward one; mode 1
    keeps the reference's inversion (main.rs:160-164)."""
    if mode == 1:
        return not fwd_score < rev_score
    return rev_score > fwd_score


def _run_poa_oracle(opts, mode, sequences, names, g, sm, writer, rev_graph):
    """Per-read scalar oracle (the spec; slow)."""
    o, e = -opts.gap_open, -opts.gap_extension

    def align(seq, graph):
        if mode == 0:
            st = oracle_poa.global_banded(seq, graph, sm, _bta(opts, seq))
        elif mode == 1:
            st = oracle_poa.local_full(seq, graph, sm)
        elif mode == 2:
            st = oracle_poa.gap_global_banded(seq, graph, sm, o, e, _bta(opts, seq))
        else:
            st = oracle_poa.gap_local_full(seq, graph, sm, o, e)
        if mode in (0, 2) and not st.band_check_ok:
            print(_BAND_WARNING, file=sys.stderr)
        return st

    for i, seq in enumerate(sequences):
        st = align(seq, g)
        record = _emit_poa(mode, st, seq, names[i], False, g)
        if opts.amb_strand and _retry(mode, st.score):
            rg = rev_graph()
            rseq = fasta.rev_and_compl(seq)
            st_r = align(rseq, rg)
            if _keep_reverse(mode, st.score, st_r.score):
                record = _emit_poa(mode, st_r, rseq, names[i], True, rg)
        writer.write(record.to_string(), i + 1)


def _run_poa_batched(opts, mode, sequences, names, g, sm, writer, rev_graph, devices):
    """Batched device path: fill + walk on the device, native emission.

    Ambiguous-strand retries run as one reverse-graph batch over just
    the reads that need it.
    """
    o, e = -opts.gap_open, -opts.gap_extension
    btas = [_bta(opts, s) for s in sequences]

    def walks(graph, seqs, bt):
        return pmesh.split_map(
            lambda s, b, d: poa_engine.run_batch_walks(mode, s, graph, sm, o, e, b, d),
            devices, seqs, bt)

    states = walks(g, sequences, btas)
    for st in states if mode in (0, 2) else ():
        if not st.band_check_ok:
            print(_BAND_WARNING, file=sys.stderr)
    with phase("emit"):
        records = _emit_records(mode, states, sequences, names, False, g)

    if opts.amb_strand:
        retry = [i for i in range(len(sequences)) if _retry(mode, states[i].score)]
        if retry:
            rg = rev_graph()
            rseqs = [fasta.rev_and_compl(sequences[i]) for i in retry]
            rbtas = [btas[i] for i in retry]
            rstates = walks(rg, rseqs, rbtas)
            with phase("emit"):
                for k, i in enumerate(retry):
                    if _keep_reverse(mode, states[i].score, rstates[k].score):
                        records[i] = _emit_poa(mode, rstates[k], rseqs[k], names[i], True, rg)

    with phase("write"):
        for i, rec in enumerate(records):
            writer.write(rec.to_string(), i + 1)


def _run_pathwise(opts, mode, sequences, names, g, sm, writer, devices):
    """Modes 4/5 (the pathwise branch of recgraph_tpu's _run_host,
    pipeline.py:413-430): the torch engine's fills and walks, or the
    scalar oracle per read; 0-based read numbers."""
    if opts.engine == "torch":
        records = pmesh.split_map(
            lambda s, d: pathwise_engine.run_batch_walks(mode, s, g, sm, d), devices, sequences)
    else:
        exec_ = oracle_pathwise.exec_global if mode == 4 else oracle_pathwise.exec_semiglobal
        records = [exec_(s, g, sm) for s in sequences]
    with phase("write"):
        for i, rec in enumerate(records):
            rec.query_name = names[i]
            writer.write(rec.to_string(), i)


def _run_recombination(opts, mode, sequences, names, g, sm, writer, devices):
    """Modes 8/9 (the recombination branch of recgraph_tpu's _run_host,
    pipeline.py:472-508): the torch engine's fills, split search and
    walks, or the scalar oracle per read, which alone needs the dense
    displacement matrix; 0-based read numbers."""
    rg = g.reverse()
    args = (sm, opts.base_rec_cost, opts.multi_rec_cost)
    if opts.engine == "torch":
        records = pmesh.split_map(
            lambda s, d: recombination_engine.run_batch_walks(
                mode, s, g, rg, *args, opts.rec_band_width, d), devices, sequences)
    else:
        dms = nodes_displacement_matrix(g, rg)
        records = [oracle_recombination.exec_mode(mode, s, g, rg, *args, dms,
                                                  opts.rec_band_width)
                   for s in sequences]
    with phase("write"):
        for i, rec in enumerate(records):
            rec.query_name = names[i]
            writer.write(rec.to_string(), i)


def _run_pathwise_gap(opts, mode, sequences, g, sm, fh, host_offset, devices):
    """Modes 6/7 (the branch of recgraph_tpu's _run_host,
    pipeline.py:431-471): the torch engine's fills and walks, or the
    scalar oracle per read.  Graphs the reference itself rejects (a
    predecessor block sharing no path with its node) go to the oracle,
    which raises the same way; nothing else does.  The lines go to
    ``fh`` (stdout whatever ``-o`` says, main.rs:277; a multi-process
    run's part file), read numbers 0-based from ``host_offset``."""
    o, e = -opts.gap_open, -opts.gap_extension
    results = None
    if opts.engine == "torch":
        try:
            results = pmesh.split_map(
                lambda s, d: pathwise_gap_engine.run_batch(mode, s, g, sm, o, e, d),
                devices, sequences)
        except pathwise_gap_engine.RejectedGraph as exc:
            print(f"mode {mode}: device path unavailable ({exc}); using oracle", file=sys.stderr)
    exec_ = (oracle_pathwise_gap.exec_gap_global if mode == 6
             else oracle_pathwise_gap.exec_gap_semiglobal)
    lines = []
    for i, seq in enumerate(sequences):
        best_path, cigar = results[i] if results is not None else exec_(seq, g, sm, o, e)
        lines.append(f"{cigar}\nBest path sequence {i + host_offset}: {best_path}\n")
    with phase("write"):
        fh.write("".join(lines))
