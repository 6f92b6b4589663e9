#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (recgraph_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. report   torch/CUDA versions, the card, nvidia-smi name and power limit;
2. build    compile and load the CUDA kernels (csrc/*.cu, sm_90a, one nvcc
            per source, all started together);
3. goldens  the port's pipeline on example/ for mode0, mode1, mode1_hoxd70,
            mode2, mode3, mode4, mode5, mode8, mode9 and mode8_R10_r2_B05
            (-R 10 -r 2 -B 0.5), byte-equal to tests/goldens/*.gaf, and
            the stdout of modes 6 and 7, byte-equal to
            tests/goldens/mode6_full.txt and mode7_full.txt; a reads
            file with no reads in modes 0, 4, 6 and 8 (one per mode
            family) writes no line, with and without -o;
3b. surface the run level on the card: the four align_* functions of
            the library API (default device) on 8 example reads, each
            call one launch of its mode's kernel (K1, K2, K4, K5) at
            one read, records equal to device="cpu" (a CPU worker);
            RECGRAPH_RESUME=1 in modes 0 and 4 on example/ from the
            first 20 lines of an -o run, equal to the CPU resume of the
            same file (mode 0 also to mode0.gaf); two CLI processes
            (--num-processes 2) sharing the card in modes 0 and 8,
            merged file equal to the one-process -o run (mode0.gaf;
            mode8.gaf without read 0's line), and their recgraph-timing
            lines; the data-parallel split (align.pipeline.run over
            cuda:0 twice) in modes 1 and 8 equal to the goldens; and
            RECGRAPH_PROFILE on stretch mode 0 (1,024 reads, one K1
            launch) and mode 6 (48 reads, one K11 launch) through the
            CLI in a process of their own, which prints no
            data-parallel line (a CLI run never splits): the trace's
            size, its top kernels, and the device's busy and idle
            shares (the union of kernel intervals over the window),
            failing if the trace has no kernel event;
4. stretch  the CLI on the 10,000-read stretch corpus
            (tools/make_synthetic.make(dir, 700, 10000, 42)) for -m 0..5:
            line count (modes 4/5 drop read 0's line with -o, as the
            reference does), mode 4's first lines byte-equal to
            tests/goldens/stretch_mode4_sample.gaf, a sample byte-equal to
            the port's CPU run on the same reads, reads/s, the phase
            breakdown and peak memory; then -m 8 and -m 9 on the same
            corpus (K7, K8 and S1's bound and guided entries; the split
            search's launches and pairs);
            then -m 6 and -m 7 (K11; the lines go to stdout whatever -o
            says, two a read; a sample of 8 reads byte-equal to the CPU
            run); then -m 4, -m 8 and -m 6 on 512 reads of the 128-path
            corpus make(dir, 700, 512, 42, n_paths=128), the shape at
            which the JAX package takes its path-tiled kernels (and the
            most paths its modes-6/7 kernel takes);
5. long     the CLI on 512 reads of the long corpus (the recipe of
            bench.py:78-110, written out below) for -m 0, -m 2 and -m 4:
            the windows the ladder ran (and, in mode 4, the reads rerun
            at full width), reads/s, phases, a sample byte-equal to the
            CPU run; then -m 1, -m 3 and -m 5 on 64 long reads at full
            width, -m 8 and -m 9 on 32 of them and -m 6 and -m 7 on 8
            (full width; read 0's two lines byte-equal to the scalar
            oracle's, exec_gap_global / exec_gap_semiglobal, on a CPU
            worker: the port's plain fill would take many minutes there);
            then -m 8 on the same 32 reads with RECGRAPH_REC_WINDOW=1 (the
            windowed pair: K10 forward, S2 reverse, from W 256): the rungs,
            the rescore refusals and full-width reruns
            (metrics.EVENTS["rec_win_rescore"], ["rec_win_fullwidth"]),
            how many lines differ from the full-width file (logged: the
            opt-in may emit a lower-scoring alignment), and 2 sampled reads
            byte-equal to the port's CPU run with the variable set, each
            read run alone as the card's ladder ran it; phase 6 checks
            each kernel of its ladder once a width, at the rung with the
            most reads, where no earlier run launched it at that width;
5b. split   RECGRAPH_SPLIT_FULL=1 (the full column scan in torch ops in
    full    place of S1): example/ in modes 8 and 9 byte-equal to
            tests/goldens/mode8.gaf and mode9.gaf, and the stretch corpus's
            first 348 reads (one mode-8 fill chunk) byte-equal to the same
            reads of phase 4's default run;
6. kernels  K1-K8, K10-K17, S1 and S2 against their plain torch versions on the card,
            all outputs exactly equal, at every launch shape of phases 4-5
            (reads, rows, Lp, stored width[, paths], as metrics.SHAPES
            recorded them; the leading reads of that corpus), with kernel
            and plain times (CUDA events) and the bound at each; then on
            the example corpus, three seeded random graphs, HOXD70 (K2,
            K5, K7, K8), (o, e) = (+1, -2) (K4, K5), K5 at the edges of
            its layout (1-bp reads, widths of 151, 168, 232 and 328, forced
            layouts, 40 predecessor slots, a 4,900-bp read) and with its
            clamped chain past (|o| + |e|) x Lp = 2^27 (-O 100000 -E 1 on
            two long reads; (-2^20, 0), also in the full form, and
            e = -2^22 on the example reads), K2 and K4 at the edges of
            the same layout (widths of 224 and 225 besides K5's) and K4
            with its clamped chain (o = -30000 on the example graph: one
            warp, two, the full form), K1 at K2's edges and with the
            several-warp and full forms forced beside HOXD70, K6 at W =
            8, at W = 256 and 512 on a two-arm bubble of 600-bp arms (its
            window jumps back by more than W), with forced layouts, with
            (o, e) = (+1, -2) and past its prefix-max chain's range
            (o = -30000, the clamped chain; also the full form), K10 on a read
            shorter than W, at W = 34 and with its scratch in device
            memory, K1 on 64 long reads at
            full width, K3/K6/K10 at W = 32, where reads overflow, K3 at
            W = 8, one warp of 3, 5 and 7 columns a lane (W = 96, 160,
            224) and at W = 256 and 512 on the bubble (3 warps forced,
            the full form), K7 in
            mode 5 and K8 in mode 9, on a 126-path graph and past the JAX
            engine's packed-chain gate, K8 on the fragment graphs whose
            reverse graphs have delta-leak rows (clone rows, ghost-alpha
            rows), K7 and K8 at the edges of their layout (one path; 7
            paths at 1, 2 and 4 blocks a read; 126 at 1; a read width of
            151; a 41,000-bp read, the device-scratch form), and S1
            (bitwise f32): its per-pair entry at the chunk shapes its
            guided entry ran at (256 pairs a launch) and with r = 0.1,
            with R = r = 0 (ties) and on columns with no valid pair; its
            guided entry against the plain search (_run_split_guided),
            all seven outputs bit for bit, in modes 8 and 9 at 1 block a
            read and at the wrapper's count, at every chunk shape and on
            the example graph (r = 0.1, R = r = 0, no valid pair, -R 10
            -r 2 -B 0.5), each time with the invariant (every column
            with ub + 0.5 >= the read's final threshold was evaluated)
            checked on the columns it evaluated; its bound entry against
            _column_ub at its launch shapes and on the example graph;
            S2 (Awr, wsr, Rr) at K10's cases (W 32 and 1,024 on 8 long
            reads, W 32 and 34 on the example graph, HOXD70 at W 64, W 32
            and 256 beside a read shorter than W, W 1,024 on the
            41,000-bp read: the device-scratch form) and at W 8 on the
            fragment graphs whose reverse graphs have delta-leak rows;
            K11 (all three
            planes, every cell) in modes 6 and 7 on the example graph, a
            1,100-bp read (two column tiles; mode 6), HOXD70 with o = -200 (past
            the TPU kernel's packed-chain gate), 130 paths (past its
            P <= 128 gate), 33 paths (K12's chain warp and the lanes that
            follow it), a node with 40 predecessors (K12's form past 32
            hub lanes; K12 too) and (o, e) = (-3, -1); K11 is compared on the
            card at its most launched shape, and at its other short-read
            shapes on the leading 8 reads against the plain fill on a CPU
            worker (each read is its own block); at the long reads'
            launch shapes (four column tiles) read 0's planes in modes 6
            and 7 against the scalar oracle (fill_fast) on a CPU worker;
            K12 through its own wrapper on the staged inputs of
            two hard rows of the graphs at K11's launch shapes and on
            the row of the node with 40 predecessors (timed without the
            wrapper's host-side layout, cuda_gap67_hardrow.prepare); the
            superseded TPU generations of the mode-0/1 fills, K13, K15,
            K16 and K17 at K2's launch shapes and K14 at K1's (their
            plain versions lay out the plain fill that K1's or K2's
            check ran on the same inputs), on the example, random and
            HOXD70 cases, K14 also at K1's edges (a width of 151, so
            Lp + 8 is not a multiple of 4; several warps and the full
            form forced), K13, K15, K16 and K17 at K2's edges, K15
            also at int16 on the example graph at widths 152, 151 and
            156 (16-, 2- and 4-byte stores; refused at int16 at n =
            2,249), and K16's walk (walk_local_scores) equal to
            walk_poa's over K2's planes at K2's most launched shape;
7. kernel   python -m recgraph_tpu_torch.kernel_ab at 3,047 reads over
   A/B      every ported variant (v1 v2 v3 v4 v5 plain g1 g2: K13-K17, K2,
            the plain fill, K14, K1), each held to its plain version;
            its launch counts are K13-K17's launches;
8. imports  no jax* and no recgraph_tpu* module was imported;
9. result   the nvidia-smi line, one JSON line with every kernel (times
            and bound at the shape it was launched at most often; K9a and
            K9b, the TPU's path-tiled variants of K7 and K8, are their
            kernels at the 128-path shapes; K12's program runs inside
            K11, so its launches are K11's, and S1's per-pair entry's
            device function runs inside its guided entry, so its launches
            are the guided entry's), and the last line {"ok":
            true, "device": {...}}.

In phase 6, the exactness cases of a kernel that differ only in a knob
of the kernel (a forced layout, the blocks a read) share one plain
result.  The exactness cases of K3-K7, K10, K11 and S2 (beside their
main-path shapes, which stay on the card) are held to the plain version
run on a CPU worker:
the digests of every output, dtypes and shapes included, must be
equal.

From phase 3b on, the CPU runs that the card's output is held against
(the API records, the resumed files, the samples, the exactness cases
of K3-K7, K10 and K11, K11's CPU checks and the scalar oracle on a long read) and the
reading of the profiled runs' traces are queued for six single-thread
worker processes, which start after the last timed CLI run and work
beside phase 6; phase 6 ends by collecting them.

Every launch counter is set to 0 just before each CLI run of phases 4-5
and read just after; the run fails if a kernel of its path was not
launched (for modes 6/7 also unless K11 counted hard rows whose K12
column program it ran: ``metrics.EVENTS["gap67_hard_rows"]``).  The
tolerance of every comparison is exact equality: all outputs are int32
DP values, indices and GAF bytes, and S1's f32 column maxima, which the
kernel rounds as its plain version does.  Needs CUDA, nvcc (sm_90a) and
a C++ compiler; exits nonzero without CUDA.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import os
import random
import sys
import time
from collections import Counter

ROOT = os.path.dirname(os.path.abspath(__file__))
STRETCH = dict(n_back=700, n_reads=10000, seed=42)
MANY_PATHS = dict(n_back=700, n_reads=512, seed=42, n_paths=128, sample_step=97,
                  rec_sample_step=256)
LONG = dict(n_back=1200, seed=11, n_reads=512, full_width_reads=64, sample_step=128,
            pathwise_sample_step=128, mode5_sample_step=32, rec_reads=32, rec_sample_step=32,
            gap_reads=8)
GOLDENS = {
    "mode0": dict(alignment_mode=0),
    "mode1": dict(alignment_mode=1),
    "mode1_hoxd70": dict(alignment_mode=1, matrix="HOXD70"),
    "mode2": dict(alignment_mode=2),
    "mode3": dict(alignment_mode=3),
    "mode4": dict(alignment_mode=4),
    "mode5": dict(alignment_mode=5),
    "mode8": dict(alignment_mode=8),
    "mode9": dict(alignment_mode=9),
    "mode8_R10_r2_B05": dict(alignment_mode=8, base_rec_cost=10, multi_rec_cost=2.0,
                             rec_band_width=0.5),
    "mode6_full": dict(alignment_mode=6),
    "mode7_full": dict(alignment_mode=7),
}
# modes 6/7: reads of each corpus checked against the CPU run (the plain
# fill runs its hard rows' columns one by one: seconds a read)
GAP_SAMPLE = dict(stretch=8, many=2)
# stretch sample checked against the CPU run: the first HEAD reads and
# every STEP-th after them (fewer for the slower affine-gap, pathwise and
# recombination CPU fills; modes 0-3 cut from 253 and 64 reads to keep
# the whole script inside its time limit)
SAMPLE = {0: (32, 313), 1: (32, 313), 2: (16, 625), 3: (16, 625), 4: (32, 313),
          5: (32, 313), 8: (8, 1249), 9: (8, 1249)}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
INT32_OPS_PER_S = 33.5e12   # H100 SXM int32 issue rate (half the 67 TFLOP/s fp32 rate)
O, E = -4, -2               # the CLI's default gap penalties
AB_BATCH = 3047             # kernel A/B reads: K1's and K2's most launched stretch chunk


def log(*a):
    print(*a, flush=True)


def compare(name, got, ref):
    """Exact equality of every output; returns the max abs difference
    (0, or it raises)."""
    import torch

    if len(got) != len(ref):
        raise AssertionError(f"{name}: {len(got)} outputs != {len(ref)}")
    for k, (a, b) in enumerate(zip(got, ref)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: output {k} {a.shape}/{a.dtype} != "
                                 f"{b.shape}/{b.dtype}")
        if not torch.equal(a, b):
            err = int((a.long() - b.long()).abs().max().item())
            raise AssertionError(f"{name}: output {k} differs (max abs err {err})")
    return 0


def cuda_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    import torch

    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def make_synth(workdir, name, n_back, n_reads, seed, n_paths=8, **_):
    """A tools/make_synthetic corpus: (reads.fa, graph.gfa)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import make_synthetic

    d = os.path.join(workdir, name)
    reads = os.path.join(d, "reads.fa")
    if not os.path.exists(reads):
        with contextlib.redirect_stdout(io.StringIO()):
            make_synthetic.make(d, n_back, n_reads, seed, n_paths)
    return reads, os.path.join(d, "graph.gfa")


def make_long(workdir):
    """The long-read corpus of bench.py:78-110: full-haplotype reads
    (~2.4 kb, 2 % substitutions from random.Random(11)) on the
    make(d, n_back=1200, n_reads=1, seed=11) graph."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import make_synthetic

    d = os.path.join(workdir, "long")
    gfa_path = os.path.join(d, "graph.gfa")
    with contextlib.redirect_stdout(io.StringIO()):
        make_synthetic.make(d, n_back=LONG["n_back"], n_reads=1, seed=LONG["seed"])
    rng = random.Random(LONG["seed"])
    walks, segs = {}, {}
    with open(gfa_path) as fh:
        for ln in fh:
            f = ln.rstrip("\n").split("\t")
            if f[0] == "P":
                walks[f[1]] = [int(x[:-1]) for x in f[2].split(",")]
            elif f[0] == "S":
                segs[int(f[1])] = f[2]
    keys = sorted(walks)
    reads_fa = os.path.join(d, "reads.fa")
    with open(reads_fa, "w") as fh:
        for k in range(LONG["n_reads"]):
            s = "".join(segs[x] for x in walks[rng.choice(keys)])
            s = "".join(rng.choice("ACGT") if rng.random() < 0.02 else c for c in s)
            fh.write(f">long{k}\n{s}\n")
    return reads_fa, gfa_path


def read_set(path, limit=None):
    from recgraph_tpu_torch.io import fasta

    seqs, names = fasta.get_sequences(path)
    return seqs[:limit], names[:limit]


def write_fasta(path, seqs, names):
    with open(path, "w") as fh:
        for s, nm in zip(seqs, names):
            fh.write(f">{nm}\n{s[1:]}\n")


def load_corpus(reads_fa, graph_gfa, limit=None, graph=None):
    """(PoaGraph, or ``graph``'s class, and '$'-prefixed reads) of a corpus."""
    from recgraph_tpu_torch.graph.poagraph import PoaGraph
    from recgraph_tpu_torch.io import gfa

    cls = graph or PoaGraph
    g = cls.from_gfa(gfa.parse_gfa(graph_gfa))
    g.__dict__["_smoke_gfa"] = graph_gfa   # for the CPU workers' jobs
    return g, read_set(reads_fa, limit)[0]


def kernel_cases(example, long, workdir):
    """Graphs and reads of the exactness cases beside the main path's
    shapes, keyed by (graph kind, name): POA graphs of the example
    corpus, 64 long reads and three random graphs; path graphs of the
    example corpus (23 paths, up to 9 groups a row), a 126-path graph,
    8 long reads, the same three random graphs and the fragment graphs
    whose reverse graphs have delta-leak rows (``fuzz.LEAK_SEEDS``); for
    K11 also a 60-node stretch graph with a 1,100-bp read (two column
    tiles), a 130-path and a 33-path graph, and a node with 40
    predecessors, each on a path of its own (``fuzz.fan_gfa``); for K7
    and K8 also random graphs of 1 and 7 paths and one 41,000-bp read on
    the 40-predecessor graph; for K5 1-bp reads on the example graph, the
    40-predecessor graph as a POA graph and a 4,900-bp read (two long
    reads joined) beside a long read; for K10 the 8 long reads and a
    21-bp one."""
    from recgraph_tpu_torch import fuzz
    from recgraph_tpu_torch.graph.pathgraph import PathGraph
    from recgraph_tpu_torch.graph.poagraph import PoaGraph

    p126 = make_synth(workdir, "p126", n_back=80, n_reads=8, seed=7, n_paths=126)
    tile = make_synth(workdir, "tile", n_back=60, n_reads=2, seed=7, n_paths=6)
    p130 = make_synth(workdir, "p130", n_back=30, n_reads=4, seed=3, n_paths=130)
    p33 = make_synth(workdir, "p33", n_back=80, n_reads=2, seed=7, n_paths=33)
    fan, fan_rng = fuzz.fan_gfa(40), random.Random(40)
    long41 = "$" + "".join(random.Random(5).choice("ACGT") for _ in range(41000))
    tile_g, tile_reads = load_corpus(*tile, graph=PathGraph)
    tile_reads.append("$" + "".join(random.Random(5).choice("ACGT") for _ in range(1100)))
    cases = {("poa", "example"): load_corpus(*example),
             ("poa", "long64"): load_corpus(*long, LONG["full_width_reads"]),
             ("path", "example"): load_corpus(*example, 16, graph=PathGraph),
             ("path", "p126"): load_corpus(*p126, graph=PathGraph),
             ("path", "long8"): load_corpus(*long, 8, graph=PathGraph),
             ("path", "tile"): (tile_g, tile_reads),
             ("path", "p130"): load_corpus(*p130, graph=PathGraph),
             ("path", "p33"): load_corpus(*p33, graph=PathGraph),
             ("path", "fan40"): (PathGraph.from_gfa(fan),
                                 [fuzz.random_read(fan_rng, fan) for _ in range(4)]),
             ("path", "long41"): (PathGraph.from_gfa(fan), [long41])}
    # K5: 1-bp reads, a start row of 40 predecessor slots, and a 4,900-bp
    # read (the full form in two windows) beside a 2,440-bp one
    l2 = load_corpus(*long, 2)[1]
    cases[("poa", "bp1")] = (cases[("poa", "example")][0], ["$A", "$C", "$G", "$T", "$N"])
    cases[("poa", "fan40")] = (PoaGraph.from_gfa(fan), cases[("path", "fan40")][1])
    cases[("poa", "long5k")] = (cases[("poa", "long64")][0], [l2[0] + l2[1][1:], l2[1]])
    cases[("poa", "long2")] = (cases[("poa", "long64")][0], l2)   # K5's clamped chain
    # K6: a two-arm bubble of 600-bp arms, whose window jumps back by more than W
    bubble, bub_rng = fuzz.bubble_gfa(600, 40, seed=3), random.Random(5)
    cases[("poa", "bubble")] = (PoaGraph.from_gfa(bubble),
                                [fuzz.random_read(bub_rng, bubble) for _ in range(3)])
    # K10: a read shorter than the window beside the long reads
    cases[("path", "long8s")] = (cases[("path", "long8")][0],
                                 cases[("path", "long8")][1] + ["$" + "ACGT" * 5])
    for name, seed, paths in (("p1", 61, 1), ("p7", 67, 7)):
        rng = random.Random(seed)
        gf = fuzz.random_gfa(rng, n_nodes=20 + 10 * (paths > 1), n_paths=paths, cover_all=True)
        reads = [fuzz.random_read(rng, gf) for _ in range(6)] + ["$" + "ACGT" * 70]
        cases[("path", name)] = (PathGraph.from_gfa(gf), reads)
    for seed in (101, 202, 303):
        rng = random.Random(seed)
        gf = fuzz.random_gfa(rng, n_nodes=24, n_paths=4, cover_all=True)
        reads = [fuzz.random_read(rng, gf) for _ in range(8)]
        cases[("poa", f"random{seed}")] = (PoaGraph.from_gfa(gf), reads)
        cases[("path", f"random{seed}")] = (PathGraph.from_gfa(gf), reads)
    for seed in fuzz.LEAK_SEEDS:
        gf = fuzz.fragment_gfa(seed)
        reads = fuzz.fragment_reads(random.Random(seed * 31 + 5), gf, k=4)
        cases[("path", f"leak{seed}")] = (PathGraph.from_gfa(gf), reads)
    return cases


def case(name, matrix="none", W=None, oe=(O, E), semi=False, pad_to=None, rec=(4, 0.1),
         dead=False, plain=True, dtype="int32", extra=False, cluster=None, width=None,
         layout=None):
    """One exactness case: the named graph and reads, the scoring table,
    the window width (S1: the pairs; K12: -1 for the hard row with the
    most blocks), the affine penalties, mode 5, 7 or 9 (``semi``), the
    padded read width, for S1 the recombination costs (R, r) and
    whether no pair is valid (``dead``), where the reference runs: the
    plain version on the card (True), the plain fill on a CPU worker for
    the leading reads ("cpu"), or the scalar oracle on a CPU worker for
    read 0 ("oracle"), K15's element type, whether the spec's
    ``extra`` check runs (the most launched main-path shape), for K7/K8
    the blocks a read (else the wrapper's choice), a read width to cut
    the encoded reads to (one not a multiple of 4), and for K5 a launch
    layout to force (``cuda_poa_gap_local.Plan``)."""
    return dict(name=name, matrix=matrix, W=W, oe=oe, semi=semi, pad_to=pad_to, rec=rec,
                dead=dead, plain=plain, dtype=dtype, extra=extra, cluster=cluster, width=width,
                layout=layout)


# K1's and K2's plain fills on each input, shared with the plain versions
# of K13-K17, which lay out the same fill: (fill, inputs' digest) ->
# (outputs, ms).  Cleared after the last kernel that uses it.
_plain_cache: dict = {}


def shared_plain(fill, nargs, layout):
    """The plain version of a kernel of the mode-0/1 family: ``fill`` (the
    plain fill, on the kernel's first ``nargs`` arguments, run once per
    input and cached) then ``layout`` (with the rest).  Returns a
    function of the kernel's arguments that gives (outputs, ms of the
    fill plus the layout)."""
    import torch

    def plain(*args):
        h = hashlib.sha256()
        for a in args[1:nargs]:
            h.update(a.cpu().numpy().tobytes())
        key = (fill.__name__, id(args[0]), h.hexdigest())
        if key not in _plain_cache:
            t0 = time.perf_counter()
            out = fill(*args[:nargs])
            torch.cuda.synchronize()
            _plain_cache[key] = (out, (time.perf_counter() - t0) * 1e3)
        out, fill_ms = _plain_cache[key]
        t0 = time.perf_counter()
        ref = layout(out, *args[nargs:])
        torch.cuda.synchronize()
        return ref, fill_ms + (time.perf_counter() - t0) * 1e3

    return plain


def corpus_kind(spec):
    """The kind of graph a kernel's corpora and cases are keyed by."""
    return "poa" if spec["graph"] == "poa" else "path"


def guided_kern(inputs, geom_t, ub, active, init, R, r, host, cluster=None):
    """S1's guided entry on a chunk (``cluster``: blocks a read)."""
    from recgraph_tpu_torch.ops import cuda_split_summary

    return cuda_split_summary.split_guided_cuda(inputs, geom_t, ub, active, init, R, r,
                                                blocks=cluster)


def guided_plain(inputs, geom_t, ub, active, init, R, r, host):
    """The plain search on the same inputs, its seven outputs as the
    guided entry's int32[7, B] rows (best as f32 bits)."""
    import numpy as np
    import torch

    from recgraph_tpu_torch.ops import recombination_engine as rec

    best, taken, fen, rsn, fp, rp, col = rec._run_split_guided(
        inputs, host.geom, geom_t, host.active, host.init, R, r,
        round_pairs=rec.ROUND_PAIRS["cuda"])
    rows = np.stack([best.view(np.int32), taken.astype(np.int32), fen, rsn, fp, rp, col])
    return torch.from_numpy(rows).to(inputs[0].device)


def guided_note(x, got):
    """The guided entry again with its per-read state: the same outputs,
    and the invariant (every column with ub + 0.5 >= the read's final
    threshold was evaluated); keeps the evaluated columns for the bound."""
    from recgraph_tpu_torch.ops import cuda_split_summary, recombination_engine as rec

    out, st = cuda_split_summary.split_guided_cuda(*x.gargs[:7], blocks=x.cluster,
                                                   with_state=True)
    compare("S1g with its state", (out,), got)
    bad = rec.split_unevaluated(st["ub"].cpu().numpy(), st["done"].cpu().numpy(),
                                st["col_max"].cpu().numpy(), x.gargs[7].init)
    if bad.any():
        raise AssertionError(f"S1g: {int(bad.sum())} needed columns were not evaluated")
    x.state = st
    B, I, _ = x.inputs[0].shape
    C = x.cluster or cuda_split_summary.launch_blocks(x.inputs[0].device, B, I)
    k = int(st["done"].sum())
    return (f" C={C} blocks a read, {k} pairs evaluated ({k / B:.1f} a read), "
            f"{int(out[1].sum())} reads split; invariant holds")


def kernel_specs():
    """Per kernel: wrapper module, plain version, the graph kind it runs
    on, its arguments built from one case (``x``: dg, table, seq, L, bta,
    W, o, e, semi), its exactness cases besides its main-path shapes, and
    the int32 operations per stored cell and per predecessor.  K7 is
    also checked in mode 5 at its most launched shape, and its 128-path
    shapes stand for K9a, the TPU's path-tiled variant.  K13-K17 are
    checked at K2's or K1's launch shapes (``shapes_of``), their plain
    versions laid out from the plain fill K1's or K2's check ran
    (``shared``); their launches are the kernel A/B phase's (``ab``)."""
    from types import SimpleNamespace

    import torch

    from recgraph_tpu_torch import fuzz, kernel_ab
    from recgraph_tpu_torch.ops import (
        cuda_gap67_fill, cuda_gap67_hardrow, cuda_pathwise, cuda_pathwise_rev,
        cuda_pathwise_rev_win, cuda_pathwise_win, cuda_poa_gap_global, cuda_poa_gap_global_win,
        cuda_poa_gap_local, cuda_poa_global, cuda_poa_global_win, cuda_poa_local,
        cuda_poa_variants as cv, cuda_split_summary, pathwise_engine, pathwise_gap_engine,
        pathwise_window, poa_engine, poa_gap_engine, poa_variants as pv, recombination_engine,
        recombination_window, traceback_engine as tb,
    )

    def int16_refused(x, got):
        try:
            cv.fill_local_v2_cuda(x.dg, x.table, x.seq, x.L, torch.int16)
        except ValueError:
            return f"; int16 refused at n = {x.dg.n}"
        raise AssertionError(f"K15: int16 was not refused at n = {x.dg.n}")

    def walk_equal(x, got):
        """K16's walk over its score plane equals walk_poa's over K2's
        packed planes for the same reads."""
        packed = cuda_poa_local.fill_local_cuda(x.dg, x.table, x.seq, x.L)[3]
        W = tb.max_walk_steps(x.dg.n, x.seq.shape[1])
        t0 = time.perf_counter()
        walk = tb.walk_local_scores(got[3], x.seq, x.table, x.dg.node_start, x.dg.codes,
                                    x.dg.pred_idx, got[1], got[2], W)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if not kernel_ab.walks_equal(walk, packed, got[1], got[2], W):
            raise AssertionError("K16: walk_local_scores differs from walk_poa over K2's planes")
        return (f"; walk_local_scores ({secs:.3f} s, {int(walk[2].sum())} steps) equal to "
                "walk_poa's over K2's planes")

    def over(x, got):
        return f" W={x.W} over={int(got[-1].sum())}/{x.seq.shape[0]}"

    def guard(x, got):
        fc = pathwise_window._final_column_win(got[0], got[1], x.L)
        end = pathwise_engine._end_meta(x.g, "cuda")
        score = pathwise_engine._endings_global_dev(fc, *end)[2]
        return f" W={x.W} guard fails {int((score <= got[2]).sum())}/{x.seq.shape[0]}"

    def exit_account(x, got):
        return f" W={x.W} Rr set {int((got[2] > poa_engine.NEG).sum())}/{x.seq.shape[0]}"

    def s1_entry(kernel, replaces):   # an entry of S1 as the result line lists it
        return SimpleNamespace(KERNEL=kernel, SOURCE=cuda_split_summary.SOURCE, REPLACES=replaces)

    poa = [case(c) for c in ("example", "random101", "random202", "random303")]
    local = poa + [case("example", "HOXD70")]
    loc_args = lambda x: (x.dg, x.table, x.seq, x.L)  # noqa: E731
    glob_args = lambda x: (x.dg, x.table, x.seq, x.L, x.bta)  # noqa: E731
    loc = lambda layout: shared_plain(poa_engine.fill_local_plain_planes, 4, layout)  # noqa: E731
    glob = lambda layout: shared_plain(poa_engine.fill_global_plain, 5, layout)  # noqa: E731
    win = [dict(c, W=32) for c in poa]   # W = 32: some reads overflow
    rand = [case(f"random{s}", semi=semi) for s in (101, 202, 303) for semi in (False, True)]
    leak = [case(f"leak{s}", semi=semi) for s in fuzz.LEAK_SEEDS for semi in (False, True)]
    # K7/K8 at the edges of their layout (cuda_pathwise.plan): one path; 7
    # paths at 1, 2 and 4 blocks a read and the wrapper's choice; 126 at
    # 1; a width of 151; a 41,000-bp read (the device-scratch form)
    edges = [case("p1"), case("p1", semi=True), case("p7"), case("p7", semi=True),
             *(case("p7", cluster=k) for k in (1, 2, 4)), case("p126", pad_to=256, cluster=1),
             case("example", width=151), case("example", semi=True, width=151),
             case("long41"), case("long41", semi=True)]
    # K5 at the edges of its layout (cuda_poa_gap_local.plan): 1-bp reads;
    # widths of 151 (no 16-byte stores), 168, 232 (just past one warp a
    # read) and 328 (past two warp segments; reads pad to 8 columns); 2
    # warps a read and the full form forced; 40 predecessor slots; a
    # 4,900-bp read (the full form in two windows)
    GP = cuda_poa_gap_local.Plan
    gl_edges = [case("bp1"), case("bp1", oe=(1, -2)), case("example", width=151),
                case("example", pad_to=161),
                case("example", pad_to=225), case("example", "HOXD70", pad_to=321, oe=(1, -2)),
                case("example", layout=GP(2, 5, False)),
                case("example", oe=(1, -2), layout=GP(16, 9, True)), case("fan40"),
                case("fan40", "HOXD70", oe=(1, -2), layout=GP(2, 5, False)), case("long5k")]
    # K5's clamped chain, past (|o| + |e|) x Lp = 2^27: the CLI's -O 100000
    # -E 1 on reads past 1,342 bp (16 warps a read; the full form), and on
    # the example reads (one warp a read) at (-2^20, 0) and at e = -2^22,
    # where the reference's scan clamps
    gl_clamped = [case("long2", oe=(-100000, -1)), case("example", oe=(-(1 << 20), 0)),
                  case("example", oe=(-(1 << 20), 0), layout=GP(16, 9, True)),
                  case("example", oe=(-5, -(1 << 22)))]
    # K2 and K4 at the edges of the same layout: widths of 224 (one warp of
    # 7 columns a lane) and 225 (two warps) besides K5's, the full form in
    # one window (forced) and in two (the 4,900-bp read); K4 also past its
    # prefix-max chain's range ((|o| + |e|) (2n + 2Lp + 2) >= 2^26: the
    # clamped chain) on one warp, two and the full form
    wl_edges = [case("bp1"), case("example", width=151), case("example", pad_to=224),
                case("example", pad_to=225), case("example", layout=GP(2, 5, False)),
                case("example", layout=GP(16, 9, True)), case("fan40"),
                case("fan40", layout=GP(2, 5, False)), case("long5k")]
    gg_edges = wl_edges + [case("bp1", oe=(1, -2)), case("example", pad_to=225, oe=(1, -2)),
                           case("fan40", "HOXD70", oe=(1, -2), layout=GP(16, 9, True)),
                           case("example", oe=(-30000, -1)),
                           case("example", pad_to=225, oe=(-30000, -1)),
                           case("example", oe=(-30000, -1), layout=GP(16, 9, True))]
    # K1 at the same edges, and HOXD70 on several warps and the full form
    gc_edges = wl_edges + [case("example", "HOXD70", layout=GP(3, 3, False)),
                           case("fan40", "HOXD70", layout=GP(16, 9, True))]
    # K6 at the smallest window; at W 256 and 512 on the bubble (the window
    # jumps back by W or more), with forced layouts, (o, e) = (+1, -2) and
    # past the prefix-max chain's range (the clamped chain)
    gw_edges = [case("example", W=8), case("bubble", W=256), case("bubble", W=512),
                case("bubble", W=256, layout=GP(3, 3, False)),
                case("bubble", W=256, oe=(1, -2)),
                case("bubble", W=512, oe=(-30000, -1), layout=GP(16, 9, True)),
                case("example", W=32, oe=(-30000, -1))]
    # K3 at the smallest window and at one warp of 3, 5 and 7 columns a
    # lane (W 96, 160, 224), and at W 256 and 512 on the bubble (the window
    # jumps back by W or more) at the wrapper's layout, 3 warps forced and
    # the full form
    gk_edges = [case("example", W=8), case("example", W=96),
                case("example", "HOXD70", W=160), case("example", W=224),
                case("bubble", W=256), case("bubble", W=256, layout=GP(3, 3, False)),
                case("bubble", W=512, layout=GP(16, 9, True))]
    # K14 at K1's edges: a width of 151 (Lp + 8 not a multiple of 4: 4-byte
    # stores), several warps and the full form forced (the plain fill K1's
    # check ran on the same inputs)
    gv_edges = [case("example", width=151), case("example", layout=GP(2, 5, False)),
                case("example", layout=GP(16, 9, True)),
                case("fan40", "HOXD70", layout=GP(16, 9, True))]
    # K15 at int16 on rows of 151 and 156 cells (2- and 4-byte stores; 152
    # takes 16-byte ones), the latter also on 2 warps and the full form
    lv_int16 = [case("example", dtype="int16", width=151),
                case("example", dtype="int16", pad_to=160, width=156),
                case("example", dtype="int16", pad_to=160, width=156, layout=GP(2, 5, False)),
                case("example", dtype="int16", pad_to=160, width=156, layout=GP(16, 9, True))]
    gap = [case("tile")] + [case(c, matrix=m, oe=oe, semi=semi) for semi in (False, True)
                            for c, m, oe in (
        ("example", "none", (O, E)), ("p130", "none", (O, E)), ("p33", "none", (O, E)),
        ("fan40", "none", (O, E)),
        ("example", "HOXD70", (-200, -2)), ("random101", "HOXD70", (-200, -2)),
        ("random202", "none", (-3, -1)), ("example", "none", (-3, -1)))]
    return [
        dict(id="K1", mod=cuda_poa_global, kern=cuda_poa_global.fill_global_cuda,
             plain=glob(lambda out: out), shared=True, graph="poa", ops=(24, 4),
             args=glob_args, cases=poa + [case("long64"), *gc_edges]),
        dict(id="K2", mod=cuda_poa_local, kern=cuda_poa_local.fill_local_cuda,
             plain=loc(lambda out: out[:4]), shared=True, graph="poa", ops=(20, 4),
             args=loc_args, cases=local + wl_edges + [case("fan40", "HOXD70")]),
        dict(id="K13", mod=cv.LOCAL_V1, kern=cv.fill_local_v1_cuda,
             plain=loc(pv.local_v1_layout), shared=True, ab=True, graph="poa", ops=(20, 4),
             args=loc_args, shapes_of=cuda_poa_local.KERNEL, cases=local + wl_edges),
        dict(id="K14", mod=cv.GLOBAL_V1, kern=cv.fill_global_v1_cuda,
             plain=glob(pv.global_v1_layout), shared=True, ab=True, graph="poa", ops=(24, 4),
             args=glob_args, shapes_of=cuda_poa_global.KERNEL,
             cases=poa + [case("example", "HOXD70"), *gv_edges]),
        dict(id="K15", mod=cv.LOCAL_V2, kern=cv.fill_local_v2_cuda,
             plain=loc(pv.local_v2_layout), shared=True, ab=True, graph="poa", ops=(20, 4),
             args=lambda x: (*loc_args(x), getattr(torch, x.dtype)),
             shapes_of=cuda_poa_local.KERNEL, extra=int16_refused,
             cases=local + wl_edges + [case("example", dtype="int16"), *lv_int16]),
        dict(id="K16", mod=cv.LOCAL_SCORES, kern=cv.fill_local_scores_cuda,
             plain=loc(pv.local_scores_layout), shared=True, ab=True, graph="poa",
             ops=(20, 4), args=loc_args, shapes_of=cuda_poa_local.KERNEL, extra=walk_equal,
             cases=local + wl_edges),
        dict(id="K17", mod=cv.LOCAL_V4, kern=cv.fill_local_v4_cuda,
             plain=loc(pv.local_v4_layout), shared=True, ab=True, graph="poa", ops=(20, 4),
             args=loc_args, shapes_of=cuda_poa_local.KERNEL, cases=local + wl_edges),
        dict(id="K3", mod=cuda_poa_global_win, kern=cuda_poa_global_win.fill_global_win_cuda,
             plain=poa_engine.fill_global_windowed_plain, graph="poa", ops=(26, 6),
             args=lambda x: (x.dg, x.table, x.seq, x.L, x.bta, x.W), note=over,
             cases=win + gk_edges),
        dict(id="K4", mod=cuda_poa_gap_global, kern=cuda_poa_gap_global.fill_gap_global_cuda,
             plain=poa_gap_engine.fill_gap_global_plain, graph="poa", ops=(60, 8),
             args=lambda x: (x.dg, x.table, x.seq, x.L, x.bta, x.o, x.e),
             cases=poa + [case("example", oe=(1, -2)), case("example", "HOXD70"), *gg_edges]),
        dict(id="K5", mod=cuda_poa_gap_local, kern=cuda_poa_gap_local.fill_gap_local_cuda,
             plain=poa_gap_engine.fill_gap_local_plain, graph="poa", ops=(60, 8),
             args=lambda x: (x.dg, x.table, x.seq, x.L, x.o, x.e),
             cases=poa + [case("example", "HOXD70"), case("example", oe=(1, -2)), *gl_edges,
                          *gl_clamped]),
        dict(id="K6", mod=cuda_poa_gap_global_win,
             kern=cuda_poa_gap_global_win.fill_gap_global_win_cuda,
             plain=poa_gap_engine.fill_gap_global_windowed_plain, graph="poa", ops=(62, 10),
             args=lambda x: (x.dg, x.table, x.seq, x.L, x.bta, x.o, x.e, x.W), note=over,
             cases=win + [case("example", W=32, oe=(1, -2)), *gw_edges]),
        dict(id="K7", mod=cuda_pathwise, kern=cuda_pathwise.fill_pathwise_cuda,
             plain=pathwise_engine.fill_pathwise_plain, graph="path", ops=(16, 0),
             args=lambda x: (x.dg, x.table, x.seq, x.semi), main_also=dict(semi=True),
             views=[("K9a", MANY_PATHS["n_paths"], cuda_pathwise.REPLACES_BIGP)],
             cases=rand + [case("example"), case("example", semi=True),
                           case("example", "HOXD70"),
                           # past the JAX engine's packed-chain gate
                           case("example", "HOXD70", semi=True, pad_to=320),
                           case("p126", pad_to=256), case("p126", semi=True, pad_to=256),
                           *edges]),
        dict(id="K10", mod=cuda_pathwise_win, kern=cuda_pathwise_win.fill_pathwise_win_cuda,
             plain=pathwise_window.fill_pathwise_win_plain, graph="path", ops=(30, 0),
             args=lambda x: (x.dg, x.table, x.seq, x.L, x.W, pathwise_window.rmin_tensor(x.dg)),
             note=guard, cases=[case("long8", W=32), case("long8", W=1024),
                                case("example", W=32), case("example", "HOXD70", W=64),
                                # its layout's edges (cuda_pathwise_win.plan): reads
                                # that fail the guard beside a read shorter than W,
                                # W not a multiple of 4, rows of up to 9 groups, the
                                # per-read scratch in device memory
                                case("long8s", W=32), case("long8s", W=256),
                                case("example", W=34), case("long41", W=1024)]),
        # S2, the reverse form of K10's kernel: K10's cases and the
        # delta-leak reverse graphs (their reads pad to 8 or 16 columns)
        dict(id="S2", mod=cuda_pathwise_rev_win,
             kern=cuda_pathwise_rev_win.fill_pathwise_rev_win_cuda,
             plain=recombination_window.fill_pathwise_rev_win_plain, graph="rev", ops=(30, 0),
             args=lambda x: (x.dg, x.table, x.seq, x.L, x.W), note=exit_account,
             worker_plain=True,
             cases=[case("long8", W=32), case("long8", W=1024), case("example", W=32),
                    case("example", "HOXD70", W=64), case("long8s", W=32),
                    case("long8s", W=256), case("example", W=34), case("long41", W=1024),
                    *(case(f"leak{s}", W=8) for s in fuzz.LEAK_SEEDS)]),
        dict(id="K8", mod=cuda_pathwise_rev,
             kern=cuda_pathwise_rev.fill_pathwise_rev_cuda,
             plain=recombination_engine.fill_pathwise_rev_plain, graph="rev", ops=(16, 0),
             args=lambda x: (x.dg, x.table, x.seq, x.L, not x.semi), main_also=dict(semi=True),
             views=[("K9b", MANY_PATHS["n_paths"], cuda_pathwise_rev.REPLACES_BIGP)],
             cases=leak + [case("example"), case("example", semi=True),
                           case("example", "HOXD70"),
                           case("example", "HOXD70", semi=True, pad_to=320),
                           case("p126", pad_to=256), case("p126", semi=True, pad_to=256),
                           *edges]),
        dict(id="K11", mod=cuda_gap67_fill, kern=cuda_gap67_fill.fill_gap67_cuda,
             plain=pathwise_gap_engine.fill_gap_plain, graph="gap", ops=(24, 0),
             args=lambda x: (x.tabs, x.table, x.seq, x.o, x.e, x.semi),
             oracle_past_lp=1024, cpu_plain=True, cases=gap),
        dict(id="K12", mod=cuda_gap67_hardrow, kern=cuda_gap67_hardrow.hard_cols_cuda,
             plain=pathwise_gap_engine.hard_cols_plain, graph="hard", ops=(40, 0),
             args=lambda x: x.staged, shapes_of=cuda_gap67_fill.KERNEL,
             launches_of=cuda_gap67_fill.KERNEL,
             timed=lambda args: functools.partial(cuda_gap67_hardrow.launch,
                                                  *cuda_gap67_hardrow.prepare(*args)),
             cases=[case("fan40", W=-1), case("fan40", W=-1, semi=True)]),
        # S1's per-pair entry at the chunk shapes its guided entry ran at,
        # PAIRS_PER_LAUNCH pairs a launch; its device function runs inside
        # the guided entry, so its launches are the guided entry's
        dict(id="S1", mod=cuda_split_summary,
             kern=cuda_split_summary.col_summary_cuda,
             plain=recombination_engine.col_summary_plain, graph="split", ops=(10, 0),
             args=lambda x: (*x.inputs, x.geom, *x.rec, x.bidx, x.cols), main_also=dict(semi=True),
             shapes_of=cuda_split_summary.GUIDED, launches_of=cuda_split_summary.GUIDED,
             main_width=recombination_engine.PAIRS_PER_LAUNCH,
             cases=[case("example"), case("example", semi=True), case("example", rec=(0, 0.0)),
                    case("example", rec=(10, 2.0)), case("example", dead=True),
                    case("random101"), case("leak4")]),
        # S1's guided entry against the plain search (``_run_split_guided``,
        # its host rounds of the per-pair entry as the main path ran them
        # before), all seven outputs bit for bit, in modes 8 and 9 at 1
        # block a read and the wrapper's count at every chunk shape, with
        # the invariant checked on its evaluated columns (``guided_note``)
        dict(id="S1g", mod=s1_entry(cuda_split_summary.GUIDED, cuda_split_summary.REPLACES_GUIDED),
             kern=guided_kern, plain=guided_plain, graph="guided",
             ops=(10, 0), args=lambda x: x.gargs, note=guided_note,
             every_shape=[dict(semi=True), dict(cluster=1), dict(semi=True, cluster=1)],
             cases=[dict(c, cluster=k) for k in (None, 1) for c in (
                 case("example"), case("example", semi=True), case("example", rec=(0, 0.0)),
                 case("example", rec=(10, 2.0, 0.5)), case("example", dead=True))]),
        # S1's bound entry against _column_ub, bit for bit
        dict(id="S1b", mod=s1_entry(cuda_split_summary.BOUND, cuda_split_summary.REPLACES_BOUND),
             kern=cuda_split_summary.column_ub_cuda,
             plain=lambda *a: recombination_engine._column_ub(*a[:6]), graph="bound",
             ops=(16, 0), args=lambda x: x.bargs, main_also=dict(semi=True),
             cases=[case("example"), case("example", semi=True), case("example", rec=(0, 0.0)),
                    case("example", dead=True)]),
    ]


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors if hasattr(t, "numel"))


def bound(spec, x, got):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    int32 operations over the int32 rate.  Bytes: each input read once
    (the tensor arguments: reads, lengths, band slack, table, rmin; and
    the graph arrays the kernel reads: for POA codes, predecessors,
    fallbacks and distances, for paths the codes and the group table,
    and for the reverse graph its qsrc table; for S1 the six summaries
    at its pairs' columns, the geometry and the pairs; for its guided
    entry the summaries at the columns it evaluated, the geometry, ub,
    the active columns and the baselines; for its bound entry the flags
    and the values where they hold, and the sign weights) and each output
    written once (every tensor the kernel returns).  Operations: per
    stored cell (reads x rows x width x paths), a fixed count for the
    recurrence plus a count per predecessor, at this graph's mean
    predecessors per row; for S1 a fixed count per candidate pair that
    has both sides on their paths (the pairs the kernel evaluates; the
    guided entry's evaluated pairs as this run's data chose them; for its
    bound entry a count per summary cell).  K11
    reads the reads, the table and the graph's fill tables and writes
    the three planes; K12 reads its staged inputs and writes x and d,
    with a fixed count per (column, lane, read)."""
    from recgraph_tpu_torch.ops.encode import group_table

    c0, c1 = spec["ops"]
    if spec["graph"] == "hard":
        C, P, B = x.staged[3].shape
        t_bytes = (nbytes(x.staged) + nbytes(got)) / HBM_BYTES_PER_S
        t_ops = C * P * B * c0 / INT32_OPS_PER_S
    elif spec["graph"] == "gap":
        B, Lp = x.seq.shape
        t = x.tabs
        graph = nbytes((t.rows, t.lanemask, t.blocks, t.blockmask, t.lanes, t.chain))
        t_bytes = (nbytes(spec["args"](x)) + graph + nbytes(got)) / HBM_BYTES_PER_S
        t_ops = B * t.meta.n * Lp * t.meta.P * c0 / INT32_OPS_PER_S
    elif spec["graph"] == "bound":   # the flags, and the values where they hold
        fmax, vf, rmax, vr, wf, wr, _ = x.bargs
        cells = fmax.numel()
        t_bytes = (2 * cells + 4 * (int(vf.sum()) + int(vr.sum())) + nbytes((wf, wr))
                   + nbytes(got)) / HBM_BYTES_PER_S
        t_ops = cells * c0 / INT32_OPS_PER_S
    elif spec["graph"] == "guided":
        (B, I, Lp), done = x.inputs[0].shape, x.state["done"]
        b, c = done.nonzero(as_tuple=True)
        nvf = x.inputs[2][b, :, c].sum(1).double()
        nvr = x.inputs[5][b, :, c].sum(1).double()
        ub_etc = B * Lp * (4 + 1) + B * 4   # ub, active, init_best
        t_bytes = (b.numel() * I * 18 + I * 14 + ub_etc + nbytes(got)) / HBM_BYTES_PER_S
        t_ops = float((nvf * nvr).sum()) * c0 / INT32_OPS_PER_S
    elif spec["graph"] == "split":
        K, (B, I, Lp) = x.bidx.shape[0], x.inputs[0].shape
        b, c = x.bidx.long(), x.cols.long()
        nvf = x.inputs[2][b, :, c].sum(1).double()
        nvr = x.inputs[5][b, :, c].sum(1).double()
        t_bytes = (K * I * 18 + I * 14 + nbytes((x.bidx, x.cols)) + nbytes(got)) / HBM_BYTES_PER_S
        t_ops = float((nvf * nvr).sum()) * c0 / INT32_OPS_PER_S
    else:
        B, Lp = x.seq.shape
        dg = x.dg
        if spec["graph"] == "poa":
            graph, P = 4 * dg.n * (4 + dg.max_preds), 1
            preds = float(dg.pred_mask.sum()) / dg.n
        else:
            graph, P, preds = 4 * dg.n + nbytes(group_table(dg)), dg.paths_number, 0.0
            if dg.qsrc_of is not None:
                graph += nbytes((dg.qsrc_of,))
        t_bytes = (nbytes(spec["args"](x)) + graph + nbytes(got)) / HBM_BYTES_PER_S
        t_ops = B * dg.n * x.W * P * (c0 + c1 * preds) / INT32_OPS_PER_S
    t_bytes, t_ops = t_bytes * 1e3, t_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_reverse: dict = {}


def reverse_of(g):
    """The reverse graph of ``g``, built once per graph."""
    if id(g) not in _reverse:
        _reverse[id(g)] = (g, g.reverse())
    return _reverse[id(g)][1]


def split_case(g, reads, c, x):
    """S1's inputs for case ``c``: K7 and K8 on the card for the reads,
    the per-cell best paths, the geometry and the pairs (``c["W"]``
    pairs spread over the reads and columns, or every interior column of
    every read); for the guided entry (``x.gargs``) also ub, the active
    columns of the band (``c["rec"]``: R, r and the band width, 1 when
    not given) and the baselines; for the bound entry (``x.bargs``) the
    summaries and flags with the sign weights."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from recgraph_tpu_torch.ops import (
        cuda_pathwise, cuda_pathwise_rev, pathwise_engine, recombination_engine as rec,
    )
    from recgraph_tpu_torch.ops.encode import rev_device_graph

    rg = reverse_of(g)
    dgr = rev_device_graph(rg, "cuda")
    Af = cuda_pathwise.fill_pathwise_cuda(x.dg, x.table, x.seq, c["semi"])
    Ar = cuda_pathwise_rev.fill_pathwise_rev_cuda(dgr, x.table, x.seq, x.L, not c["semi"])
    inputs = list(rec.split_inputs(Af, Ar, x.dg.paths_on))
    finalcol = pathwise_engine._final_column(Af, x.L).cpu().numpy()
    init = rec._baseline(9 if c["semi"] else 8, finalcol, g)[0]
    del Af, Ar
    if c["dead"]:
        inputs[5] = torch.zeros_like(inputs[5])
    B, Lp = x.seq.shape
    if c["W"] is None:
        bidx = torch.arange(B, device="cuda").repeat_interleave(Lp - 2)
        cols = 1 + torch.arange(Lp - 2, device="cuda").repeat(B)
    else:
        p = torch.arange(c["W"], device="cuda")
        bidx, cols = p % B, 1 + (p * 37) % (Lp - 2)
    R, r, rbw = (*c["rec"], 1.0)[:3]
    x.inputs, x.rec = tuple(inputs), (R, r)
    geom = rec._SplitGeometry(g, rg)
    x.geom = geom.tensors("cuda")
    x.bidx, x.cols = bidx.to(torch.int32), cols.to(torch.int32)
    Lnp = x.L.cpu().numpy()
    oob = np.maximum((Lnp * (1.0 - rbw) / 2.0).astype(np.int64), 1)
    jcol = np.arange(Lp)
    active = (jcol[None, :] >= oob[:, None]) & (jcol[None, :] < (Lnp - oob)[:, None])
    wf, wr = (torch.from_numpy(w).cuda() for w in rec._sign_weights(geom, r))
    x.bargs = (inputs[0], inputs[2], inputs[3], inputs[5], wf, wr, geom.paths)
    x.gargs = (x.inputs, x.geom, rec._split_ub(x.inputs, geom, r), torch.from_numpy(active).cuda(),
               torch.from_numpy(init.astype(np.float32)).cuda(), R, r,
               SimpleNamespace(geom=geom, active=active, init=init))


def hard_case(x, c):
    """K12's inputs for case ``c``: K11 fills the reads on the card, then
    the plain staging of one hard row (the row with the most blocks
    when ``c["W"]`` is -1, else the first hard row): the column
    program's arguments as ``hard_cols_plain`` takes them."""
    from recgraph_tpu_torch.ops import cuda_gap67_fill, pathwise_gap_engine as pge

    m = x.tabs.meta
    hard = [i for i in range(1, m.n - 1) if not m.easy[i]]
    i = hard[0] if c["W"] != -1 else max(hard, key=lambda r: (int(m.bvalid[r].sum()), r))
    Dm, X, Y = cuda_gap67_fill.fill_gap67_cuda(x.tabs, x.table, x.seq, x.o, x.e, x.semi)
    sub = x.table[int(m.codes[i])][x.seq.long()]
    U, Dc, Dfd, Ypre, _ = pge.stage_hard_row(x.tabs, Dm, Y, i, sub, x.o, x.e)
    (tb, nd, fire, isa, after), ai = pge.hard_row_scalars(x.tabs, i)
    lc = x.tabs.lanes[i][:, :, None].expand(-1, -1, x.seq.shape[0]).contiguous()
    x0 = X[i, :, :, 0].t().contiguous()
    del Dm, X, Y
    x.row, x.W = i, None
    x.staged = (U, Dc, Dfd, Ypre, lc, x0, tb, nd, fire, isa, after, ai, x.o, x.e)


# the knobs of a case that only the kernel reads: cases that differ in
# them alone share one plain result (``refs`` of check_case)
KERNEL_KNOBS = ("layout", "cluster", "extra")


def case_inputs(kind, g, reads, c, device):
    """Case ``c``'s inputs on ``device``: the graph's encoding for the
    kernel's graph kind, the scoring table, the encoded reads and the
    case's fields."""
    from types import SimpleNamespace

    import torch

    from recgraph_tpu_torch.ops.encode import (
        encode_read_aux, encode_reads, path_device_graph, poa_device_graph, rev_device_graph,
    )
    from recgraph_tpu_torch.ops.pathwise_gap_engine import gap_tables
    from recgraph_tpu_torch.scoring import ScoreMatrix

    if kind == "poa":
        dg = poa_device_graph(g, device)
    elif kind == "rev":
        dg = rev_device_graph(reverse_of(g), device)
    else:
        dg = path_device_graph(g, device)
    table = torch.as_tensor(ScoreMatrix.create(c["matrix"], 2, -4).table,
                            dtype=torch.int32).to(device)
    seq, L = encode_reads(reads, pad_to=c["pad_to"], device=device)
    if c["width"] is not None:
        seq = seq[:, : c["width"]].contiguous()
    bta = encode_read_aux([int(1 + 0.01 * len(s)) for s in reads], device)
    x = SimpleNamespace(g=g, dg=dg, table=table, seq=seq, L=L, bta=bta, W=c["W"],
                        o=c["oe"][0], e=c["oe"][1], semi=c["semi"], dtype=c["dtype"],
                        cluster=c.get("cluster"))
    if kind in ("gap", "hard"):
        x.tabs = gap_tables(g, device)
    return x


def outputs_digest(tensors):
    """SHA-256 of outputs' dtypes, shapes and bytes: equal digests are
    equal outputs."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(f"{t.dtype} {tuple(t.shape)}".encode())
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


# the graph kinds whose exactness cases run their plain version on a CPU
# worker (not the K1/K2 family, whose plain fills the checks share)
WORKER_PLAIN = ("poa", "path", "gap")


def cpu_plain_digest(spec_id, g, reads, c):
    """A kernel's plain version on case ``c`` on the CPU (a worker job):
    the digest of its outputs."""
    t0 = time.perf_counter()
    spec = next(sp for sp in kernel_specs() if sp["id"] == spec_id)
    ref = spec["plain"](*spec["args"](case_inputs(spec["graph"], g, reads, c, "cpu")))
    return outputs_digest(ref if isinstance(ref, tuple) else (ref,)), time.perf_counter() - t0


def check_case(spec, label, g, reads, c, timed=False, refs=None):
    """One kernel call against its plain version on the same inputs
    (case ``c``); returns (max_abs_err, timing or None).  ``refs``: the
    kernel's plain results so far by graph, reads and case fields but
    the kernel's knobs (``KERNEL_KNOBS``), reused where only those
    differ.  The exactness cases of the kernels of ``WORKER_PLAIN``'s
    graph kinds (K3-K7, K10, K11) hold the kernel to its plain version
    run on a CPU worker (deferred): their plain fills, seconds each, then
    run beside the card's checks."""
    import dataclasses

    import torch

    from recgraph_tpu_torch.ops.encode import group_table

    kind = spec["graph"]
    x = case_inputs(kind, g, reads, c, "cuda")
    dg, seq = x.dg, x.seq
    if kind in ("split", "guided", "bound"):
        split_case(g, reads, c, x)
    if kind == "hard":
        hard_case(x, c)
    args = spec["args"](x)
    kw = {} if c["cluster"] is None else {"cluster": c["cluster"]}
    if c["layout"] is not None:
        kw["layout"] = c["layout"]
    got = spec["kern"](*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    torch.cuda.synchronize()
    B, Lp = seq.shape
    plain = c["plain"]
    if plain is True and not timed and (kind in WORKER_PLAIN or spec.get("worker_plain")) \
            and not spec.get("shared"):
        plain = "worker"
    key = (id(g), tuple(reads), tuple(sorted((k, v) for k, v in c.items()
                                             if k not in KERNEL_KNOBS)))
    if plain == "worker":
        ref, plain_ms = got, None
    elif refs is not None and plain is True and key in refs:
        ref, plain_ms = refs[key], None
    else:
        t0 = time.perf_counter()
        ref = spec["plain"](*args) if plain is True else got
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3 if plain is True else None
        if plain is True and spec.get("shared"):   # the cached plain fill's time and the layout's
            ref, plain_ms = ref
        ref = ref if isinstance(ref, tuple) else (ref,)
        if refs is not None and plain is True:
            refs[key] = ref
    if kind == "poa":
        how = f"o={x.o}, e={x.e}" + (f", {x.dtype}" if x.dtype != "int32" else "")
    elif kind == "path":
        how = f"mode {5 if c['semi'] else 4}"
    elif kind in ("gap", "hard"):
        how = f"mode {7 if c['semi'] else 6}, o={x.o}, e={x.e}"
    else:
        how = f"mode {9 if c['semi'] else 8}"
        if kind in ("split", "guided", "bound"):
            how += (f", R={c['rec'][0]} r={c['rec'][1]}"
                    + (f" B={c['rec'][2]}" if len(c["rec"]) > 2 else "")
                    + (", no valid pair" if c["dead"] else ""))
    if c["cluster"] is not None:
        how += f", {c['cluster']} blocks a read"
    if c["layout"] is not None:
        lay = c["layout"]
        how += (f", {lay.warps} warps x {lay.cw} columns a lane"
                + (", full form" if lay.full else ""))
    err = compare(f"{spec['id']} {label} {c['matrix']} {how} W={x.W}", got, ref)
    note = spec["note"](x, got) if "note" in spec else ""
    if c["extra"] and "extra" in spec:
        note += spec["extra"](x, got)
    if plain == "oracle":   # K11 at the long reads' shapes: read 0 against the scalar oracle
        mode = 7 if x.semi else 6
        digest = planes_digest([t[:, 0, :, : len(reads[0])] for t in got])

        def check(res):
            if res[0] != digest:
                raise AssertionError(f"{spec['id']} {label} mode {mode}: read 0's planes differ "
                                     "from the scalar oracle's")

        defer(f"{spec['id']} {label} mode {mode} B={B} Lp={Lp}",
              "read 0's planes equal to the scalar oracle's on every cell", check,
              cpu_gap_oracle, g.__dict__["_smoke_gfa"], reads[0], mode)
        note += " (read 0 goes to the scalar oracle on a CPU worker)"
    elif plain == "worker":
        digest = outputs_digest(got)

        def check(ref_digest):
            if ref_digest != digest:
                raise AssertionError(f"{spec['id']} {label} {c['matrix']} {how} W={x.W}: "
                                     "outputs differ from the plain version")

        # the graph without the device encodings cached on it
        bare = type(g)(**{f.name: getattr(g, f.name) for f in dataclasses.fields(g)})
        defer(f"{spec['id']} {label} {how} B={B} Lp={Lp}",
              "outputs equal to the plain version on a CPU worker", check, cpu_plain_digest,
              spec["id"], bare, list(reads), {k: v for k, v in c.items() if k not in KERNEL_KNOBS})
        note += " (the plain version on a CPU worker)"
    elif plain == "cpu":   # K11: the leading reads against the plain fill on a CPU worker
        k = min(B, K11_CPU_READS)
        digest = planes_digest([t[:, :k] for t in got])

        def check(ref_digest):
            if ref_digest != digest:
                raise AssertionError(f"{spec['id']} {label}: the leading {k} reads' planes "
                                     "differ from the plain fill")

        defer(f"{spec['id']} {label} B={B} Lp={Lp}",
              f"leading {k} reads' planes equal to the plain fill on the CPU", check,
              cpu_gap_fill_digest, g.__dict__["_smoke_gfa"], reads[:k], c["matrix"], x.o, x.e,
              x.semi, Lp)
        note += f" (the leading {k} reads go to the plain fill on a CPU worker)"
    if kind == "poa":
        paths = f" Pm={dg.max_preds}"
    elif kind in ("gap", "hard"):
        m = x.tabs.meta
        paths = f" P={m.P} MB={m.maxb} hard rows={x.tabs.hard_rows}"
        if kind == "hard":
            paths += f" row={x.row} C={Lp - 1}"
    else:
        paths = f" P={dg.paths_number} Gd={group_table(dg)[0].shape[1]}"
    if kind == "split":
        paths += f" pairs={x.bidx.shape[0]}"
    log(f"{spec['id']} {spec['mod'].KERNEL} {label} ({c['matrix']}, {how}): B={B} n={dg.n} "
        f"Lp={Lp}{paths}{note} {'exact' if plain is True else 'launched'} "
        f"(max_abs_err {err})")
    if not timed:
        return err, None
    bound_ms, bound_by = bound(spec, x, got)
    del got, ref
    # the kernel's own time (K12: without its wrapper's host-side layout)
    ms = cuda_ms(spec["timed"](args) if "timed" in spec else lambda: spec["kern"](*args), 3)
    plain_txt = "not measured" if plain_ms is None else f"{plain_ms:.3f} ms"
    log(f"{spec['id']} time at B={B} n={dg.n}{paths} Lp={Lp} W={x.W}: kernel {ms:.3f} ms, "
        f"plain {plain_txt}, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{100 * bound_ms / ms:.2f} % of bound")
    return err, dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def check_kernels(shapes, corpora, cases):
    """Every kernel against its plain version at each shape the main path
    launched it at (``shapes``: metrics.SHAPES keys (kernel, reads, rows,
    Lp, width[, paths]) -> launches; inputs the leading reads of the
    corpus of that graph kind, rows and paths), timed there, and on its
    exactness cases.  Returns per kernel its max error and its timed
    shapes, the most launched first."""
    results = {}
    for spec in kernel_specs():
        t0 = time.perf_counter()
        if not spec.get("shared"):
            _plain_cache.clear()   # the mode-0/1 family is done
        kernel, err, timed = spec["mod"].KERNEL, 0, []
        of = spec.get("shapes_of", kernel)
        ours = sorted(((k[1:5], k[5] if len(k) > 5 else 1, v)
                       for k, v in shapes.items() if k[0] == of),
                      key=lambda t: (-t[2], -t[0][0] * t[0][3] * t[1]))
        if not ours:
            raise AssertionError(f"{spec['id']} {kernel} has no main-path launch")
        for k, ((B, n, Lp, W), P, launches) in enumerate(ours):
            g, reads = corpora[(corpus_kind(spec), n, P)]
            W = spec.get("main_width", W)
            plain = True
            if Lp > spec.get("oracle_past_lp", Lp):
                plain = "oracle"
            elif k and spec.get("cpu_plain"):
                plain = "cpu"
            main = case("main path", W=W, pad_to=Lp, plain=plain, extra=k == 0)
            e_, timing = check_case(spec, f"main path x{launches}", g, reads[:B], main,
                                    timed=True)
            err = max(err, e_)
            timed.append(dict(timing, shape=(B, n, Lp, W, P), launches=launches))
            if plain == "oracle":   # the long reads ran in mode 7 too
                err = max(err, check_case(spec, f"main path x{launches}", g, reads[:B],
                                          dict(main, semi=True))[0])
            if k == 0 and "main_also" in spec:
                err = max(err, check_case(spec, "main path", g, reads[:B],
                                          dict(main, **spec["main_also"]))[0])
            for more in spec.get("every_shape", []):
                err = max(err, check_case(spec, f"main path x{launches}", g, reads[:B],
                                          dict(main, **more))[0])
            if spec["graph"] == "hard":   # K12 also on the row with the most blocks
                err = max(err, check_case(spec, f"main path x{launches}", g, reads[:B],
                                          dict(main, W=-1))[0])
        refs = {}
        for c in spec["cases"]:
            err = max(err, check_case(spec, c["name"], *cases[(corpus_kind(spec), c["name"])],
                                      c, refs=refs)[0])
        del refs
        results[spec["id"]] = dict(spec=spec, err=err, timed=timed)
        log(f"{spec['id']} checks: {time.perf_counter() - t0:.1f} s")
    return results


def run_capture(**kw):
    from recgraph_tpu_torch.align.pipeline import Options, run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        run(Options(**kw))
    return buf.getvalue()


def cli_run(tag, mode, reads_fa, graph_gfa, out, expect, launches, shapes):
    """One CLI run on the card with the counters zeroed just before and
    read just after, added to ``launches`` and ``shapes``; fails unless
    every kernel in ``expect`` launched.  Modes 6/7 print their lines
    (two a read) to stdout whatever ``-o`` says, and K11 must have
    counted hard rows whose K12 column program it ran."""
    import torch

    from recgraph_tpu_torch import cli, metrics

    if os.path.exists(out):
        os.remove(out)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics.reset_phases()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(buf):
        cli.main(["-m", str(mode), reads_fa, graph_gfa, "-o", out, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(metrics.LAUNCHES)
    got_shapes = dict(metrics.SHAPES)
    metrics.flush_device_counters()
    events = dict(metrics.EVENTS)
    phases = metrics.phases_dict()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k in expect:
        if not got.get(k):
            raise AssertionError(f"{tag}: kernel {k} was not launched ({got})")
    launches.update(got)
    shapes.update(got_shapes)
    if mode in (6, 7):
        if os.path.exists(out):
            raise AssertionError(f"{tag}: modes 6/7 wrote {out}; they print to stdout")
        if not events.get("gap67_hard_rows"):
            raise AssertionError(f"{tag}: no hard row ran K12's column program ({events})")
        lines = buf.getvalue().splitlines()
        n_out = len(lines) // 2
        got["gap67_hard_rows (K12 programs)"] = events["gap67_hard_rows"]
    else:
        with open(out) as fh:
            lines = fh.read().splitlines()
        n_out = len(lines)
    log(f"{tag}: {n_out} reads in {wall:.3f} s = {n_out / wall:.1f} reads/s; "
        f"launches {got}; peak device memory {peak:.2f} GiB")
    log(f"{tag} launch shapes (kernel, reads, rows, Lp, width): {got_shapes}")
    log(f"{tag} phases: " + json.dumps(
        {k: round(v, 4) for k, v in sorted(phases.items(), key=lambda kv: -kv[1])}))
    return lines


# The CPU checks (the port's CPU run on sampled reads, K11's plain fill
# at its other short-read launch shapes, and the scalar oracle on a long
# read) run in worker processes while phase 6 works on the card: their
# plain versions cost seconds to minutes a read on the CPU.  Jobs are
# queued from phase 4 on and the workers start only after the last timed
# CLI run, so that no timed run shares the host with them.
CPU_WORKERS, CPU_THREADS = 6, 1
K11_CPU_READS = 8   # leading reads of a chunk held against the CPU plain fill
_pool = None
_jobs: dict = {}       # (function, repr of its arguments) -> job
_deferred: list = []   # (tag, job, check, what)


def _cpu_worker_init():
    import torch

    torch.set_num_threads(CPU_THREADS)
    sys.path.insert(0, ROOT)


def start_cpu_workers():
    """Start the workers and hand them every queued job, in queue order."""
    global _pool
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    _pool = ProcessPoolExecutor(CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                                initializer=_cpu_worker_init)
    for job in _jobs.values():
        job.future = _pool.submit(job.fn, *job.args)


def stop_cpu_workers():
    if _pool is not None:
        _pool.shutdown(wait=True, cancel_futures=True)


def cpu_job(fn, *args):
    """``fn(*args)`` on a CPU worker, once per distinct call: queued
    until the workers start, submitted at once after that."""
    from types import SimpleNamespace

    key = (fn.__name__, repr(args))
    if key not in _jobs:
        _jobs[key] = SimpleNamespace(fn=fn, args=args, future=None)
        if _pool is not None:
            _jobs[key].future = _pool.submit(fn, *args)
    return _jobs[key]


def defer(tag, what, check, fn, *args):
    """Run ``fn(*args)`` on a CPU worker; ``check(result)`` raises on a
    mismatch when ``drain_cpu_checks`` collects it."""
    _deferred.append((tag, cpu_job(fn, *args), check, what))


def drain_cpu_checks():
    for tag, job, check, what in _deferred:
        res, secs = job.future.result()
        check(res)
        log(f"{tag}: {what} ({secs:.1f} s on a CPU worker)")
    _deferred.clear()


def cpu_run_lines(kw):
    """The port's CLI on the CPU (a worker job): its output lines.  Every
    window-width hint starts empty, as it did for the card's run."""
    from recgraph_tpu_torch.ops import pathwise_engine, poa_engine

    pathwise_engine._pw_w_hint.clear()
    poa_engine._long_w_hint.clear()
    t0 = time.perf_counter()
    lines = run_capture(**kw).splitlines()
    return lines, time.perf_counter() - t0


@contextlib.contextmanager
def env(**values):
    """The environment variables set to ``values`` inside the block."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cpu_rec_window_lines(fastas, graph_gfa):
    """Mode 8 with RECGRAPH_REC_WINDOW=1 on the CPU (a worker job), each
    one-read file alone from an empty window hint, as every read of the
    card's run started its ladder at W 256: the output lines."""
    from recgraph_tpu_torch.ops import pathwise_engine

    t0 = time.perf_counter()
    lines = []
    with env(RECGRAPH_REC_WINDOW="1"):
        for fa in fastas:
            pathwise_engine._pw_w_hint.clear()
            lines += run_capture(sequence_path=fa, graph_path=graph_gfa, alignment_mode=8,
                                 device="cpu").splitlines()
    return lines, time.perf_counter() - t0


def cpu_gap_results(mode, reads, graph_gfa):
    """Modes 6/7 on the CPU in one fill chunk (a worker job): [(best
    path, line)] per read."""
    from recgraph_tpu_torch.graph.pathgraph import PathGraph
    from recgraph_tpu_torch.io import gfa
    from recgraph_tpu_torch.ops import pathwise_gap_engine
    from recgraph_tpu_torch.scoring import ScoreMatrix

    t0 = time.perf_counter()
    g = PathGraph.from_gfa(gfa.parse_gfa(graph_gfa))
    res = pathwise_gap_engine.run_batch(mode, reads, g, ScoreMatrix.create("none", 2, -4), O, E,
                                        "cpu", chunk_bytes=1 << 40)
    return res, time.perf_counter() - t0


def planes_digest(planes):
    """SHA-256 of int32 planes' bytes: equal digests are equal planes."""
    h = hashlib.sha256()
    for t in planes:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def cpu_gap_fill_digest(graph_gfa, reads, matrix, o, e, semi, pad_to):
    """K11's plain fill on the CPU (a worker job): the digest of its
    three planes."""
    import torch

    from recgraph_tpu_torch.graph.pathgraph import PathGraph
    from recgraph_tpu_torch.io import gfa
    from recgraph_tpu_torch.ops import pathwise_gap_engine
    from recgraph_tpu_torch.ops.encode import encode_reads
    from recgraph_tpu_torch.scoring import ScoreMatrix

    t0 = time.perf_counter()
    g = PathGraph.from_gfa(gfa.parse_gfa(graph_gfa))
    table = torch.as_tensor(ScoreMatrix.create(matrix, 2, -4).table, dtype=torch.int32)
    seq, _ = encode_reads(reads, pad_to=pad_to)
    planes = pathwise_gap_engine.fill_gap_plain(pathwise_gap_engine.gap_tables(g, "cpu"), table,
                                                seq, o, e, semi)
    return planes_digest(planes), time.perf_counter() - t0


def cpu_gap_oracle(graph_gfa, read, mode):
    """The scalar oracle (``oracle.pathwise_gap.fill_fast``, cell for cell
    the reference's fill) on one read in mode 6 or 7 (a worker job): the
    digest of its dpm, x and y in K11's layout [n, P, len(read)], and
    the read's two printed lines, the CIGAR line and the best path, as
    ``exec_gap_global`` / ``exec_gap_semiglobal`` give them."""
    import numpy as np
    import torch

    from recgraph_tpu_torch.graph.pathgraph import PathGraph
    from recgraph_tpu_torch.io import gfa
    from recgraph_tpu_torch.oracle import pathwise_gap as og
    from recgraph_tpu_torch.scoring import ScoreMatrix

    t0 = time.perf_counter()
    g = PathGraph.from_gfa(gfa.parse_gfa(graph_gfa))
    planes = og.fill_fast(read, g, ScoreMatrix.create("none", 2, -4), O, E, mode == 7)
    if max(int(np.abs(p).max()) for p in planes) >= 2**31:
        raise AssertionError("oracle planes past int32")
    digest = planes_digest([torch.from_numpy(p.transpose(0, 2, 1).astype(np.int32))
                            for p in planes])
    if mode == 6:
        bp = og.best_path_gap_global(planes[0], g)
        cigar = og.build_alignment_gap(*planes, g, bp)
    else:
        node, bp = og.best_ending_node_gap_semi(planes[0], g)
        cigar = og.build_alignment_semiglobal_gap(*planes, g, bp, node)
    return (digest, [cigar, f"Best path sequence 0: {bp}"]), time.perf_counter() - t0


def check_sample(tag, mode, lines, seqs, names, sample, graph_gfa, workdir):
    """The sampled reads' GAF lines equal the port's CPU run on them
    (deferred to a CPU worker).  Modes 4/5 and 8/9 wrote no line for
    read 0 (``-o``): read i is line i - 1."""
    sample_fa = os.path.join(workdir, f"sample_{tag.replace(' ', '_')}.fa")
    write_fasta(sample_fa, [seqs[i] for i in sample], [names[i] for i in sample])
    offset = 1 if mode in (4, 5, 8, 9) else 0
    got = [lines[i - offset] for i in sample]

    def check(ref):
        if got != ref:
            bad = next(k for k, (a, b) in enumerate(zip(got + [""], ref + [""])) if a != b)
            raise AssertionError(f"{tag}: sample read {sample[bad]} differs from the CPU "
                                 f"run:\n{got[bad] if bad < len(got) else None}\n"
                                 f"{ref[bad] if bad < len(ref) else None}")

    defer(tag, f"{len(sample)}-read sample byte-equal to the CPU run", check, cpu_run_lines,
          dict(sequence_path=sample_fa, graph_path=graph_gfa, alignment_mode=mode, device="cpu"))


def check_sample_gap(tag, mode, lines, seqs, sample, graph_gfa):
    """Modes 6/7: the sampled reads' two lines each equal the port's CPU
    run on them (deferred to a CPU worker; one fill chunk, the read
    numbers the corpus's)."""
    got = [lines[2 * i : 2 * i + 2] for i in sample]

    def check(res):
        for i, g_, (bp, cigar) in zip(sample, got, res):
            if g_ != [cigar, f"Best path sequence {i}: {bp}"]:
                raise AssertionError(f"{tag}: sample read {i} differs from the CPU run:\n"
                                     f"{g_}\n{cigar} / {bp}")

    defer(tag, f"{len(sample)}-read sample byte-equal to the CPU run", check, cpu_gap_results,
          mode, [seqs[i] for i in sample], graph_gfa)


# 3b. the run-level surface on the card: the library API, resume,
# multi-process runs, the data-parallel split and profiled runs
API_READS = 8               # example reads through each align_* function
RESUME_LINES = 20           # lines of the -o file a resumed run starts from
# stretch reads profiled, a part of one K1 chunk (3,047 reads) and of one
# K11 chunk (232 reads): cut from whole chunks to keep the script inside
# its time limit (the traced mode-6 run took 65-91 s at 232 reads)
PROFILE_READS = {0: 1024, 6: 48}
PROFILE_KERNELS = {0: "poa_global_warp_kernel", 6: "gap67_fill_kernel"}
API_KERNELS = {"align_global_no_gap": "poa_global", "align_local_no_gap": "poa_local",
               "align_global_gap": "poa_gap_global", "align_local_gap": "poa_gap_local"}


def cpu_api_records(reads_fa, graph_gfa, n):
    """The four align_* functions on the first ``n`` reads with
    ``device="cpu"`` (a worker job): {function: [GafRecord]}."""
    from recgraph_tpu_torch import api
    from recgraph_tpu_torch.io import gfa

    t0 = time.perf_counter()
    seqs, names = read_set(reads_fa, n)
    g = gfa.parse_gfa(graph_gfa)
    recs = {fn: [getattr(api, fn)(s[1:], g, nm, device="cpu") for s, nm in zip(seqs, names)]
            for fn in API_KERNELS}
    return recs, time.perf_counter() - t0


def resumed_run(kw, partial, out):
    """The CLI's run with RECGRAPH_RESUME=1 into ``out``, which first
    holds ``partial``: (the file's text, stderr)."""
    from recgraph_tpu_torch.align.pipeline import Options, run

    with open(out, "w") as fh:
        fh.write(partial)
    err = io.StringIO()
    os.environ["RECGRAPH_RESUME"] = "1"
    try:
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
            run(Options(**kw, out_file=out))
    finally:
        del os.environ["RECGRAPH_RESUME"]
    with open(out) as fh:
        return fh.read(), err.getvalue()


def cpu_resume(kw, partial, out):
    """:func:`resumed_run` on the CPU (a worker job)."""
    t0 = time.perf_counter()
    text, _ = resumed_run(dict(kw, device="cpu"), partial, out)
    return text, time.perf_counter() - t0


def spawn_cli(args, nproc=2):
    """Start ``nproc`` processes of the port's CLI on the card, joined as
    one multi-process run (:func:`wait_cli` collects them)."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("localhost", 0))
        addr = f"localhost:{s.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=ROOT, RECGRAPH_METRICS="1")
    return [subprocess.Popen(
        [sys.executable, "-m", "recgraph_tpu_torch", "--device", "cuda", *args,
         "--num-processes", str(nproc), "--process-id", str(k), "--coordinator", addr],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(nproc)]


def wait_cli(procs, timeout=300):
    """The stderr of each process :func:`spawn_cli` started, or raise
    (every process is stopped either way)."""
    errs = []
    try:
        for k, p in enumerate(procs):
            _, se = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError(f"process {k} of {p.args} exited {p.returncode}:\n"
                                     f"{se[-3000:]}")
            errs.append(se)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return errs


def warm_worker():
    """Bring a fresh process to the card: CUDA and the kernel library."""
    import torch

    from recgraph_tpu_torch.ops import _kernels

    sys.path.insert(0, ROOT)
    _kernels.load()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()


def profiled_cli(args, prof_dir):
    """The port's CLI on the card with RECGRAPH_PROFILE=``prof_dir`` (a
    process of its own, so that no later timed run shares the profiler's
    state): (wall seconds, stdout lines, stderr, the trace's path)."""
    import torch

    from recgraph_tpu_torch import cli, metrics

    sys.path.insert(0, ROOT)
    os.environ["RECGRAPH_PROFILE"] = prof_dir
    buf, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        cli.main([*args, "--device", "cuda"])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, len(buf.getvalue().splitlines()), err.getvalue(),
            metrics.trace_path(prof_dir))


def trace_shares(path, kernel):
    """The device's busy and idle shares in a trace: the union of its
    CUDA kernel intervals over the profiled window (the first to the last
    event of any track), the kernels by time, and each phase's spans
    (``phase:<name>``, inclusive of nested phases) with the kernel time
    inside them.  Fails if the trace has no kernel event or none of
    ``kernel``."""
    import bisect

    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    kern = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events if e.get("cat") == "kernel")
    if not kern:
        raise AssertionError(f"{path}: no CUDA kernel event (no CUPTI trace of the card)")
    if not any(kernel in name for _, _, name in kern):
        raise AssertionError(f"{path}: no {kernel} event")
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    merged = []
    for a, b, _ in kern:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]
    before = [0.0]
    for a, b in merged:
        before.append(before[-1] + b - a)

    def busy_until(t):
        k = bisect.bisect_right(starts, t)
        if k == 0:
            return 0.0
        a, b = merged[k - 1]
        return before[k - 1] + min(t, b) - a

    by_kernel = Counter()
    count = Counter()
    for a, b, name in kern:
        short = name.split("(")[0].split("<")[0].replace("void ", "")
        by_kernel[short] += b - a
        count[short] += 1
    phases = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("phase:"):
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            span, busy = phases.get(e["name"][6:], (0.0, 0.0))
            phases[e["name"][6:]] = (span + b - a, busy + busy_until(b) - busy_until(a))
    busy = before[-1]
    return dict(
        window_s=(t1 - t0) / 1e6, busy_s=busy / 1e6, busy_share=busy / (t1 - t0),
        idle_share=1 - busy / (t1 - t0), kernels=len(kern),
        top=[(k, round(v / 1e3, 3), count[k]) for k, v in by_kernel.most_common(6)],
        phases={k: (round(s / 1e6, 3), round(b / 1e6, 3))
                for k, (s, b) in sorted(phases.items(), key=lambda kv: -kv[1][0])})


def cpu_trace_shares(path, kernel):
    """:func:`trace_shares` (a worker job); the trace is deleted after."""
    t0 = time.perf_counter()
    try:
        return trace_shares(path, kernel), time.perf_counter() - t0
    finally:
        os.remove(path)


def golden_text(name):
    with open(os.path.join(ROOT, "tests", "goldens", f"{name}.gaf")) as fh:
        return fh.read()


def surface(example, stretch, workdir):
    """Phase 3b: each check is exact equality and raises on a difference.
    The profiled runs' process reaches the card while the other checks
    run."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    try:
        warm = pool.submit(warm_worker)
        surface_checks(example, workdir)
        warm.result()
        profile_runs(pool, stretch, workdir)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def surface_checks(example, workdir):
    """The API, resume, multi-process runs and the data-parallel split."""
    import torch

    from recgraph_tpu_torch import api, metrics
    from recgraph_tpu_torch.align.pipeline import Options, run
    from recgraph_tpu_torch.io import gfa

    # the library API: one read a call, on the card by default
    seqs, names = read_set(example[0], API_READS)
    graph = gfa.parse_gfa(example[1])
    got = {}
    for fn, kern in API_KERNELS.items():
        got[fn] = []
        for s, nm in zip(seqs, names):
            metrics.reset_phases()
            got[fn].append(getattr(api, fn)(s[1:], graph, nm))
            shapes = [k for k in metrics.SHAPES if k[0] == kern]
            if not metrics.LAUNCHES.get(kern) or any(k[1] != 1 for k in shapes):
                raise AssertionError(f"api {fn}: {kern} not launched on one read "
                                     f"({dict(metrics.LAUNCHES)}, {shapes})")
    log(f"api: 4 functions x {API_READS} reads on the card, each call one launch of its "
        f"kernel at one read ({sorted(API_KERNELS.values())})")

    def check_api(res):
        for fn in API_KERNELS:
            for i, (a, b) in enumerate(zip(got[fn], res[fn])):
                if a != b or a.to_string() != b.to_string():
                    raise AssertionError(f"api {fn}: read {i} differs from device='cpu':\n"
                                         f"{a.to_string()}\n{b.to_string()}")

    defer("api", f"4 x {API_READS} records equal to device='cpu'", check_api, cpu_api_records,
          example[0], example[1], API_READS)

    # resume: cut an -o run after RESUME_LINES lines, resume on the card
    for mode, kern in ((0, "poa_global"), (4, "pathwise")):
        kw = dict(sequence_path=example[0], graph_path=example[1], alignment_mode=mode)
        out = os.path.join(workdir, f"resume_mode{mode}.gaf")
        if os.path.exists(out):
            os.remove(out)
        run_capture(**kw, device="cuda", out_file=out)
        with open(out) as fh:
            partial = "".join(fh.readlines()[:RESUME_LINES])
        metrics.reset_phases()
        text, err = resumed_run(dict(kw, device="cuda"), partial, out)
        if f"resuming at read {RESUME_LINES}/52" not in err or not metrics.LAUNCHES.get(kern):
            raise AssertionError(f"resume mode {mode}: {err[-500:]} {dict(metrics.LAUNCHES)}")
        if mode == 0 and text != golden_text("mode0"):
            raise AssertionError("resume mode 0: the resumed file differs from mode0.gaf")
        log(f"resume mode {mode}: resumed at read {RESUME_LINES}/52, "
            f"{len(text.splitlines())} lines" + (", byte-equal to mode0.gaf" if mode == 0 else ""))

        def check_resume(res, text=text, mode=mode):
            if res != text:
                raise AssertionError(f"resume mode {mode}: the card's file differs from the "
                                     "CPU resume")

        defer(f"resume mode {mode}", "resumed file byte-equal to the CPU resume", check_resume,
              cpu_resume, kw, partial, os.path.join(workdir, f"resume_mode{mode}_cpu.gaf"))

    # multi-process: two CLI processes share the card (the runs of modes 0
    # and 8 at once); the merged -o file is the one-process run's, which
    # the goldens fix: mode0.gaf, and mode8.gaf without read 0's line (-o
    # truncates at number 1)
    t0 = time.perf_counter()
    runs = {mode: spawn_cli(["-m", str(mode), *example, "-o",
                             os.path.join(workdir, f"mp_mode{mode}.gaf")]) for mode in (0, 8)}
    errs = {mode: wait_cli(procs) for mode, procs in runs.items()}
    wall = time.perf_counter() - t0
    for mode in (0, 8):
        want = golden_text(f"mode{mode}")
        if mode == 8:
            want = want[want.index("\n") + 1:]
        with open(os.path.join(workdir, f"mp_mode{mode}.gaf")) as fh:
            if fh.read() != want:
                raise AssertionError(f"multi-process mode {mode}: merged file differs from the "
                                     "one-process -o run (the golden)")
        log(f"multi-process mode {mode}: 2 processes on {torch.cuda.get_device_name(0)}, merged "
            f"file byte-equal to the one-process -o run (mode{mode}.gaf"
            + (" without read 0's line)" if mode == 8 else ")"))
        for se in errs[mode]:
            for ln in se.splitlines():
                if ln.startswith("recgraph-timing:") or ln.startswith("metrics:"):
                    log(f"  mode {mode} {ln}")
    log(f"multi-process: modes 0 and 8, four processes at once, {wall:.1f} s wall")

    # the data-parallel split over two devices (the one card twice)
    for mode, kern in ((1, "poa_local"), (8, "pathwise")):
        metrics.reset_phases()
        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            run(Options(*example, alignment_mode=mode, device="cuda"), ["cuda:0", "cuda:0"])
        if "data-parallel: sharding reads over 2 local devices" not in err.getvalue():
            raise AssertionError(f"data-parallel mode {mode}: no split ({err.getvalue()[-300:]})")
        if buf.getvalue() != golden_text(f"mode{mode}") or metrics.LAUNCHES.get(kern, 0) < 2:
            raise AssertionError(f"data-parallel mode {mode}: output differs from the golden or "
                                 f"launches {dict(metrics.LAUNCHES)}")
        log(f"data-parallel mode {mode}: split over cuda:0 twice, byte-equal to mode{mode}.gaf; "
            f"launches {dict(metrics.LAUNCHES)}")


def profile_runs(pool, stretch, workdir):
    """RECGRAPH_PROFILE on stretch modes 0 and 6 in ``pool``'s process;
    the traces are read on a CPU worker (deferred)."""
    seqs, names = read_set(stretch[0])
    for mode, n in PROFILE_READS.items():
        reads = os.path.join(workdir, f"profile_mode{mode}.fa")
        write_fasta(reads, seqs[:n], names[:n])
        prof = os.path.join(workdir, f"profile_mode{mode}")
        if os.path.isdir(prof):
            for f in os.listdir(prof):
                os.remove(os.path.join(prof, f))
        out = os.path.join(workdir, f"profile_mode{mode}.gaf")
        wall, n_out, err, path = pool.submit(
            profiled_cli, ["-m", str(mode), reads, stretch[1], "-o", out], prof).result()
        if "data-parallel:" in err:
            raise AssertionError(f"a CLI run split its reads: {err[-500:]}")
        if mode != 6:
            with open(out) as fh:
                n_out = len(fh.read().splitlines())
        if n_out != (2 * n if mode == 6 else n):
            raise AssertionError(f"profile mode {mode}: {n_out} lines for {n} reads")
        size = os.path.getsize(path) / 2**20
        log(f"profile stretch mode {mode}, {n} reads: wall {wall:.3f} s with the trace written, "
            f"trace {size:.1f} MiB")

        def report(sh, mode=mode, n=n):
            log(f"profile stretch mode {mode}, {n} reads: {sh['kernels']} kernel events; window "
                f"{sh['window_s']:.3f} s, device busy {sh['busy_s']:.3f} s = "
                f"{100 * sh['busy_share']:.2f} %, idle {100 * sh['idle_share']:.2f} %")
            log(f"  top kernels (name, ms, launches): {sh['top']}")
            log(f"  phases (span s, kernel s inside): {sh['phases']}")

        defer(f"profile mode {mode}", f"trace read, {PROFILE_KERNELS[mode]} in it", report,
              cpu_trace_shares, path, PROFILE_KERNELS[mode])

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    from recgraph_tpu_torch import _backend, kernel_ab, metrics
    from recgraph_tpu_torch.graph.pathgraph import PathGraph
    from recgraph_tpu_torch.ops import (
        _kernels, cuda_gap67_fill, cuda_pathwise, cuda_pathwise_rev, cuda_pathwise_rev_win,
        cuda_pathwise_win, cuda_poa_gap_global, cuda_poa_gap_global_win, cuda_poa_gap_local,
        cuda_poa_global, cuda_poa_global_win, cuda_poa_local, cuda_split_summary,
        pathwise_engine, poa_engine,
    )

    # 1. report
    rep = _backend.report()
    kind = torch.cuda.get_device_name(0)
    smi = rep["nvidia_smi"] or "not available"
    log(f"python {sys.version.split()[0]} torch {rep['torch']} cuda {rep['cuda']} "
        f"nvcc {rep['nvcc']}")
    log(f"device: {kind} (count {torch.cuda.device_count()}); nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    _kernels.load()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
        f"{_kernels.build_info.get('seconds', 0.0):.2f} s)")
    for line in _kernels.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())

    workdir = os.path.join(_kernels.BUILD_DIR, "smoke")
    os.makedirs(workdir, exist_ok=True)
    example = (os.path.join(ROOT, "example", "reads.fa"),
               os.path.join(ROOT, "example", "graph.gfa"))
    stretch = make_synth(workdir, "stretch", **STRETCH)
    many = make_synth(workdir, "many_paths", **MANY_PATHS)
    long = make_long(workdir)
    short = (cuda_poa_global, cuda_poa_local, cuda_poa_gap_global, cuda_poa_gap_local)
    rec = [cuda_pathwise.KERNEL, cuda_pathwise_rev.KERNEL, cuda_split_summary.BOUND,
           cuda_split_summary.GUIDED]
    gap = [cuda_gap67_fill.KERNEL]

    # 3. goldens through the port's pipeline on the card
    metrics.reset_phases()
    for name, cfg in GOLDENS.items():
        got = run_capture(sequence_path=example[0], graph_path=example[1],
                          device="cuda", **cfg)
        ext = "txt" if cfg["alignment_mode"] in (6, 7) else "gaf"
        with open(os.path.join(ROOT, "tests", "goldens", f"{name}.{ext}")) as fh:
            if got != fh.read():
                raise AssertionError(f"golden {name}: output differs")
        log(f"golden {name}: byte-equal")
    if not all(metrics.LAUNCHES.get(k) for k in [m.KERNEL for m in short] + rec + gap):
        raise AssertionError(f"goldens did not launch every kernel: {dict(metrics.LAUNCHES)}")
    log(f"golden launches: {dict(metrics.LAUNCHES)}")
    # a reads file with no reads: no line in any mode family, with or without -o
    empty = os.path.join(workdir, "empty.fa")
    open(empty, "w").close()
    for mode in (0, 4, 6, 8):
        out = os.path.join(workdir, f"empty_mode{mode}.gaf")
        if os.path.exists(out):
            os.remove(out)
        got = run_capture(sequence_path=empty, graph_path=example[1], device="cuda",
                          alignment_mode=mode)
        got += run_capture(sequence_path=empty, graph_path=example[1], device="cuda",
                           alignment_mode=mode, out_file=out)
        if got or (os.path.exists(out) and os.path.getsize(out)):
            raise AssertionError(f"mode {mode} wrote lines for a reads file with no reads")
    log("no reads: modes 0, 4, 6 and 8 wrote no line, with and without -o")

    # 3b. the run-level surface: API, resume, multi-process runs, the
    #     data-parallel split, profiled runs
    t0 = time.perf_counter()
    surface(example, stretch, workdir)
    log(f"surface: {time.perf_counter() - t0:.1f} s")

    # 4. stretch corpus end to end through the CLI (the CPU checks from
    #    here on are queued for worker processes that start with phase 6;
    #    the longest, the scalar oracle on long read 0, goes first)
    lseqs, lnames = read_set(long[0])
    for mode in (6, 7):
        cpu_job(cpu_gap_oracle, long[1], lseqs[0], mode)
    launches, shapes = Counter(), Counter()
    seqs, names = read_set(stretch[0])
    for mode, mod in enumerate(short):
        lines = cli_run(f"stretch mode {mode}", mode, stretch[0], stretch[1],
                        os.path.join(workdir, f"stretch_mode{mode}.gaf"), [mod.KERNEL],
                        launches, shapes)
        if len(lines) != len(seqs):
            raise AssertionError(f"stretch mode {mode}: {len(lines)} lines != {len(seqs)}")
        head, step = SAMPLE[mode]
        sample = sorted(set(range(head)) | set(range(head, len(seqs), step)))
        check_sample(f"stretch mode {mode}", mode, lines, seqs, names, sample, stretch[1],
                     workdir)
    # modes 4/5 and 8/9: -o drops read 0's line, as the reference does
    with open(os.path.join(ROOT, "tests", "goldens", "stretch_mode4_sample.gaf")) as fh:
        golden4 = fh.read().splitlines()[1:]
    for mode in (4, 5, 8, 9):
        lines = cli_run(f"stretch mode {mode}", mode, stretch[0], stretch[1],
                        os.path.join(workdir, f"stretch_mode{mode}.gaf"),
                        rec if mode > 5 else [cuda_pathwise.KERNEL], launches, shapes)
        if len(lines) != len(seqs) - 1:
            raise AssertionError(f"stretch mode {mode}: {len(lines)} lines != {len(seqs) - 1}")
        if mode == 4:
            if lines[: len(golden4)] != golden4:
                raise AssertionError("stretch mode 4: lines differ from stretch_mode4_sample.gaf")
            log(f"stretch mode 4: lines 1-{len(golden4)} byte-equal to stretch_mode4_sample.gaf")
        if mode > 5:
            log(f"stretch mode {mode}: {sum('recombination path' in ln for ln in lines)} "
                f"lines recombine; split search {dict(metrics.EVENTS)}")
        head, step = SAMPLE[mode]
        sample = sorted(set(range(1, head)) | set(range(head, len(seqs), step)))
        check_sample(f"stretch mode {mode}", mode, lines, seqs, names, sample, stretch[1],
                     workdir)
    for mode in (6, 7):
        lines = cli_run(f"stretch mode {mode}", mode, stretch[0], stretch[1],
                        os.path.join(workdir, f"stretch_mode{mode}.txt"), gap, launches, shapes)
        if len(lines) != 2 * len(seqs):
            raise AssertionError(f"stretch mode {mode}: {len(lines)} lines != {2 * len(seqs)}")
        k = GAP_SAMPLE["stretch"]
        check_sample_gap(f"stretch mode {mode}", mode, lines, seqs,
                         [0] + list(range(len(seqs) // k, len(seqs), len(seqs) // k))[: k - 1],
                         stretch[1])
    mseqs, mnames = read_set(many[0])
    lines = cli_run("many paths mode 6", 6, many[0], many[1],
                    os.path.join(workdir, "many_paths_mode6.txt"), gap, launches, shapes)
    ran = {k[5] for k in metrics.SHAPES if k[0] == cuda_gap67_fill.KERNEL}
    if len(lines) != 2 * len(mseqs) or ran != {MANY_PATHS["n_paths"]}:
        raise AssertionError(f"many paths mode 6: {len(lines)} lines, launched at P {ran}")
    check_sample_gap("many paths mode 6", 6, lines, mseqs,
                     list(range(1, len(mseqs), len(mseqs) // GAP_SAMPLE["many"])), many[1])
    for mode, kern, step in ((4, [cuda_pathwise.KERNEL], MANY_PATHS["sample_step"]),
                             (8, rec, MANY_PATHS["rec_sample_step"])):
        lines = cli_run(f"many paths mode {mode}", mode, many[0], many[1],
                        os.path.join(workdir, f"many_paths_mode{mode}.gaf"), kern, launches,
                        shapes)
        ran = {k[5] for k in metrics.SHAPES if k[0] in kern[:2]}
        if len(lines) != len(mseqs) - 1 or ran != {MANY_PATHS["n_paths"]}:
            raise AssertionError(f"many paths mode {mode}: {len(lines)} lines, launched at "
                                 f"P {ran}")
        log(f"many paths mode {mode}: {kern[:2]} ran at P = {sorted(ran)}")
        check_sample(f"many paths mode {mode}", mode, lines, mseqs, mnames,
                     list(range(1, len(mseqs), step)), many[1], workdir)

    # 5. the long corpus: modes 0/2/4 through the ladder, 1/3/5 and 8/9
    #    at full width
    n_long = load_corpus(*long, 1)[0].n
    log(f"long corpus: {len(lseqs)} reads of {min(map(len, lseqs)) - 1}-"
        f"{max(map(len, lseqs)) - 1} bp, n = {n_long}")
    for mode, mod in ((0, cuda_poa_global_win), (2, cuda_poa_gap_global_win)):
        poa_engine._long_w_hint.clear()
        lines = cli_run(f"long mode {mode}", mode, long[0], long[1],
                        os.path.join(workdir, f"long_mode{mode}.gaf"), [mod.KERNEL], launches,
                        shapes)
        if len(lines) != len(lseqs):
            raise AssertionError(f"long mode {mode}: {len(lines)} lines != {len(lseqs)}")
        rungs = sorted((k[1], k[4]) for k in metrics.SHAPES if k[0] == mod.KERNEL)
        log(f"long mode {mode}: the ladder ran (reads, W) {rungs} and settled on "
            f"W = {poa_engine._long_w_hint[(mode, n_long)]}")
        check_sample(f"long mode {mode}", mode, lines, lseqs, lnames,
                     list(range(0, len(lseqs), LONG["sample_step"])), long[1], workdir)
    # mode 4: every ladder of this run and of its CPU check starts at W 256
    pathwise_engine._pw_w_hint.clear()
    lines = cli_run("long mode 4", 4, long[0], long[1], os.path.join(workdir, "long_mode4.gaf"),
                    [cuda_pathwise_win.KERNEL], launches, shapes)
    reruns = metrics.EVENTS["pathwise_win_fullwidth"]
    if len(lines) != len(lseqs) - 1:
        raise AssertionError(f"long mode 4: {len(lines)} lines != {len(lseqs) - 1}")
    rungs = sorted((k[1], k[4]) for k in metrics.SHAPES if k[0] == cuda_pathwise_win.KERNEL)
    log(f"long mode 4: the ladder ran (reads, W) {rungs} and settled on W = "
        f"{sorted(pathwise_engine._pw_w_hint.values())}; pathwise_win_fullwidth reruns: "
        f"{reruns}")
    check_sample("long mode 4", 4, lines, lseqs, lnames,
                 list(range(1, len(lseqs), LONG["pathwise_sample_step"])), long[1], workdir)
    fw = os.path.join(workdir, "long_full_width.fa")
    write_fasta(fw, lseqs[: LONG["full_width_reads"]], lnames[: LONG["full_width_reads"]])
    fw_rec = os.path.join(workdir, "long_rec.fa")
    write_fasta(fw_rec, lseqs[: LONG["rec_reads"]], lnames[: LONG["rec_reads"]])
    for mode, mod in ((1, cuda_poa_local), (3, cuda_poa_gap_local)):
        lines = cli_run(f"long mode {mode}", mode, fw, long[1],
                        os.path.join(workdir, f"long_mode{mode}.gaf"), [mod.KERNEL], launches,
                        shapes)
        widths = {k[4] for k in metrics.SHAPES if k[0] == mod.KERNEL}
        if len(lines) != LONG["full_width_reads"] or min(widths) <= 1024:
            raise AssertionError(f"long mode {mode}: {len(lines)} lines, widths {widths}")
        log(f"long mode {mode}: {mod.KERNEL} ran at {sorted(widths)} columns")
    for mode, reads, kern, n_reads, step in (
            (5, fw, [cuda_pathwise.KERNEL], LONG["full_width_reads"], LONG["mode5_sample_step"]),
            (8, fw_rec, rec, LONG["rec_reads"], LONG["rec_sample_step"]),
            (9, fw_rec, rec, LONG["rec_reads"], LONG["rec_sample_step"])):
        lines = cli_run(f"long mode {mode}", mode, reads, long[1],
                        os.path.join(workdir, f"long_mode{mode}.gaf"), kern, launches, shapes)
        widths = {k[4] for k in metrics.SHAPES if k[0] in kern[:2]}
        if len(lines) != n_reads - 1 or min(widths) <= 1024:
            raise AssertionError(f"long mode {mode}: {len(lines)} lines, widths {widths}")
        log(f"long mode {mode}: {kern[:2]} ran at {sorted(widths)} columns")
        check_sample(f"long mode {mode}", mode, lines, lseqs, lnames,
                     list(range(1, n_reads, step)), long[1], workdir)

    # the opt-in windowed mode-8 pair on the same reads, every ladder from W 256
    pathwise_engine._pw_w_hint.clear()
    win = [cuda_pathwise_win.KERNEL, cuda_pathwise_rev_win.KERNEL, *rec[2:]]
    wshapes = Counter()
    with env(RECGRAPH_REC_WINDOW="1"):
        lines = cli_run("long mode 8 windowed", 8, fw_rec, long[1],
                        os.path.join(workdir, "long_mode8_win.gaf"), win, launches, wshapes)
    if len(lines) != LONG["rec_reads"] - 1:
        raise AssertionError(f"long mode 8 windowed: {len(lines)} lines")
    # phase 6 checks each kernel of the ladder once a width, at its most
    # reads, where no earlier run launched it at that width: the rungs'
    # other launches differ only in their reads, one block a read
    widest, seen = {}, {(k[0], *k[2:]) for k in shapes}
    for k, v in wshapes.items():
        rest = (k[0], *k[2:])
        kb, vb = widest.get(rest, (k, 0))
        widest[rest] = (k if k[1] >= kb[1] else kb, vb + v)
    shapes.update(dict(w for rest, w in widest.items() if rest not in seen))
    with open(os.path.join(workdir, "long_mode8.gaf")) as fh:
        full8 = fh.read().splitlines()
    rungs = sorted((k[0], k[1], k[4]) for k in wshapes if k[0] in win[:2])
    log(f"long mode 8 windowed: the ladder ran (kernel, reads, W) {rungs}; rescore refusals "
        f"{metrics.EVENTS['rec_win_rescore']}, full-width reruns "
        f"{metrics.EVENTS['rec_win_fullwidth']}; {sum(a != b for a, b in zip(lines, full8))} "
        f"of {len(lines)} lines differ from the full-width run")
    sample = [1, LONG["rec_reads"] // 2]
    fastas = []
    for i in sample:
        fastas.append(os.path.join(workdir, f"sample_long8_win_{i}.fa"))
        write_fasta(fastas[-1], [lseqs[i]], [lnames[i]])

    def check_win(ref, got=[lines[i - 1] for i in sample]):
        if got != ref:
            raise AssertionError(f"long mode 8 windowed: sample {sample} differs from the CPU "
                                 f"run:\n{got}\n{ref}")

    defer("long mode 8 windowed", f"reads {sample} byte-equal to the CPU run with "
          "RECGRAPH_REC_WINDOW=1", check_win, cpu_rec_window_lines, fastas, long[1])

    # 5b. RECGRAPH_SPLIT_FULL: the full column scan in place of S1
    t0 = time.perf_counter()
    with env(RECGRAPH_SPLIT_FULL="1"):
        for mode in (8, 9):
            metrics.reset_phases()
            got = run_capture(sequence_path=example[0], graph_path=example[1], device="cuda",
                              alignment_mode=mode)
            if got != golden_text(f"mode{mode}") or metrics.EVENTS["split_rounds"]:
                raise AssertionError(f"RECGRAPH_SPLIT_FULL mode {mode}: output differs from the "
                                     f"golden or S1 ran ({dict(metrics.EVENTS)})")
            log(f"RECGRAPH_SPLIT_FULL example mode {mode}: byte-equal to mode{mode}.gaf "
                f"(split {metrics.PHASES['split']:.3f} s)")
        head = os.path.join(workdir, "stretch_head348.fa")
        write_fasta(head, seqs[:348], names[:348])
        out = os.path.join(workdir, "stretch_head348_mode8_full.gaf")
        if os.path.exists(out):
            os.remove(out)
        metrics.reset_phases()
        t1 = time.perf_counter()
        run_capture(sequence_path=head, graph_path=stretch[1], device="cuda", alignment_mode=8,
                    out_file=out)
        with open(out) as fh, open(os.path.join(workdir, "stretch_mode8.gaf")) as fd:
            got, ref = fh.read().splitlines(), fd.read().splitlines()[:347]
        if got != ref or metrics.EVENTS["split_rounds"]:
            raise AssertionError("RECGRAPH_SPLIT_FULL stretch mode 8: the first 348 reads differ "
                                 "from the default run's or S1 ran")
        log(f"RECGRAPH_SPLIT_FULL stretch mode 8, 348 reads (one chunk): {len(got)} lines "
            f"byte-equal to the default run's in {time.perf_counter() - t1:.3f} s (split "
            f"{metrics.PHASES['split']:.3f} s)")
    log(f"split full: {time.perf_counter() - t0:.1f} s")

    fw_gap = os.path.join(workdir, "long_gap.fa")
    write_fasta(fw_gap, lseqs[: LONG["gap_reads"]], lnames[: LONG["gap_reads"]])
    for mode in (6, 7):
        lines = cli_run(f"long mode {mode}", mode, fw_gap, long[1],
                        os.path.join(workdir, f"long_mode{mode}.txt"), gap, launches, shapes)
        widths = {k[3] for k in metrics.SHAPES if k[0] == cuda_gap67_fill.KERNEL}
        if len(lines) != 2 * LONG["gap_reads"] or min(widths) <= 1024:
            raise AssertionError(f"long mode {mode}: {len(lines)} lines, widths {widths}")
        log(f"long mode {mode}: {cuda_gap67_fill.KERNEL} ran at {sorted(widths)} columns")

        def check(res, got=lines[:2], mode=mode):
            if got != res[1]:
                raise AssertionError(f"long mode {mode}: read 0 differs from the scalar oracle:"
                                     f"\n{got}\n{res[1]}")

        defer(f"long mode {mode}", "read 0's lines byte-equal to the scalar oracle's", check,
              cpu_gap_oracle, long[1], lseqs[0], mode)

    # 6. kernels against their plain versions at the main path's shapes,
    #    with the CPU checks on the workers beside them
    start_cpu_workers()
    t0 = time.perf_counter()
    corpora = {}
    for c in (stretch, long):
        g, reads = load_corpus(*c)
        corpora[("poa", g.n, 1)] = (g, reads)
    for c in (stretch, many, long):
        g, reads = load_corpus(*c, graph=PathGraph)
        corpora[("path", g.n, g.paths_number)] = (g, reads)
    kres = check_kernels(shapes, corpora, kernel_cases(example, long, workdir))
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    drain_cpu_checks()
    log(f"waited {time.perf_counter() - t0:.1f} s for the CPU checks")

    # 7. the kernel A/B entry point over every ported variant; its launches
    #    are K13-K17's
    t0 = time.perf_counter()
    metrics.reset_phases()
    ab = kernel_ab.run(AB_BATCH, list(kernel_ab.VARIANTS), "cuda")
    ab_launches = dict(metrics.LAUNCHES)
    bad = [name for name, r in ab.items() if not r["equal"]]
    if bad:
        raise AssertionError(f"kernel A/B: {bad} differ from their plain versions")
    log(f"kernel A/B: {len(ab)} variants equal to their plain versions in "
        f"{time.perf_counter() - t0:.1f} s; launches {ab_launches}")

    # 8. the whole run went through the port: no JAX, nothing of recgraph_tpu
    bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "recgraph_tpu"))
    if bad:
        raise AssertionError(f"JAX or recgraph_tpu modules were imported: {bad[:8]}")
    log("imports: no jax, no recgraph_tpu module")
    log(f"total: {time.perf_counter() - t_start:.1f} s")

    # 9. result
    log(smi)
    kernels = []
    for kid, r in kres.items():
        mod = r["spec"]["mod"]
        # the kernel at its most launched shape; a view (K9a, K9b) is the
        # same kernel at its shapes with that many paths
        of = r["spec"].get("launches_of", mod.KERNEL)   # K12 runs inside K11
        # K13-K17 run on the kernel A/B path
        n_launch = (ab_launches if r["spec"].get("ab") else launches).get(of, 0)
        views = [(kid, mod.KERNEL, mod.REPLACES, r["timed"], n_launch)]
        for vid, P, replaces in r["spec"].get("views", []):
            timed = [t for t in r["timed"] if t["shape"][4] == P]
            views.append((vid, f"{mod.KERNEL} (P = {P})", replaces, timed,
                          sum(t["launches"] for t in timed)))
        for vid, name, replaces, timed, n_launch in views:
            if not timed or not n_launch:
                raise AssertionError(f"{vid} {mod.KERNEL} was not launched on the main path")
            t = timed[0]
            kernels.append(dict(
                name=name, route="cuda", source=mod.SOURCE, replaces=replaces,
                launches=n_launch, max_abs_err=r["err"], ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
            ))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_cpu_workers()
