#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (recgraph_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. report   torch/CUDA versions, the card, nvidia-smi name and power limit;
2. build    compile and load the CUDA kernels (csrc/*.cu, sm_90a, one nvcc
            per source, all started together);
3. goldens  the port's pipeline on example/ for mode0, mode1, mode1_hoxd70,
            mode2 and mode3, byte-equal to tests/goldens/*.gaf;
4. stretch  the CLI on the 10,000-read stretch corpus
            (tools/make_synthetic.make(dir, 700, 10000, 42)) for -m 0..3:
            line count, a sample byte-equal to the port's CPU run on the
            same reads, reads/s, the phase breakdown and peak memory;
5. long     the CLI on 512 reads of the long corpus (the recipe of
            bench.py:78-110, written out below) for -m 0 and -m 2: the
            windows the ladder ran, reads/s, phases, a sample byte-equal
            to the CPU run; then -m 1 and -m 3 on 64 long reads at full
            width;
6. kernels  K1-K6 against their plain torch versions on the card, all
            outputs exactly equal, at every launch shape of phases 4-5
            (reads, rows, Lp, stored width, as metrics.SHAPES recorded
            them; the leading reads of that corpus), with kernel and plain
            times (CUDA events) and the bound at each; then on the example
            corpus, three seeded random graphs, HOXD70 (K2, K5),
            (o, e) = (+1, -2) (K4, K5), K1 on 64 long reads at full width
            and K3/K6 at W = 32, where reads overflow;
7. imports  no jax* and no recgraph_tpu* module was imported;
8. result   the nvidia-smi line, one JSON line with every kernel (times
            and bound at the shape it was launched at most often), and the
            last line {"ok": true, "device": {...}}.

Every launch counter is set to 0 just before each CLI run of phases 4-5
and read just after; the run fails if a kernel of its path was not
launched.  The tolerance of every comparison is exact equality: all
outputs are int32 DP values, indices and GAF bytes.  Needs CUDA, nvcc
(sm_90a) and a C++ compiler; exits nonzero without CUDA.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import random
import sys
import time
from collections import Counter

ROOT = os.path.dirname(os.path.abspath(__file__))
STRETCH = dict(n_back=700, n_reads=10000, seed=42)
LONG = dict(n_back=1200, seed=11, n_reads=512, full_width_reads=64, sample_step=64)
GOLDENS = {
    "mode0": dict(alignment_mode=0),
    "mode1": dict(alignment_mode=1),
    "mode1_hoxd70": dict(alignment_mode=1, matrix="HOXD70"),
    "mode2": dict(alignment_mode=2),
    "mode3": dict(alignment_mode=3),
}
# stretch sample checked against the CPU run: the first HEAD reads and
# every STEP-th after them (fewer for the slower affine-gap CPU fills)
SAMPLE = {0: (128, 79), 1: (128, 79), 2: (32, 313), 3: (32, 313)}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
INT32_OPS_PER_S = 33.5e12   # H100 SXM int32 issue rate (half the 67 TFLOP/s fp32 rate)
O, E = -4, -2               # the CLI's default gap penalties


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


def make_stretch(workdir):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import make_synthetic

    d = os.path.join(workdir, "stretch")
    reads = os.path.join(d, "reads.fa")
    if not os.path.exists(reads):
        with contextlib.redirect_stdout(io.StringIO()):
            make_synthetic.make(d, STRETCH["n_back"], STRETCH["n_reads"], STRETCH["seed"])
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


def load_corpus(reads_fa, graph_gfa, limit=None):
    """(PoaGraph, '$'-prefixed reads) of a corpus."""
    from recgraph_tpu_torch.graph.poagraph import PoaGraph
    from recgraph_tpu_torch.io import gfa

    return PoaGraph.from_gfa(gfa.parse_gfa(graph_gfa)), read_set(reads_fa, limit)[0]


def kernel_cases(example, long):
    """(PoaGraph, reads) of the exactness cases beside the main path's
    shapes: the example corpus, 64 long reads and three random graphs."""
    from recgraph_tpu_torch import fuzz
    from recgraph_tpu_torch.graph.poagraph import PoaGraph

    cases = {"example": load_corpus(*example),
             "long64": load_corpus(*long, LONG["full_width_reads"])}
    for seed in (101, 202, 303):
        rng = random.Random(seed)
        gf = fuzz.random_gfa(rng, n_nodes=24, n_paths=4, cover_all=True)
        reads = [fuzz.random_read(rng, gf) for _ in range(8)]
        cases[f"random{seed}"] = (PoaGraph.from_gfa(gf), reads)
    return cases


def kernel_specs():
    """Per kernel: wrapper module, plain version, the exactness cases it
    is checked on besides its main-path shapes (name, table, penalties,
    window), the planes it writes and the int32 operations per stored
    cell and predecessor."""
    from recgraph_tpu_torch.ops import (
        cuda_poa_gap_global, cuda_poa_gap_global_win, cuda_poa_gap_local, cuda_poa_global,
        cuda_poa_global_win, cuda_poa_local, poa_engine, poa_gap_engine,
    )

    none = [(c, "none", (O, E), None)
            for c in ("example", "random101", "random202", "random303")]
    win = [(c, t, oe, 32) for c, t, oe, _ in none]   # W = 32: some reads overflow
    return [
        dict(id="K1", mod=cuda_poa_global, kern=cuda_poa_global.fill_global_cuda,
             plain=poa_engine.fill_global_plain, args="global", planes=1, ops=(24, 4),
             cases=none + [("long64", "none", (O, E), None)]),
        dict(id="K2", mod=cuda_poa_local, kern=cuda_poa_local.fill_local_cuda,
             plain=poa_engine.fill_local_plain, args="local", planes=1, ops=(20, 4),
             cases=none + [("example", "HOXD70", (O, E), None)]),
        dict(id="K3", mod=cuda_poa_global_win, kern=cuda_poa_global_win.fill_global_win_cuda,
             plain=poa_engine.fill_global_windowed_plain, args="global_win", planes=1,
             ops=(26, 6), cases=win),
        dict(id="K4", mod=cuda_poa_gap_global, kern=cuda_poa_gap_global.fill_gap_global_cuda,
             plain=poa_gap_engine.fill_gap_global_plain, args="gap_global", planes=3,
             ops=(60, 8), cases=none + [("example", "none", (1, -2), None)]),
        dict(id="K5", mod=cuda_poa_gap_local, kern=cuda_poa_gap_local.fill_gap_local_cuda,
             plain=poa_gap_engine.fill_gap_local_plain, args="gap_local", planes=3,
             ops=(60, 8), cases=none + [("example", "HOXD70", (O, E), None),
                                        ("example", "none", (1, -2), None)]),
        dict(id="K6", mod=cuda_poa_gap_global_win,
             kern=cuda_poa_gap_global_win.fill_gap_global_win_cuda,
             plain=poa_gap_engine.fill_gap_global_windowed_plain, args="gap_global_win",
             planes=3, ops=(62, 10), cases=win + [("example", "none", (1, -2), 32)]),
    ]


def bound(spec, dg, seq, width, avg_preds):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    int32 operations over the int32 rate.  Bytes: each input read once
    (reads, lengths, band slack, graph arrays, table) and each output
    written once (planes at the stored width, per-row band/window arrays,
    per-read scalars).  Operations: per stored cell, a fixed count for
    the recurrence plus a count per predecessor, at this graph's mean
    predecessors per row."""
    B, Lp = seq.shape
    n = dg.n
    cells = B * n * width
    inputs = 4 * (B * Lp + 2 * B + n * (4 + dg.max_preds) + 49)
    per_row = {"global": 2, "global_win": 3, "gap_global": 2, "gap_global_win": 3}
    outputs = 4 * (spec["planes"] * cells + per_row.get(spec["args"], 0) * B * n + 3 * B)
    if spec["args"].endswith("win"):
        outputs += B                                   # the over flags
    t_bytes = (inputs + outputs) / HBM_BYTES_PER_S * 1e3
    c0, c1 = spec["ops"]
    t_ops = cells * (c0 + c1 * avg_preds) / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_case(spec, label, g, reads, matrix, o, e, W, pad_to=None, timed=False):
    """One kernel call against its plain version on the same inputs;
    returns (max_abs_err, timing or None)."""
    import torch

    from recgraph_tpu_torch.ops.encode import encode_read_aux, encode_reads, poa_device_graph
    from recgraph_tpu_torch.scoring import ScoreMatrix

    dg = poa_device_graph(g, "cuda")
    table = torch.as_tensor(ScoreMatrix.create(matrix, 2, -4).table, dtype=torch.int32).cuda()
    seq, L = encode_reads(reads, pad_to=pad_to, device="cuda")
    bta = encode_read_aux([int(1 + 0.01 * len(s)) for s in reads], "cuda")
    args = {
        "global": (dg, table, seq, L, bta),
        "local": (dg, table, seq, L),
        "global_win": (dg, table, seq, L, bta, W),
        "gap_global": (dg, table, seq, L, bta, o, e),
        "gap_local": (dg, table, seq, L, o, e),
        "gap_global_win": (dg, table, seq, L, bta, o, e, W),
    }[spec["args"]]
    windowed = spec["args"].endswith("win")
    got = spec["kern"](*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = spec["plain"](*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    B, Lp = seq.shape
    err = compare(f"{spec['id']} {label} {matrix} o={o} e={e}", got, ref)
    over = f" W={W} over={int(got[-1].sum())}/{B}" if windowed else ""
    log(f"{spec['id']} {spec['mod'].KERNEL} {label} ({matrix}, o={o}, e={e}): B={B} "
        f"n={dg.n} Lp={Lp} Pm={dg.max_preds}{over} exact (max_abs_err {err})")
    if not timed:
        return err, None
    del got, ref
    width = W if windowed else Lp
    ms = cuda_ms(lambda: spec["kern"](*args), 5)
    bound_ms, bound_by = bound(spec, dg, seq, width, float(dg.pred_mask.sum()) / dg.n)
    log(f"{spec['id']} time at B={B} n={dg.n} Lp={Lp} W={width}: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{100 * bound_ms / ms:.2f} % of bound")
    return err, dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def check_kernels(shapes, corpora, cases):
    """Every kernel against its plain version at each shape the main path
    launched it at (``shapes``: metrics.SHAPES keys -> launches, inputs
    the leading reads of the corpus with that many rows), timed there,
    and on its exactness cases.  A kernel's result carries the times and
    bound of the shape it was launched at most often."""
    results = {}
    for spec in kernel_specs():
        kernel, err, main = spec["mod"].KERNEL, 0, None
        ours = sorted(((k[1:], v) for k, v in shapes.items() if k[0] == kernel),
                      key=lambda kv: (-kv[1], -kv[0][0] * kv[0][3]))
        if not ours:
            raise AssertionError(f"{spec['id']} {kernel} has no main-path launch")
        for (B, n, Lp, W), launches in ours:
            g, reads = corpora[n]
            e_, timing = check_case(spec, f"main path x{launches}", g, reads[:B], "none",
                                    O, E, W, pad_to=Lp, timed=True)
            err = max(err, e_)
            main = main or dict(timing, shape=(B, n, Lp, W))
        for name, matrix, (o, e), W in spec["cases"]:
            err = max(err, check_case(spec, name, *cases[name], matrix, o, e, W)[0])
        results[spec["id"]] = dict(spec=spec, err=err, **main)
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
    every kernel in ``expect`` launched."""
    import torch

    from recgraph_tpu_torch import cli, metrics

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics.reset_phases()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        cli.main(["-m", str(mode), reads_fa, graph_gfa, "-o", out, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(metrics.LAUNCHES)
    got_shapes = dict(metrics.SHAPES)
    phases = metrics.phases_dict()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k in expect:
        if not got.get(k):
            raise AssertionError(f"{tag}: kernel {k} was not launched ({got})")
    launches.update(got)
    shapes.update(got_shapes)
    with open(out) as fh:
        lines = fh.read().splitlines()
    log(f"{tag}: {len(lines)} reads in {wall:.3f} s = {len(lines) / wall:.1f} reads/s; "
        f"launches {got}; peak device memory {peak:.2f} GiB")
    log(f"{tag} launch shapes (kernel, reads, rows, Lp, width): {got_shapes}")
    log(f"{tag} phases: " + json.dumps(
        {k: round(v, 4) for k, v in sorted(phases.items(), key=lambda kv: -kv[1])}))
    return lines


def check_sample(tag, mode, lines, seqs, names, sample, graph_gfa, workdir):
    """The sampled reads' GAF lines equal the port's CPU run on them."""
    sample_fa = os.path.join(workdir, f"sample_{tag.replace(' ', '_')}.fa")
    write_fasta(sample_fa, [seqs[i] for i in sample], [names[i] for i in sample])
    t0 = time.perf_counter()
    ref = run_capture(sequence_path=sample_fa, graph_path=graph_gfa,
                      alignment_mode=mode, device="cpu").splitlines()
    got = [lines[i] for i in sample]
    if got != ref:
        bad = next(k for k, (a, b) in enumerate(zip(got + [""], ref + [""])) if a != b)
        raise AssertionError(f"{tag}: sample read {sample[bad]} differs from the CPU "
                             f"run:\n{got[bad] if bad < len(got) else None}\n"
                             f"{ref[bad] if bad < len(ref) else None}")
    log(f"{tag}: {len(sample)}-read sample byte-equal to the CPU run "
        f"({time.perf_counter() - t0:.1f} s)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    from recgraph_tpu_torch import _backend, metrics
    from recgraph_tpu_torch.ops import (
        _kernels, cuda_poa_gap_global, cuda_poa_gap_global_win, cuda_poa_gap_local,
        cuda_poa_global, cuda_poa_global_win, cuda_poa_local, poa_engine,
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
    stretch = make_stretch(workdir)
    long = make_long(workdir)

    # 3. goldens through the port's pipeline on the card
    metrics.reset_phases()
    for name, cfg in GOLDENS.items():
        got = run_capture(sequence_path=example[0], graph_path=example[1],
                          device="cuda", **cfg)
        with open(os.path.join(ROOT, "tests", "goldens", f"{name}.gaf")) as fh:
            if got != fh.read():
                raise AssertionError(f"golden {name}: output differs")
        log(f"golden {name}: byte-equal")
    short = (cuda_poa_global, cuda_poa_local, cuda_poa_gap_global, cuda_poa_gap_local)
    if not all(metrics.LAUNCHES.get(m.KERNEL) for m in short):
        raise AssertionError(f"goldens did not launch every kernel: {dict(metrics.LAUNCHES)}")
    log(f"golden launches: {dict(metrics.LAUNCHES)}")

    # 4. stretch corpus end to end through the CLI
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

    # 5. the long corpus: modes 0/2 through the ladder, 1/3 at full width
    lseqs, lnames = read_set(long[0])
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
    fw = os.path.join(workdir, "long_full_width.fa")
    write_fasta(fw, lseqs[: LONG["full_width_reads"]], lnames[: LONG["full_width_reads"]])
    for mode, mod in ((1, cuda_poa_local), (3, cuda_poa_gap_local)):
        lines = cli_run(f"long mode {mode}", mode, fw, long[1],
                        os.path.join(workdir, f"long_mode{mode}.gaf"), [mod.KERNEL], launches,
                        shapes)
        widths = {k[4] for k in metrics.SHAPES if k[0] == mod.KERNEL}
        if len(lines) != LONG["full_width_reads"] or min(widths) <= 1024:
            raise AssertionError(f"long mode {mode}: {len(lines)} lines, widths {widths}")
        log(f"long mode {mode}: {mod.KERNEL} ran at {sorted(widths)} columns")

    # 6. kernels against their plain versions at the main path's shapes
    t0 = time.perf_counter()
    corpora = {g.n: (g, reads) for g, reads in (load_corpus(*stretch), load_corpus(*long))}
    kres = check_kernels(shapes, corpora, kernel_cases(example, long))
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")

    # 7. the whole run went through the port: no JAX, nothing of recgraph_tpu
    bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "recgraph_tpu"))
    if bad:
        raise AssertionError(f"JAX or recgraph_tpu modules were imported: {bad[:8]}")
    log("imports: no jax, no recgraph_tpu module")
    log(f"total: {time.perf_counter() - t_start:.1f} s")

    # 8. result
    log(smi)
    kernels = []
    for kid, r in kres.items():
        mod = r["spec"]["mod"]
        kernels.append(dict(
            name=mod.KERNEL, route="cuda", source=mod.SOURCE, replaces=mod.REPLACES,
            launches=launches.get(mod.KERNEL, 0), max_abs_err=r["err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None,
        ))
        if not kernels[-1]["launches"]:
            raise AssertionError(f"{kid} {mod.KERNEL} was not launched on the main path")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
