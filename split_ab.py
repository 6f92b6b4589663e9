#!/usr/bin/env python3
"""Time the data-parallel read split against the one-device run.

    python3 split_ab.py [--modes 0,1,4,8] [--devices 2,4] [--reads 10000]

On a host with several GPUs, one process runs the port's pipeline
(``align.pipeline.run``) on the stretch corpus of ``chip_smoke.py``
(``tools/make_synthetic.make(d, 700, 10000, 42)``) with ``-o``, for
each mode: on ``cuda:0`` alone and split over the first N GPUs
(``pipeline.run(opts, devices)``, ``parallel.mesh.split_map``), in the
order one, split N..., split ...N, one, after one warm-up run a device
count.  Each run's wall (from
the call to its return, the devices synchronised) and phases are
printed as a JSON line, and every run's file must be byte-equal to the
first one-device run's.  The GPUs' names and power limits come first;
the log is also written to ``chiprun_out/split_ab.log``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
LOG = []


def log(*parts):
    line = " ".join(str(p) for p in parts)
    print(line, flush=True)
    LOG.append(line)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", default="0,1,4,8")
    ap.add_argument("--devices", default="2,4")
    ap.add_argument("--reads", type=int, default=10000)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("split_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from recgraph_tpu_torch import metrics
    from recgraph_tpu_torch.align.pipeline import Options, run
    from recgraph_tpu_torch.ops import _kernels

    counts = [int(k) for k in args.devices.split(",")]
    have = torch.cuda.device_count()
    if max(counts) > have:
        print(f"split_ab: {max(counts)} GPUs asked, {have} visible", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    log(f"torch {torch.__version__}, {have} GPUs: {smi}")
    _kernels.load()
    work = os.path.join(_kernels.BUILD_DIR, "split_ab")
    os.makedirs(work, exist_ok=True)
    reads, graph = chip_smoke.make_synth(work, "stretch", n_back=700, n_reads=10000, seed=42)
    if args.reads < 10000:
        seqs, names = chip_smoke.read_set(reads, args.reads)
        reads = os.path.join(work, f"stretch_{args.reads}.fa")
        chip_smoke.write_fasta(reads, seqs, names)

    def timed(mode, n, reads_fa, out):
        devices = [f"cuda:{k}" for k in range(n)]
        if os.path.exists(out):
            os.remove(out)
        metrics.reset_phases()
        for d in devices:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            run(Options(reads_fa, graph, out_file=out, alignment_mode=mode, device="cuda"),
                devices)
        for d in devices:
            torch.cuda.synchronize(d)
        wall = time.perf_counter() - t0
        with open(out, "rb") as fh:
            return wall, fh.read()

    # warm-up: every device's first use (context, library, allocator)
    few = os.path.join(work, "warm.fa")
    seqs, names = chip_smoke.read_set(reads, 64)
    chip_smoke.write_fasta(few, seqs, names)
    for mode in (int(m) for m in args.modes.split(",")):
        for n in [1, *counts]:
            timed(mode, n, few, os.path.join(work, "warm.gaf"))

    ok = True
    for mode in (int(m) for m in args.modes.split(",")):
        order = [1, *counts, *reversed(counts), 1]
        ref = None
        for n in order:
            wall, text = timed(mode, n, reads, os.path.join(work, f"mode{mode}_{n}.gaf"))
            ref = text if ref is None else ref
            same = text == ref
            ok &= same
            log(json.dumps(dict(mode=mode, devices=n, reads=args.reads, wall_s=wall,
                                byte_equal=same, lines=text.count(b"\n"),
                                launches=dict(metrics.LAUNCHES),
                                phases={k: round(v, 4) for k, v in metrics.PHASES.most_common()})))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "split_ab.log"), "w") as fh:
        fh.write("\n".join(LOG) + "\n")
    log("split_ab:", "every run byte-equal to the one-device run" if ok else "OUTPUTS DIFFER")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
