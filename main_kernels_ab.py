#!/usr/bin/env python3
"""Time the main path's mode-0/1 kernels (K1, K2) in several checkouts, in turns, on one GPU.

    python3 main_kernels_ab.py ROOT [ROOT ...]

For each ROOT in the order given (e.g. parent, change, change, parent),
a fresh process imports that checkout's ``recgraph_tpu_torch`` (building
its kernels), makes the stretch corpus (``tools/make_synthetic.make(d,
700, 10000, 42)``, n = 2,249) and times ``poa_engine.fill_global_best``
(K1) and ``fill_local_best`` (K2) on its first 3,047 reads (Lp = 152,
the smoke's most launched shape) with CUDA events: one warm-up, then
the mean of 3 launches, repeated 5 times.  Prints one JSON line per
ROOT and the card's ``nvidia-smi`` name and power limit.  Compare two
checkouts only within one run.  Needs CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r'''
import contextlib, io, json, os, sys, tempfile
root = sys.argv[1]
sys.path.insert(0, root)
sys.path.insert(0, os.path.join(root, "tools"))
import torch
import make_synthetic
from recgraph_tpu_torch.graph.poagraph import PoaGraph
from recgraph_tpu_torch.io import fasta, gfa
from recgraph_tpu_torch.ops import poa_engine
from recgraph_tpu_torch.ops.encode import encode_read_aux, encode_reads, poa_device_graph
from recgraph_tpu_torch.scoring import ScoreMatrix

d = tempfile.mkdtemp(dir=os.environ.get("AB_WORKDIR"))
with contextlib.redirect_stdout(io.StringIO()):
    make_synthetic.make(d, 700, 10000, 42)
seqs, _ = fasta.get_sequences(os.path.join(d, "reads.fa"))
reads = seqs[:3047]
g = PoaGraph.from_gfa(gfa.parse_gfa(os.path.join(d, "graph.gfa")))
dg = poa_device_graph(g, "cuda")
table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table, dtype=torch.int32).cuda()
seq, L = encode_reads(reads, device="cuda")
bta = encode_read_aux([int(1 + 0.01 * len(s)) for s in reads], "cuda")
fills = {"K1": lambda: poa_engine.fill_global_best(dg, table, seq, L, bta),
         "K2": lambda: poa_engine.fill_local_best(dg, table, seq, L)}
out = {"root": root, "B": seq.shape[0], "n": dg.n, "Lp": seq.shape[1]}
for name, fn in fills.items():
    fn()
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(3):
            fn()
        t1.record()
        torch.cuda.synchronize()
        runs.append(t0.elapsed_time(t1) / 3)
    out[name] = runs
print(json.dumps(out), flush=True)
'''


def main(roots) -> int:
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from recgraph_tpu_torch import _backend

    print(_backend.nvidia_smi_line() or "nvidia-smi: not available", flush=True)
    for root in roots:
        res = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(root)],
                             capture_output=True, text=True)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
