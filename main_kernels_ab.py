#!/usr/bin/env python3
"""Time main-path kernels in several checkouts, in turns, on one GPU.

    python3 main_kernels_ab.py ROOT [ROOT ...]

For each ROOT in the order given (e.g. parent, change, change, parent),
a fresh process imports that checkout's ``recgraph_tpu_torch`` (building
its kernels) and times with CUDA events, one warm-up first:

- K1 (``poa_engine.fill_global_best``) and K2 (``fill_local_best``) on
  the first 3,047 reads of the stretch corpus (``tools/make_synthetic.
  make(d, 700, 10000, 42)``, n = 2,249, Lp = 152): the mean of 3
  launches, repeated 5 times, with a checksum of the outputs; K1 and K2
  also on the first 859 stretch reads, K2 on the first 64 long reads at
  full width, and K4 (``cuda_poa_gap_global.fill_gap_global_cuda``, mode
  2 with the CLI's o = -4, e = -2 and band slack) on the first 1,241 and
  72 stretch reads: the mean of 3 launches, repeated 3 times, and a
  checksum;
- K14 (``cuda_poa_variants.fill_global_v1_cuda``) at K1's stretch shapes,
  859 and 3,047 reads, and on the kernel A/B's batch (``kernel_ab.corpus``:
  the example reads repeated to 3,047, n = 1,331): the mean of 3
  launches, repeated 3 times, and a checksum;
- K13 (``fill_local_v1_cuda``), K15 (``fill_local_v2_cuda`` at int32),
  K16 (``fill_local_scores_cuda``) and K17 (``fill_local_v4_cuda``) at
  K2's shapes (859 and 3,047 stretch reads, 64 long reads), and K2, K13,
  K15 at int32 and int16, K16 and K17 on the kernel A/B's batch: the mean
  of 3 launches, repeated 3 times, a checksum, and the bound
  (``chip_smoke.bound``: bytes over 3.35 TB/s or int32 operations over
  33.5 TOP/s, computed from the outputs of the checkout's own call);
- K5's clamped chain on the first 46 long reads at the CLI's
  -O 100000 -E 1 (a checkout whose wrapper refuses these penalties
  records the refusal), K6 (``cuda_poa_gap_global_win.
  fill_gap_global_win_cuda``) on the first 437 long reads at W = 256 and
  on the first 219 and 75 at W = 512, and K3 (``cuda_poa_global_win.
  fill_global_win_cuda``) on the 512 long reads at W = 256 and 512: the
  mean of 3 launches, repeated 3 times, and a checksum;
- K5 (``cuda_poa_gap_local.fill_gap_local_cuda``, mode 3 with the CLI's
  o = -4, e = -2) on the first 1,241 stretch reads and on the first 46
  reads of the long corpus (``chip_smoke.make_long``, n = 3,798, Lp =
  2,440, full width), and K10 (``cuda_pathwise_win.fill_pathwise_win_cuda``,
  W = 256) on the first 110 and 72 long reads (P = 10): the smoke's
  launch shapes; the mean of 3 launches, repeated 3 times, and a
  checksum of the outputs (equal across checkouts);
- K7 (``cuda_pathwise.fill_pathwise_cuda``) and K8
  (``cuda_pathwise_rev.fill_pathwise_rev_cuda``) at the pathwise launch
  shapes of ``chip_smoke.py``: 348 stretch reads (P = 9; K7 in modes 4
  and 5, K8 in mode 8), 24 reads of the 128-path corpus (K7 mode 4, K8
  mode 8) and 49 (K7 mode 4), and 11 long reads (P = 10, Lp = 2,440;
  K7 mode 4, K8 mode 8): the mean of 3 launches, repeated 3 times;
- K11 (``cuda_gap67_fill.fill_gap67_cuda``, mode 6) at the modes-6/7
  launch shapes of ``chip_smoke.py``: 232 stretch reads (P = 9), 16
  reads of the 128-path corpus (``make(d, 700, 512, 42, n_paths=128)``)
  and 7 long reads (``chip_smoke.make_long``, n = 3,798, P = 10, Lp =
  2,432): the mean of 2 launches, repeated 3 times;
- the split search of modes 8/9 on one chunk (``recombination_engine.
  split_search_best``, S1's guided entry, where the checkout has it,
  else ``_run_split_guided``'s host rounds of S1 as the main path ran
  them), on K7/K8 planes built once per checkout and mode, at the
  smoke's recombination chunk shapes: 348 stretch reads (modes 8 and
  9), 24 reads of the 128-path corpus (mode 8) and 11 long reads (modes
  8 and 9): the wall of the whole search (``torch.cuda.synchronize``
  on both sides) and its span in CUDA events, one warm-up, 3 runs, with
  the pairs and rounds a run took and a digest of the seven outputs
  (equal across checkouts);
- K12 alone (``cuda_gap67_hardrow``) at those three shapes, on the
  staged inputs of the first hard row and of the hard row with the most
  blocks (the rows ``chip_smoke.py`` checks), its inputs laid out on the
  card beforehand and left out of the time: through ``prepare`` and
  ``launch`` where the checkout has them, else the device-side layout
  of the older wrapper, which laid its inputs out on every call: the
  mean of 3 launches, repeated 5 times.

Prints one JSON line per ROOT (with the ptxas registers and spill
stores of the K1 (with K3 and K14), K2, K4 (with K6) and K5 kernels that
checkout built)
and the card's ``nvidia-smi`` name and power limit.  Compare two checkouts only within
one run.  Needs CUDA.
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


def timed(fn, reps, runs):
    fn()
    ms = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1) / reps)
    return ms


for name, fn in fills.items():
    out[name] = timed(fn, 3, 5)


def checksum(res):
    """A position-weighted int64 sum of every output, on the card."""
    tot = 0
    for t in res:
        flat = t.reshape(-1)
        for a in range(0, flat.numel(), 1 << 26):
            x = flat[a:a + (1 << 26)].to(torch.int64)
            w = torch.arange(a, a + x.numel(), device=x.device, dtype=torch.int64) % 1000003 + 1
            tot = (tot * 31 + int((x * w).sum())) % (1 << 61)
    return tot


from recgraph_tpu_torch.ops import cuda_poa_gap_local, cuda_pathwise_win

for name, fn in fills.items():
    out[name + " checksum"] = checksum(fn())
seq5, L5 = seq[:1241].contiguous(), L[:1241].contiguous()
k5 = lambda: cuda_poa_gap_local.fill_gap_local_cuda(dg, table, seq5, L5, -4, -2)
out["K5 stretch 1241"] = timed(k5, 3, 3)
out["K5 stretch 1241 checksum"] = checksum(k5())
del seq5, L5
torch.cuda.empty_cache()

from recgraph_tpu_torch.ops import cuda_poa_gap_global, cuda_poa_gap_global_win, cuda_poa_local

for B in (1241, 72):   # K4 at the stretch chunk shapes of mode 2
    sB, LB, bB = seq[:B].contiguous(), L[:B].contiguous(), bta[:B].contiguous()
    k4 = lambda: cuda_poa_gap_global.fill_gap_global_cuda(dg, table, sB, LB, bB, -4, -2)
    out[f"K4 stretch {B}"] = timed(k4, 3, 3)
    out[f"K4 stretch {B} checksum"] = checksum(k4())
    del sB, LB, bB
    torch.cuda.empty_cache()
sB, LB = seq[:859].contiguous(), L[:859].contiguous()   # K2 at the last stretch chunk's shape
bB = bta[:859].contiguous()
k2 = lambda: cuda_poa_local.fill_local_cuda(dg, table, sB, LB)
out["K2 stretch 859"] = timed(k2, 3, 3)
out["K2 stretch 859 checksum"] = checksum(k2())
k1 = lambda: poa_engine.fill_global_best(dg, table, sB, LB, bB)   # K1 at the same shape
out["K1 stretch 859"] = timed(k1, 3, 3)
out["K1 stretch 859 checksum"] = checksum(k1())
from types import SimpleNamespace

import chip_smoke
from recgraph_tpu_torch import kernel_ab
from recgraph_tpu_torch.ops import cuda_poa_variants as cv

for B, (sK, LK, bK) in ((859, (sB, LB, bB)), (3047, (seq, L, bta))):   # K14 at K1's shapes
    k14 = lambda: cv.fill_global_v1_cuda(dg, table, sK, LK, bK)
    out[f"K14 stretch {B}"] = timed(k14, 3, 3)
    out[f"K14 stretch {B} checksum"] = checksum(k14())
    torch.cuda.empty_cache()


def local_ab(key, dg_, seq_, L_, dtypes=(torch.int32,)):
    """K13, K15 (at each of ``dtypes``), K16 and K17 on one batch: times,
    checksum and bound (the smoke's, from this call's outputs)."""
    spec = dict(graph="poa", ops=(20, 4), args=lambda x: (x.dg, x.table, x.seq, x.L))
    x = SimpleNamespace(dg=dg_, table=table, seq=seq_, L=L_, W=seq_.shape[1])
    fns = [("K13", lambda: cv.fill_local_v1_cuda(dg_, table, seq_, L_))]
    for dt in dtypes:
        fns.append(("K15" + (" int16" if dt == torch.int16 else ""),
                    lambda dt=dt: cv.fill_local_v2_cuda(dg_, table, seq_, L_, dt)))
    fns += [("K16", lambda: cv.fill_local_scores_cuda(dg_, table, seq_, L_)),
            ("K17", lambda: cv.fill_local_v4_cuda(dg_, table, seq_, L_))]
    for name, fn in fns:
        out[f"{name} {key}"] = timed(fn, 3, 3)
        got = fn()
        out[f"{name} {key} checksum"] = checksum(got)
        out[f"{name} {key} bound ms"] = chip_smoke.bound(spec, x, got)[0]
        del got
        torch.cuda.empty_cache()


for B, (sK, LK) in ((859, (sB, LB)), (3047, (seq, L))):   # K13, K15-K17 at K2's shapes
    local_ab(f"stretch {B}", dg, sK, LK)
ex = kernel_ab.corpus(3047, "cuda")   # the kernel A/B's K14 (variant g1), K2, K13, K15-K17
k14 = lambda: cv.fill_global_v1_cuda(*ex)
out["K14 example 3047"] = timed(k14, 3, 3)
out["K14 example 3047 checksum"] = checksum(k14())
k2 = lambda: cuda_poa_local.fill_local_cuda(*ex[:4])
out["K2 example 3047"] = timed(k2, 3, 3)
out["K2 example 3047 checksum"] = checksum(k2())
local_ab("example 3047", ex[0], ex[2], ex[3], dtypes=(torch.int32, torch.int16))
del dg, seq, L, bta, fills, sB, LB, bB, sK, LK, bK, ex, k14, k2
torch.cuda.empty_cache()

from recgraph_tpu_torch.ops import _kernels
ptxas, entry = {}, None
with open(_kernels.library_path()[:-3] + ".log") as fh:   # -Xptxas -v of this checkout's build
    for ln in fh:
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
            entry = entry if any(k in entry for k in (
                "poa_gap_global_kernel", "poa_local_kernel", "poa_gap_local_kernel",
                "poa_global_warp_kernel")) else None
        elif entry and "spill stores" in ln:
            spill = ln.split("bytes spill stores")[0].split(",")[-1].strip()
        elif entry and "Used" in ln and "registers" in ln:
            ptxas[entry] = [int(ln.split("Used")[1].split()[0]), int(spill)]
            entry = None
out["ptxas registers, spill stores"] = ptxas

from recgraph_tpu_torch.graph.pathgraph import PathGraph
from recgraph_tpu_torch.ops import (
    _kernels, cuda_gap67_fill, cuda_gap67_hardrow, cuda_pathwise, cuda_pathwise_rev,
    pathwise_gap_engine,
)
from recgraph_tpu_torch.ops.encode import path_device_graph, rev_device_graph

d2 = tempfile.mkdtemp(dir=os.environ.get("AB_WORKDIR"))
with contextlib.redirect_stdout(io.StringIO()):
    make_synthetic.make(d2, 700, 512, 42, 128)
long_fa, long_gfa = chip_smoke.make_long(tempfile.mkdtemp(dir=os.environ.get("AB_WORKDIR")))

# K5 on 46 long reads at full width, K10 on 110 and 72 long reads at W 256
long_reads = fasta.get_sequences(long_fa)[0]
dg = poa_device_graph(PoaGraph.from_gfa(gfa.parse_gfa(long_gfa)), "cuda")
seq, L = encode_reads(long_reads[:46], pad_to=2440, device="cuda")
k5 = lambda: cuda_poa_gap_local.fill_gap_local_cuda(dg, table, seq, L, -4, -2)
out["K5 long 46"] = timed(k5, 3, 3)
out["K5 long 46 checksum"] = checksum(k5())
out["K5 long 46 shape"] = [seq.shape[0], dg.n, seq.shape[1]]
k5c = lambda: cuda_poa_gap_local.fill_gap_local_cuda(dg, table, seq, L, -100000, -1)
try:   # the clamped chain: (|o| + |e|) x Lp past 2^27
    out["K5 clamped long 46 O100000 E1"] = timed(k5c, 3, 3)
    out["K5 clamped long 46 O100000 E1 checksum"] = checksum(k5c())
except ValueError as exc:
    out["K5 clamped long 46 O100000 E1"] = f"refused: {exc}"
seq_l, L_l = encode_reads(long_reads[:64], pad_to=2440, device="cuda")
k2 = lambda: cuda_poa_local.fill_local_cuda(dg, table, seq_l, L_l)
out["K2 long 64"] = timed(k2, 3, 3)
out["K2 long 64 checksum"] = checksum(k2())
local_ab("long 64", dg, seq_l, L_l)
seq_w, L_w = encode_reads(long_reads[:437], pad_to=2440, device="cuda")
bta_w = encode_read_aux([int(1 + 0.01 * len(s)) for s in long_reads[:437]], "cuda")
k6 = lambda: cuda_poa_gap_global_win.fill_gap_global_win_cuda(dg, table, seq_w, L_w, bta_w,
                                                              -4, -2, 256)
out["K6 long 437 W256"] = timed(k6, 3, 3)
out["K6 long 437 W256 checksum"] = checksum(k6())
del seq_w, L_w, bta_w
for B in (219, 75):   # K6 at the W 512 rung's chunk shapes
    seq_w, L_w = encode_reads(long_reads[:B], pad_to=2440, device="cuda")
    bta_w = encode_read_aux([int(1 + 0.01 * len(s)) for s in long_reads[:B]], "cuda")
    k6 = lambda: cuda_poa_gap_global_win.fill_gap_global_win_cuda(dg, table, seq_w, L_w, bta_w,
                                                                  -4, -2, 512)
    out[f"K6 long {B} W512"] = timed(k6, 3, 3)
    out[f"K6 long {B} W512 checksum"] = checksum(k6())
    del seq_w, L_w, bta_w
    torch.cuda.empty_cache()
from recgraph_tpu_torch.ops import cuda_poa_global_win

seq_w, L_w = encode_reads(long_reads[:512], pad_to=2440, device="cuda")
bta_w = encode_read_aux([int(1 + 0.01 * len(s)) for s in long_reads[:512]], "cuda")
for W in (256, 512):   # K3 at the mode-0 ladder's rungs
    k3 = lambda: cuda_poa_global_win.fill_global_win_cuda(dg, table, seq_w, L_w, bta_w, W)
    out[f"K3 long 512 W{W}"] = timed(k3, 3, 3)
    out[f"K3 long 512 W{W} checksum"] = checksum(k3())
    torch.cuda.empty_cache()
del dg, seq, L, seq_l, L_l, seq_w, L_w, bta_w
torch.cuda.empty_cache()
from recgraph_tpu_torch.graph.pathgraph import PathGraph
from recgraph_tpu_torch.ops import pathwise_window
from recgraph_tpu_torch.ops.encode import path_device_graph

dg = path_device_graph(PathGraph.from_gfa(gfa.parse_gfa(long_gfa)), "cuda")
rmin = pathwise_window.rmin_tensor(dg)
seq_all, L_all = encode_reads(long_reads, pad_to=2440, device="cuda")
for B in (110, 72):
    seq, L = seq_all[:B].contiguous(), L_all[:B].contiguous()
    k10 = lambda: cuda_pathwise_win.fill_pathwise_win_cuda(dg, table, seq, L, 256, rmin)
    out[f"K10 long {B} W256"] = timed(k10, 3, 3)
    out[f"K10 long {B} W256 checksum"] = checksum(k10())
    out[f"K10 long {B} W256 shape"] = [B, dg.n, seq.shape[1], dg.paths_number]
    del seq, L
    torch.cuda.empty_cache()
del dg, seq_all, L_all

# K7 (modes 4/5) and K8 (mode 8) at the smoke's pathwise launch shapes
for tag, gfa_path, fa, B, kerns in (
        ("stretch", os.path.join(d, "graph.gfa"), os.path.join(d, "reads.fa"), 348,
         ("K7 m4", "K7 m5", "K8 m8")),
        ("128 paths", os.path.join(d2, "graph.gfa"), os.path.join(d2, "reads.fa"), 24,
         ("K7 m4", "K8 m8")),
        ("128 paths", os.path.join(d2, "graph.gfa"), os.path.join(d2, "reads.fa"), 49,
         ("K7 m4",)),
        ("long", long_gfa, long_fa, 11, ("K7 m4", "K8 m8"))):
    g = PathGraph.from_gfa(gfa.parse_gfa(gfa_path))
    dg, dgr = path_device_graph(g, "cuda"), rev_device_graph(g.reverse(), "cuda")
    seq, L = encode_reads(fasta.get_sequences(fa)[0][:B], device="cuda")
    for k in kerns:
        if k.startswith("K7"):
            fn = lambda: cuda_pathwise.fill_pathwise_cuda(dg, table, seq, k == "K7 m5")
        else:
            fn = lambda: cuda_pathwise_rev.fill_pathwise_rev_cuda(dgr, table, seq, L, True)
        out[f"{k} {tag} {B}"] = timed(fn, 3, 3)
    out[f"pathwise {tag} {B} shape"] = [B, g.n, seq.shape[1], g.paths_number]
    del dg, dgr, seq, L
    torch.cuda.empty_cache()

# the split search of modes 8/9 on one chunk at the smoke's recombination
# chunk shapes (the CLI's costs: R 4, r 0.1, no band): S1's guided entry
# through split_search_best where the checkout has it, else the host
# rounds of S1's per-pair entry as the main path ran them
import hashlib
import time

import numpy as np
from recgraph_tpu_torch import metrics
from recgraph_tpu_torch.ops import pathwise_engine, recombination_engine as rec


def split_fn(inputs, geom, geom_t, active, init):
    if hasattr(rec, "split_search_best"):
        return lambda: rec.split_search_best(inputs, geom, geom_t, active, init, 4, 0.1)
    return lambda: rec._run_split_guided(inputs, geom, geom_t, active, init, 4, 0.1,
                                         round_pairs=rec.ROUND_PAIRS["cuda"])


def walled(fn, runs):
    """(wall ms, CUDA-event ms) per run, torch.cuda.synchronize() on both
    sides, one warm-up first; and the last run's outputs."""
    fn()
    wall, dev = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        res = fn()
        e1.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        dev.append(e0.elapsed_time(e1))
    return wall, dev, res


for tag, gfa_path, fa, B, modes in (
        ("stretch", os.path.join(d, "graph.gfa"), os.path.join(d, "reads.fa"), 348, (8, 9)),
        ("128 paths", os.path.join(d2, "graph.gfa"), os.path.join(d2, "reads.fa"), 24, (8,)),
        ("long", long_gfa, long_fa, 11, (8, 9))):
    g = PathGraph.from_gfa(gfa.parse_gfa(gfa_path))
    rg = g.reverse()
    dg, dgr = path_device_graph(g, "cuda"), rev_device_graph(rg, "cuda")
    seq, L = encode_reads(fasta.get_sequences(fa)[0][:B], device="cuda")
    geom = rec._SplitGeometry(g, rg)
    geom_t = geom.tensors("cuda")
    Lnp = L.cpu().numpy()
    jcol = np.arange(seq.shape[1])
    active = (jcol[None, :] >= 1) & (jcol[None, :] < (Lnp - 1)[:, None])
    for mode in modes:
        Af = pathwise_engine.fill_pathwise_best(dg, table, seq, mode == 9)
        Ar = rec.fill_pathwise_rev_best(dgr, table, seq, L, mode == 8)
        init = rec._baseline(mode, pathwise_engine._final_column(Af, L).cpu().numpy(), g)[0]
        inputs = rec.split_inputs(Af, Ar, dg.paths_on)
        del Af, Ar
        metrics.reset_phases()
        wall, dev, res = walled(split_fn(inputs, geom, geom_t, active, init), 3)
        metrics.flush_device_counters()
        key = f"split m{mode} {tag} {B}"
        out[key + " wall"], out[key + " device"] = wall, dev
        out[key + " pairs, rounds"] = [metrics.EVENTS["split_pairs"] / 4,
                                       metrics.EVENTS["split_rounds"] / 4]
        out[key + " outputs"] = hashlib.sha256(b"".join(np.asarray(x).tobytes()
                                                        for x in res)).hexdigest()[:16]
        del inputs
    out[f"split {tag} {B} shape"] = [B, g.n, seq.shape[1], g.paths_number]
    del dg, dgr, seq, L
    torch.cuda.empty_cache()

# K11 at the smoke's modes-6/7 launch shapes


def k12(U, Dc, Dfd, Ypre, lc, x0, tb, nd, fire, isa, after, ai):
    """K12 alone on hard_cols_plain's arguments, laid out beforehand."""
    if hasattr(cuda_gap67_hardrow, "prepare"):
        prep = cuda_gap67_hardrow.prepare(U, Dc, Dfd, Ypre, lc, x0, tb, nd, fire, isa, after,
                                          ai, -4, -2)
        return lambda: cuda_gap67_hardrow.launch(*prep)
    # the older wrapper's layout: [B, k, C] inputs, [B, 4, P] lanes, [5, MB] blocks
    C, P, B = Ypre.shape
    Ub, Dcb, Dfb, Ypb = (t.permute(2, 1, 0).contiguous() for t in (U, Dc, Dfd, Ypre))
    lcb, x0b = lc.permute(2, 0, 1).contiguous(), x0.t().contiguous()
    blk = torch.stack([tb, nd, fire, isa, after]).contiguous()
    xs = torch.empty((B, P, C), dtype=torch.int32, device=Ypre.device)
    ds = torch.empty_like(xs)
    return lambda: _kernels.launch(cuda_gap67_hardrow.KERNEL, (B, 1, C + 1, C + 1, P),
                                   Ypre.device, Ub, Dcb, Dfb, Ypb, lcb, x0b, blk, B, U.shape[1],
                                   P, C, int(ai), -4, -2, xs, ds)


for name, gfa_path, fa, B in (("K11 stretch", os.path.join(d, "graph.gfa"), os.path.join(d, "reads.fa"), 232),
                              ("K11 128 paths", os.path.join(d2, "graph.gfa"), os.path.join(d2, "reads.fa"), 16),
                              ("K11 long", long_gfa, long_fa, 7)):
    g = PathGraph.from_gfa(gfa.parse_gfa(gfa_path))
    tabs = pathwise_gap_engine.gap_tables(g, "cuda")
    seq, _ = encode_reads(fasta.get_sequences(fa)[0][:B], device="cuda")
    out[name] = timed(lambda: cuda_gap67_fill.fill_gap67_cuda(tabs, table, seq, -4, -2, False),
                      2, 3)
    out[name + " shape"] = [seq.shape[0], g.n, seq.shape[1], g.paths_number]
    m = tabs.meta
    hard = [i for i in range(1, m.n - 1) if not m.easy[i]]
    most = max(hard, key=lambda r: (int(m.bvalid[r].sum()), r))
    Dm, X, Y = cuda_gap67_fill.fill_gap67_cuda(tabs, table, seq, -4, -2, False)
    for tag, i in (("first hard row", hard[0]), ("most blocks", most)):
        sub = table[int(m.codes[i])][seq.long()]
        U, Dc, Dfd, Ypre, _ = pathwise_gap_engine.stage_hard_row(tabs, Dm, Y, i, sub, -4, -2)
        (tb, nd, fire, isa, after), ai = pathwise_gap_engine.hard_row_scalars(tabs, i)
        lc = tabs.lanes[i][:, :, None].expand(-1, -1, seq.shape[0]).contiguous()
        x0 = X[i, :, :, 0].t().contiguous()
        key = f"K12{name[3:]} {tag}"
        out[key] = timed(k12(U, Dc, Dfd, Ypre, lc, x0, tb, nd, fire, isa, after, ai), 3, 5)
        out[key + " row"] = i
        del U, Dc, Dfd, Ypre
    del tabs, seq, Dm, X, Y
    torch.cuda.empty_cache()
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
