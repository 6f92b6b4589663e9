"""A/B of the mode-0/1 fill kernels, each held to its plain version.

    python -m recgraph_tpu_torch.kernel_ab [batch] [variant ...] [--device cpu]

Counterpart of ``tools/bench_kernel_ab.py``: the same corpus (the
``example/`` reads repeated up to ``batch``, default 512, on the example
graph, with the ``none`` 2/-4 matrix) and the same variant names where
the port has them (default: v2 v4):

    v1     K13, fill_local_v1 (recgraph_tpu/ops/pallas_poa.py:217)
    v2     K15, fill_local_v2 at int32 (recgraph_tpu/ops/pallas_poa_v2.py:182)
    v3     K16, fill_local_scores (tools/pallas_poa_v3.py:137), then
           walk_local_scores over its score plane; the JAX tool has no
           v3, since no JAX caller reaches K16, so this name is the port's
    v4     K17, fill_local_v4 (tools/pallas_poa_v4.py:218)
    v5     K2, the main path's mode-1 kernel (pallas_poa_v5.py:251)
    plain  poa_engine.fill_local_plain, in place of the JAX tool's xla
    g1     K14, fill_global_v1 (recgraph_tpu/ops/pallas_poa.py:537)
    g2     K1, the main path's mode-0 kernel (pallas_poa_global2.py:477)

g1 and g2 run on the same reads with bta = int(1 + 0.01 * len(read)).
Every variant's outputs must equal its plain version's (the plain fill
of its mode, laid out as the variant stores it; the plain fill runs
once per mode); v3's walk must equal walk_poa's over the plain fill's
packed planes.  Any difference exits nonzero.  Each variant then runs
once more to warm up and three times timed: per-fill ms (CUDA events on
the card, the host clock on the CPU) and Gcells/s over batch * (n - 1)
* Lp cells.  The JAX tool's chained-slope timing, a TPU workaround, is
not ported, nor its variants that set TPU knobs (``NOT_PORTED``).

Runs on the card unless ``--device cpu`` is given (where every variant
runs its plain version), and never falls back.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from . import _backend
from .graph.poagraph import PoaGraph
from .io import fasta, gfa
from .ops import poa_engine, poa_variants as pv, traceback_engine as tb
from .ops.encode import encode_read_aux, encode_reads, poa_device_graph
from .scoring import ScoreMatrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (kernel id, mode, fill(dg, table, seq, L[, bta]), layout of the
# plain fill's outputs)
VARIANTS = {
    "v1": ("K13", 1, pv.fill_local_v1, pv.local_v1_layout),
    "v2": ("K15", 1, pv.fill_local_v2, pv.local_v2_layout),
    "v3": ("K16", 1, pv.fill_local_scores, pv.local_scores_layout),
    "v4": ("K17", 1, pv.fill_local_v4, pv.local_v4_layout),
    "v5": ("K2", 1, poa_engine.fill_local_best, lambda p: p[:4]),
    "plain": ("plain", 1, poa_engine.fill_local_plain, lambda p: p[:4]),
    "g1": ("K14", 0, pv.fill_global_v1, pv.global_v1_layout),
    "g2": ("K1", 0, poa_engine.fill_global_best, lambda p: p),
}
_RWS = "R (rows per TPU grid step) is not ported: it only sets the row padding, kept at R = 8"
_STRIP = ("a timing-only ablation whose results are wrong by design "
          "(tools/bench_kernel_ab.py:60)")
NOT_PORTED = {
    "xla": "the XLA fill's counterpart is the plain torch fill: use 'plain'",
    "v4r16": _RWS, "v4r32": _RWS, "v5r16": _RWS, "v5r4": _RWS,
    "v5bt32": "Bt (reads per TPU grid tile) is not ported: one block per read serves any batch",
    "v4cummax": "chain= picks the TPU kernel's in-row scan; the CUDA kernel has one block scan",
    "v4radix4": "chain= picks the TPU kernel's in-row scan; the CUDA kernel has one block scan",
    **{f"v4-{f}": _STRIP for f in ("sweep", "ringw", "chain", "dynsub", "pack", "all")},
    "v4onlychain": _STRIP,
}


def corpus(batch: int, device):
    """The example graph and reads repeated up to ``batch``: (dg, table,
    seq, L, bta)."""
    seqs, _ = fasta.get_sequences(os.path.join(ROOT, "example", "reads.fa"))
    g = PoaGraph.from_gfa(gfa.parse_gfa(os.path.join(ROOT, "example", "graph.gfa")))
    reads = (seqs * (batch // len(seqs) + 1))[:batch]
    table = torch.as_tensor(ScoreMatrix.create("none", 2, -4).table, dtype=torch.int32)
    seq, L = encode_reads(reads, device=device)
    bta = encode_read_aux([int(1 + 0.01 * len(s)) for s in reads], device)
    return poa_device_graph(g, device), table.to(device), seq, L, bta


def mean_ms(fn, device, reps=3):
    """Mean time of ``fn()`` over ``reps`` calls after one warm-up: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize(device)
    return t0.elapsed_time(t1) / reps


def differences(got, ref):
    """The indices of the outputs that differ in shape, dtype or value."""
    if len(got) != len(ref):
        return ["count"]
    return [k for k, (a, b) in enumerate(zip(got, ref))
            if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b)]


def walks_equal(got, packed, bi, bj, max_steps):
    """walk_local_scores's walk (``got``) equals walk_poa's over the plain
    fill's packed planes: compacted steps, step counts, stop cells."""
    dirs, rows, steps, stop_row, stop_col = tb.walk_poa(packed, bi, bj, max_steps)[:5]
    if not (torch.equal(steps, got[2]) and torch.equal(stop_row, got[3])
            and torch.equal(stop_col, got[4])):
        return False
    d, r, k = dirs.cpu().numpy(), rows.cpu().numpy(), steps.cpu().numpy()
    gd, gr = got[0].cpu().numpy(), got[1].cpu().numpy()
    for b in range(d.shape[0]):
        cd, cr = tb.compact_walk(d[b], r[b], int(k[b]))
        if not (np.array_equal(cd, gd[b, : k[b]]) and np.array_equal(cr, gr[b, : k[b]])):
            return False
    return True


def run(batch: int, variants, device) -> dict:
    """Check and time each variant; returns {name: result dict} with
    ``ms``, ``gcells``, ``equal`` and, for v3, ``walk_ms``."""
    for name in variants:
        if name in NOT_PORTED:
            raise ValueError(f"kernel_ab: variant {name!r} is not ported: {NOT_PORTED[name]}")
        if name not in VARIANTS:
            raise ValueError(f"kernel_ab: unknown variant {name!r}; ported: {sorted(VARIANTS)}")
    device = _backend.resolve_device(device)
    dg, table, seq, L, bta = corpus(batch, device)
    Lp = seq.shape[1]
    cells = batch * (dg.n - 1) * Lp
    clock = "CUDA events" if device.type == "cuda" else "host clock, CPU"
    print(f"# device={device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}; "
          f"nvidia-smi: {_backend.nvidia_smi_line() or 'not available'}) batch={batch} "
          f"n={dg.n} Lp={Lp}", flush=True)
    plain = {}   # mode -> the plain fill's outputs, computed once

    def plain_of(mode):
        if mode not in plain:
            plain[mode] = (poa_engine.fill_local_plain_planes(dg, table, seq, L) if mode == 1
                           else poa_engine.fill_global_plain(dg, table, seq, L, bta))
        return plain[mode]

    out = {}
    for name in variants:
        kid, mode, fill, layout = VARIANTS[name]
        args = (dg, table, seq, L) + ((bta,) if mode == 0 else ())
        got = fill(*args)
        bad = differences(got, layout(plain_of(mode)))
        res = dict(kernel=kid, equal=not bad)
        note = ""
        if name == "v3":
            W = tb.max_walk_steps(dg.n, Lp)
            walk = lambda: tb.walk_local_scores(  # noqa: E731
                got[3], seq, table, dg.node_start, dg.codes, dg.pred_idx, got[1], got[2], W)
            ok = walks_equal(walk(), plain_of(1)[3], got[1], got[2], W)
            res["equal"] = res["equal"] and ok
            res["walk_ms"] = mean_ms(walk, device)
            note = (f"; walk_local_scores {res['walk_ms']:.3f} ms, "
                    f"{'equal to' if ok else 'DIFFERS from'} walk_poa's walk")
        del got
        res["ms"] = mean_ms(lambda: fill(*args), device)
        res["gcells"] = cells / res["ms"] / 1e6
        verdict = "outputs equal to the plain version" if not bad else f"outputs {bad} DIFFER"
        print(f"{name} ({kid}): per-fill {res['ms']:.3f} ms  {res['gcells']:.2f} Gcells/s "
              f"({clock}); {verdict}{note}", flush=True)
        out[name] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m recgraph_tpu_torch.kernel_ab",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("args", nargs="*", help="[batch] [variant ...]")
    ap.add_argument("--device", default="cuda", choices=_backend.DEVICES)
    ns = ap.parse_args(argv)
    rest = list(ns.args)
    batch = int(rest.pop(0)) if rest and rest[0].isdigit() else 512
    try:
        res = run(batch, rest or ["v2", "v4"], ns.device)
    except ValueError as exc:
        print(exc, file=sys.stderr)
        return 2
    return 0 if all(r["equal"] for r in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
