"""Build and load the hand-written CUDA kernels (no counterpart in recgraph_tpu).

``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface and loaded with ``ctypes``.  The build
happens at first use, into ``recgraph_tpu_torch/build/``, keyed by a
hash of the sources and flags, so a fresh checkout builds once and
later runs reuse the library; each source compiles in its own ``nvcc``
process, all started together, and one more links them.  A build or
launch failure raises; no caller falls back to a plain version.

Each C entry launches on the stream it is given (PyTorch's current
stream) and returns ``cudaGetLastError()``; :func:`check` raises when it
is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

import torch

from .. import _backend, metrics

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_SIGNATURES = {
    # seq, L, bta, table, codes, pred_idx, min_pred, r_values, cand, srow,
    # store_at, n_cand, B, n, Pm, Lp, cw, warps, full, S, ms, bsp, mfirst,
    # mlast, score, last_row, last_col, packed, lefts, rights, stream
    "rgt_poa_global_fill": [_P] * 11 + [_I] * 9 + [_P] * 10 + [_P],
    # K14: as K1
    "rgt_poa_global_v1_fill": [_P] * 11 + [_I] * 9 + [_P] * 10 + [_P],
    # K3: ... store_at, n_cand, B, n, Pm, Lp, W, cw, warps, full, S, ms, gs,
    # bsp, mfirst, mlast, score, last_row, last_col, packed, lefts, rights,
    # wss, over, stream
    "rgt_poa_global_win_fill": [_P] * 11 + [_I] * 10 + [_P] * 13 + [_P],
    # seq, L, table, codes, node_start, pred_idx, srow, store_at, B, n,
    # Pm, Lp, cw, warps, full, S, ms, best_val, best_i, best_j, packed,
    # stream
    "rgt_poa_local_fill": [_P] * 8 + [_I] * 8 + [_P] * 5 + [_P],
    # K13: as K2, n_store after Lp
    "rgt_poa_local_v1_fill": [_P] * 8 + [_I] * 9 + [_P] * 5 + [_P],
    # K15: as K2, n_store and i16 after Lp
    "rgt_poa_local_v2_fill": [_P] * 8 + [_I] * 10 + [_P] * 5 + [_P],
    # K17: as K13
    "rgt_poa_local_v4_fill": [_P] * 8 + [_I] * 9 + [_P] * 5 + [_P],
    # K16: as K13, the score plane m in place of packed
    "rgt_poa_local_scores_fill": [_P] * 8 + [_I] * 9 + [_P] * 5 + [_P],
    # seq, L, bta, table, codes, pred_idx, min_pred, r_values, cand, srow,
    # store_at, n_cand, B, n, Pm, Lp, o, e, cw, warps, full, clamp, S, ms,
    # ys, bsp, mlast, score, last_row, last_col, packed, packed_x,
    # packed_y, lefts, rights, stream
    "rgt_poa_gap_global_fill": [_P] * 11 + [_I] * 12 + [_P] * 12 + [_P],
    # K6: ... store_at, n_cand, B, n, Pm, Lp, W, o, e, cw, warps, full,
    # clamp, S, ms, ys, bsp, mlast, score, last_row, last_col, packed,
    # packed_x, packed_y, lefts, rights, wss, over, stream
    "rgt_poa_gap_global_win_fill": [_P] * 11 + [_I] * 13 + [_P] * 14 + [_P],
    # seq, L, table, codes, node_start, pred_idx, srow, store_at, B, n,
    # Pm, Lp, o, e, cw, warps, full, clamp, S, ms, ys, best_val, best_i,
    # best_j, packed, packed_x, packed_y, stream
    "rgt_poa_gap_local_fill": [_P] * 8 + [_I] * 11 + [_P] * 8 + [_P],
    # seq, table, codes, grep, gpred, pslot, gcount, B, n, P, Lp, Gd,
    # semiglobal, cluster, threads, smem, smem_form, cw, scratch, stride, A,
    # stream
    "rgt_pathwise_fill": [_P] * 7 + [_I] * 11 + [_P, _LL, _P] + [_P],
    # threads, smem, smem_form, cw -> blocks an SM holds (K7; K8 below),
    # or -error
    "rgt_pathwise_per_sm": [_I] * 4,
    "rgt_pathwise_rev_per_sm": [_I] * 4,
    # seq, L, table, meta, rmin, B, n, P, Lp, Gd, W, threads, smem,
    # smem_form, scratch, stride, Aw, ws, bound, stream
    "rgt_pathwise_win_fill": [_P] * 5 + [_I] * 9 + [_P, _LL] + [_P] * 3 + [_P],
    # threads, smem, smem_form -> blocks an SM holds, or -error
    "rgt_pathwise_win_per_sm": [_I] * 3,
    # S2: seq, L, table, meta, B, n, P, Lp, Gd, W, threads, smem,
    # smem_form, scratch, stride, Awr, wsr, Rr, stream
    "rgt_pathwise_rev_win_fill": [_P] * 4 + [_I] * 9 + [_P, _LL] + [_P] * 3 + [_P],
    "rgt_pathwise_rev_win_per_sm": [_I] * 3,
    # seq, L, table, codes, grep, gpred, pslot, qsrc, gcount, B, n, P, Lp,
    # Gd, mode8, cluster, threads, smem, smem_form, cw, scratch, stride, A,
    # stream
    "rgt_pathwise_rev_fill": [_P] * 9 + [_I] * 11 + [_P, _LL, _P] + [_P],
    # fmax, farg, vf, rmax, rarg, vr, dfs, dfe, ids, fwe, rve, R, r,
    # bidx, cols, K, I, Lp, edge0 (a pair key), capf, capr, col_max,
    # edge_any, flat_edge, flat_plain, stream
    "rgt_split_summary": [_P] * 11 + [_F] * 2 + [_P] * 2 + [_I] * 3 + [_LL] + [_I] * 2
    + [_P] * 4 + [_P],
    # fmax, farg, vf, rmax, rarg, vr, dfs, dfe, ids, fwe, rve, R, r, ubs,
    # order, ncand, init, B, I, Lp, edge0 (a pair key), C, capf, capr,
    # state, cols, flats, out, pairs, stream
    "rgt_split_guided": [_P] * 11 + [_F] * 2 + [_P] * 4 + [_I] * 3 + [_LL] + [_I] * 3
    + [_P] * 5 + [_P],
    # fmax, vf, rmax, vr, wf, wr, B, I, Lp, ub, stream
    "rgt_split_bound": [_P] * 6 + [_I] * 3 + [_P] + [_P],
    # capf, capr -> blocks of the guided kernel an SM holds, or -error
    "rgt_split_guided_per_sm": [_I] * 2,
    # seq, table, rows, lanemask, blocks, blockmask, lanes, chain, B, n,
    # P, MB, Lp, o, e, semiglobal, scratch, Dm, X, Y, hard_ran, stream
    "rgt_gap67_fill": [_P] * 8 + [_I] * 8 + [_P] * 5 + [_P],
    # V, W, slots, hub, x0, B, P, Lp, o, e, X, D, stream
    "rgt_gap67_hardrow": [_P] * 5 + [_I] * 5 + [_P] * 2 + [_P],
}

_lib = None
build_info: dict = {}


def _sources() -> list[str]:
    return sorted(f for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources():
        h.update(f.encode())
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"librgt_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless a library for these sources exists."""
    so = library_path()
    if os.path.exists(so):
        build_info.setdefault("seconds", 0.0)
        return so
    nvcc = _backend.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    cus = [f for f in _sources() if f.endswith(".cu")]
    objs = [f"{tmp}.{f}.o" for f in cus]
    t0 = time.perf_counter()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC, f)]
            for f, o in zip(cus, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    rcs = [p.returncode for p in procs]
    if not any(rcs):
        cmds.append([nvcc, *ARCH, "-shared", "-o", tmp, *objs])
        link = subprocess.run(cmds[-1], capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        rcs.append(link.returncode)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["log"] = "\n".join(" ".join(c) + "\n" + lg for c, lg in zip(cmds, logs))
    with open(so[:-3] + ".log", "w") as fh:
        fh.write(build_info["log"])
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if any(rcs):
        raise RuntimeError(f"nvcc failed (codes {rcs}):\n{build_info['log'][-6000:]}")
    os.replace(tmp, so)
    return so


def load():
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rgt_error_string.argtypes = [ctypes.c_int]
        lib.rgt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if rc != 0:
        msg = load().rgt_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed: error {rc} ({msg})")


def check_tensors(kernel: str, device, **tensors) -> None:
    """Every tensor on ``device`` (a CUDA device), int32 and contiguous."""
    if device.type != "cuda":
        raise ValueError(f"{kernel}: needs CUDA tensors, got {device}")
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{kernel}: {name} has dtype {t.dtype}, expected int32")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")


def graph_args(dg):
    """Per-graph int32 arrays the kernels take: predecessor slots with -1
    padding, the sink candidates (row n-2, then F's predecessors) and the
    node-start flags."""
    def build():
        pidx = torch.where(dg.pred_mask, dg.pred_idx, -1).to(torch.int32).contiguous()
        cand = torch.tensor(
            (dg.n - 2,) + tuple(dg.sink_rows), dtype=torch.int32, device=dg.device
        )
        return pidx, cand, dg.node_start.to(torch.int32).contiguous()

    return dg.cached("_cuda_graph_args", build)


def check_inputs(kernel, dg, table, seq, L, bta=None):
    """The device, dtype, layout and shape checks of the POA wrappers;
    returns the graph arguments (predecessor slots, sink candidates,
    node-start flags)."""
    dev = seq.device
    B = seq.shape[0]
    pidx, cand, node_start = graph_args(dg)
    extra = {} if bta is None else {"bta": bta}
    check_tensors(
        kernel, dev, seq=seq, L=L, table=table, codes=dg.codes, pred_idx=pidx,
        min_pred=dg.min_pred, r_values=dg.r_values, cand=cand,
        node_start=node_start, **extra,
    )
    if table.shape != (7, 7) or L.shape != (B,) or (bta is not None and bta.shape != (B,)):
        raise ValueError(f"{kernel}: bad shapes table {tuple(table.shape)}, "
                         f"L {tuple(L.shape)} for B={B}")
    return pidx, cand, node_start


def launch(kernel: str, shape: tuple, dev, *args) -> None:
    """Call the C entry ``rgt_<kernel>_fill`` (the fills) or
    ``rgt_<kernel>`` on ``dev``'s current stream, raise on a launch
    error, and count the launch with its ``shape`` (reads, rows, Lp,
    stored width; the pathwise kernels add paths).  Tensor arguments
    pass as device pointers."""
    lib = load()
    entry = f"rgt_{kernel}_fill"
    fn = getattr(lib, entry if entry in _SIGNATURES else f"rgt_{kernel}")
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        rc = fn(*cargs, torch.cuda.current_stream(dev).cuda_stream)
    check(rc, kernel)
    metrics.count_launch(kernel, shape)
