"""ctypes loader for the port's native host library (``csrc/host/*.cpp``).

Counterpart of ``recgraph_tpu/native.py``, cut to what the port calls:
the FASTA reader and the walk-based GAF emitters.  The library is built
with the system C++ compiler at first use into
``recgraph_tpu_torch/build/``, keyed by a hash of its sources and flags,
as ``ops/_kernels.py`` keys the CUDA library.  A failed build raises;
nothing falls back to Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc", "host")
BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-pthread"]

_lib = None
_lock = threading.Lock()


def _sources() -> list[str]:
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR) if f.endswith(".cpp"))


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for f in _sources():
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"librgt_host_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the host library unless one for these sources exists."""
    so = library_path()
    if os.path.exists(so):
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found (CXX, g++, c++) for the host library")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *_sources()],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(
            f"host library build failed ({cxx}, code {proc.returncode}):\n"
            f"{(proc.stdout + proc.stderr)[-6000:]}"
        )
    os.replace(tmp, so)
    return so


def load():
    """The loaded host library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.gaf_emit_poa_walk_batch.restype = ctypes.c_int64
            lib.gaf_emit_poa_walk_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p,
                ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.gaf_emit_poa_walk.restype = ctypes.c_int64
            lib.gaf_emit_poa_walk.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64,
            ]
            lib.read_fasta.restype = ctypes.c_void_p
            lib.read_fasta.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
            lib.free_buffer.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def _ptr(a):
    assert a.dtype in (np.int32, np.int64) and a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.c_void_p)


_OUT_CAP = 1 << 20
_tls = threading.local()


def _outbuf():
    """Reused output buffer, one per thread."""
    buf = getattr(_tls, "out_buf", None)
    if buf is None:
        buf = _tls.out_buf = ctypes.create_string_buffer(_OUT_CAP)
    return buf


def gaf_emit_poa_walk_batch(dirs2d, rows2d, params, hofp_ids, amb, percap=1 << 12):
    """Batch walk emission: one C++ call (threaded inside) for a chunk.

    dirs2d/rows2d int32[B, stride] C-contiguous; params int64[B, 6]
    (n_steps, stop_row, query_start, last_row, query_end, seq_len).
    Returns list[str | None]: None where a read overflowed ``percap``
    bytes or was rejected; callers emit it with :func:`gaf_emit_poa_walk`.
    """
    lib = load()
    B, stride = dirs2d.shape
    out = (ctypes.c_char * (B * percap))()
    rcs = np.empty(B, dtype=np.int64)
    lib.gaf_emit_poa_walk_batch(
        _ptr(dirs2d), _ptr(rows2d), stride, _ptr(params), B,
        _ptr(hofp_ids), 1 if amb else 0, out, percap, _ptr(rcs),
    )
    base = ctypes.addressof(out)
    return [
        ctypes.string_at(base + b * percap, int(rc)).decode() if rc >= 0 else None
        for b, rc in enumerate(rcs)
    ]


def gaf_emit_poa_walk(dirs, rows, stop_row, query_start, last_row, query_end,
                      hofp_ids, seq_len, amb) -> str | None:
    """The GAF line tail of one compact walk, or None if it is rejected."""
    lib = load()
    out = _outbuf()
    rc = lib.gaf_emit_poa_walk(
        _ptr(dirs), _ptr(rows), len(dirs), stop_row, query_start,
        last_row, query_end, _ptr(hofp_ids), seq_len, 1 if amb else 0,
        out, _OUT_CAP,
    )
    if rc < 0:
        return None
    return out.raw[:rc].decode()


def read_fasta(path: str):
    """(sequences, names) of a FASTA file; raises if it cannot be read."""
    lib = load()
    ln = ctypes.c_int64()
    p = lib.read_fasta(os.fsencode(path), ctypes.byref(ln))
    if not p:
        raise FileNotFoundError(f"cannot read FASTA file {path!r}")
    try:
        data = ctypes.string_at(p, ln.value).decode()
    finally:
        lib.free_buffer(p)
    seqs, names = [], []
    for line in data.splitlines():
        name, seq = line.split("\t", 1)
        names.append(name)
        seqs.append(seq)
    return seqs, names
