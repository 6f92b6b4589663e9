"""recgraph_tpu_torch — the PyTorch/CUDA port of recgraph_tpu.

Counterpart of ``recgraph_tpu/__init__.py``.  The JAX package stays the
reference; this package runs the same pipeline on an NVIDIA GPU through
hand-written CUDA kernels (``csrc/``), and on the CPU through their
plain PyTorch versions when ``device="cpu"`` is asked for.

Layer map (module names mirror the JAX package):

- ``_backend``  device resolution and a toolchain report.
- ``io``, ``scoring``, ``graph``, ``oracle``, ``native``
                the host layer: copies of the JAX package's framework-free
                modules of the same names, and the native GAF emitter and
                FASTA reader (``csrc/host/``).
- ``ops``       encode, the POA, pathwise, pathwise affine-gap and
                recombination fills and the split search (plain torch
                + CUDA kernels), the on-device traceback walks and the
                chunk pipelines.
- ``align``     per-mode orchestration, GAF emission and the run level
                (resume, profile, multi-process runs, the read split).
- ``parallel``  multi-process runs (``distributed``) and the
                data-parallel read split over named devices (``mesh``).
- ``api``       the library API (modes 0-3, one read a call).
- ``metrics``   phase timers, kernel launch counters, the profiler trace.
- ``cli``       the RecGraph-compatible command line.

The port imports nothing of ``recgraph_tpu``; only its tests import both.
Ported: all ten modes (POA 0-3 and pathwise 4/5 at every read length,
pathwise affine-gap 6/7, recombination 8/9), the library API,
RECGRAPH_PROFILE, RECGRAPH_RESUME, multi-process runs and the
data-parallel read split (byte-equal, over the devices a caller names;
no run splits by itself).  Not yet: the opt-in mode-8/9 window pair
(RECGRAPH_REC_WINDOW, RECGRAPH_SPLIT_FULL).
"""

__version__ = "0.1.0"
