"""Process-wide phase timers and counters.

Counterpart of ``recgraph_tpu/metrics.py:18-76``.  There is no compile
listener (PyTorch runs eagerly; kernels build once, see
``ops/_kernels.py``).  ``device_wait`` is charged at the drain point,
where the pipeline synchronises with the device.  Each kernel wrapper
adds one to ``LAUNCHES[name]`` where it launches its kernel, so a run
can show that it went through the kernels (the name is the wrapper
module's ``KERNEL``; K13-K17 count as ``poa_local_v1``,
``poa_global_v1``, ``poa_local_v2``, ``poa_local_scores`` and
``poa_local_v4``), and to ``SHAPES[(name, B, n, Lp, W)]``, so that a
run can hold each kernel to its plain version at the shapes the run
gave it.  ``EVENTS`` counts what a run should
show without it being a failure: the mode-4 long reads that the window
ladder sends to the full-width fill (``pathwise_win_fullwidth``), and
the rounds and (read, column) pairs of the modes-8/9 split search
(``split_rounds``, ``split_pairs``; on the card one round a chunk, S1's
guided launch, with its pairs counted on the device), whose time is
the ``split`` phase,
and the (read, hard row) pairs whose column program (K12) ran inside
the modes-6/7 fill (``gap67_hard_rows``).  A kernel that counts an
event on the device adds to ``device_counter(name, device)``, so its
launch never waits for it; ``flush_device_counters()`` adds those
counts into ``EVENTS`` (one wait for the device per name and device)
and is called where the counts are read.

:func:`trace` (``RECGRAPH_PROFILE=<dir>``) records a ``torch.profiler``
trace of a run; while it records, each phase is also a
``record_function`` range named ``phase:<name>`` in the trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import Counter

LAUNCHES: Counter = Counter()
SHAPES: Counter = Counter()           # (kernel, reads, rows, Lp, stored width[, paths])
EVENTS: Counter = Counter()           # name -> count
_DEVICE_EVENTS: dict = {}             # (name, device) -> int64[1] tensor not yet flushed
PHASES: Counter = Counter()           # name -> exclusive seconds
_stack: list[list] = []               # [name, child_seconds] frames
_tracing = False                      # a trace() is recording


def count_launch(kernel: str, shape: tuple) -> None:
    LAUNCHES[kernel] += 1
    SHAPES[(kernel, *shape)] += 1


def device_counter(name: str, device):
    """An int64[1] tensor on ``device`` that kernels add ``name``'s count
    to; ``flush_device_counters`` adds it into ``EVENTS[name]``."""
    key = (name, str(device))
    t = _DEVICE_EVENTS.get(key)
    if t is None:
        import torch

        t = _DEVICE_EVENTS[key] = torch.zeros(1, dtype=torch.int64, device=device)
    return t


def flush_device_counters() -> None:
    """Add every device counter into ``EVENTS`` and drop it; this waits
    for the kernels that add to them."""
    while _DEVICE_EVENTS:
        (event, _), t = _DEVICE_EVENTS.popitem()
        EVENTS[event] += int(t.item())


@contextlib.contextmanager
def phase(name: str):
    """Accumulate EXCLUSIVE wall time under ``name``: a nested phase
    charges its own name and is subtracted from the enclosing one."""
    span = None
    if _tracing:
        import torch

        span = torch.profiler.record_function(f"phase:{name}")
        span.__enter__()
    t0 = time.perf_counter()
    _stack.append([name, 0.0])
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _, child = _stack.pop()
        PHASES[name] += dt - child
        if _stack:
            _stack[-1][1] += dt
        if span is not None:
            span.__exit__(None, None, None)


def trace_path(out_dir: str) -> str:
    """The trace file :func:`trace` writes for this process."""
    return os.path.join(out_dir, f"recgraph_torch.{os.getpid()}.pt.trace.json")


@contextlib.contextmanager
def trace(out_dir: str, cuda: bool):
    """Record the block with ``torch.profiler`` (CPU activity, and CUDA
    activity with ``cuda``) and write a Chrome trace to
    :func:`trace_path` (``out_dir`` is created), also when the block
    raises."""
    global _tracing
    import torch.profiler as tp

    acts = [tp.ProfilerActivity.CPU] + ([tp.ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(out_dir, exist_ok=True)
    prof = tp.profile(activities=acts)
    prof.start()
    _tracing = True
    try:
        yield
    finally:
        _tracing = False
        prof.stop()
        prof.export_chrome_trace(trace_path(out_dir))


def reset_phases() -> None:
    """Zero every counter: phases, kernel launches and events."""
    PHASES.clear()
    EVENTS.clear()
    _DEVICE_EVENTS.clear()
    _stack.clear()
    LAUNCHES.clear()
    SHAPES.clear()


def phases_dict() -> dict:
    return dict(PHASES)


def phase_summary() -> str:
    if not PHASES:
        return ""
    items = " ".join(
        f"{k}={v:.3f}" for k, v in sorted(PHASES.items(), key=lambda kv: -kv[1])
    )
    return f"phases: {items}"
