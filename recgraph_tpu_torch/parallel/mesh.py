"""The data-parallel read split over an explicit device list.

Counterpart of the output contract of ``recgraph_tpu/parallel/mesh.py``
(the JAX package shards a batch's reads over a device mesh inside each
engine): the reads are split contiguously at the engine call
(:func:`split_map`), each slice runs on its own device, and the results
are concatenated in read order before emission and writing, so the
output is the one-device run's, byte for byte.

The split is not a speed-up, so no run takes it unless its caller
names the devices (``align.pipeline.run(opts, devices)``).  The slices
run one after another: the walks are host loops of small launches, and
slices run in a thread a device contended for the interpreter lock,
1.1-1.9x slower than one device on two H100s and 1.6-5.1x on four
(``split_ab.py``, PERF.md).  A split that gains needs one process a
device.
"""

from __future__ import annotations

import contextlib

import torch

from .distributed import host_read_slice


def split_map(fn, devices, *per_read) -> list:
    """``fn(*slices, device)`` on contiguous slices of the per-read lists,
    one device after another; the results concatenated in read order.
    One device: one call on every read."""
    if len(devices) == 1:
        return fn(*per_read, devices[0])
    out = []
    for k, dev in enumerate(devices):
        sl = host_read_slice(len(per_read[0]), k, len(devices))
        if sl.start == sl.stop:
            continue
        on_cuda = torch.device(dev).type == "cuda"
        with torch.cuda.device(dev) if on_cuda else contextlib.nullcontext():
            out.extend(fn(*(a[sl] for a in per_read), dev))
    return out
