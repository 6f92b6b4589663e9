"""Multi-process runs: a process group and read sharding over processes.

Counterpart of ``recgraph_tpu/parallel/distributed.py`` on
``torch.distributed`` (gloo) instead of ``jax.distributed``.  Reads are
embarrassingly parallel, so the only data that crosses processes is the
result gather:

- every process calls :func:`initialize` and parses the same graph;
- the read corpus is split contiguously by :func:`host_read_slice`, and
  each process aligns its slice on its host's devices;
- each process writes ``<out>.part<k>``; after :func:`barrier`, process
  0 concatenates the parts (:func:`merge_host_outputs`).
"""

from __future__ import annotations

import datetime

import torch.distributed as dist

# the join waits this long for every process (jax.distributed's default
# initialization timeout); the end barrier waits as long as the slowest
# process aligns
INIT_TIMEOUT = datetime.timedelta(seconds=300)
BARRIER_TIMEOUT = datetime.timedelta(days=1)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> tuple[int, int]:
    """Join the process group (gloo, ``tcp://<coordinator_address>``);
    a no-op for one process.  Returns (process_id, num_processes)."""
    if num_processes is None or num_processes <= 1:
        return 0, 1
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs --coordinator and --process-id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in [0, {num_processes})")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, timeout=INIT_TIMEOUT)
    return process_id, num_processes


def barrier() -> None:
    """Wait for every process of the group that :func:`initialize` joined."""
    dist.monitored_barrier(timeout=BARRIER_TIMEOUT, wait_all_ranks=True)


def shutdown() -> None:
    """Leave the process group that :func:`initialize` joined."""
    dist.destroy_process_group()


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_read_slice(n_reads: int, process_id: int | None = None,
                    num_processes: int | None = None) -> slice:
    """Contiguous read range owned by this process (balanced split)."""
    pid = _rank() if process_id is None else process_id
    np_ = _world() if num_processes is None else num_processes
    base, extra = divmod(n_reads, np_)
    start = pid * base + min(pid, extra)
    stop = start + base + (1 if pid < extra else 0)
    return slice(start, stop)


def merge_host_outputs(out_file: str, num_processes: int) -> None:
    """Concatenate the per-process ``<out>.part<k>`` files into ``out_file``."""
    with open(out_file, "w") as dst:
        for k in range(num_processes):
            with open(f"{out_file}.part{k}") as src:
                dst.write(src.read())
