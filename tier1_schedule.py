"""Replay the tier-1 run's schedule: how pytest-xdist's ``--dist load``
(xdist 3.8's LoadScheduling) hands the collected tests to its workers,
given each test's time from an earlier run's JUnit file.

The tier-1 run's wall is not its test time over the workers.  The load
scheduler first sends each worker a chunk of N // workers // 4
consecutive tests (N the number collected, skips included), then refills
a worker that runs low with up to pending // workers // 2 more; a chunk
that lands behind a long test waits for it.  So one test more or fewer
can move the long JAX tests, and the queue behind them, from one worker
to another.  This script predicts that.

    python tier1_schedule.py run.xml                # collects tests/ itself
    python tier1_schedule.py run.xml --collect ids.txt --workers 6

``ids.txt``: ``pytest tests/ -q -m 'not slow' --collect-only`` output
(one node id a line).  Tests the JUnit file lacks count 0 s.  Prints the
predicted wall, each worker's end, the initial chunk and the range of N
that keeps it, and the tail of the worker that ends last.
"""

from __future__ import annotations

import argparse
import heapq
import subprocess
import sys
import xml.etree.ElementTree as ET


def junit_times(path: str) -> dict[str, float]:
    times = {}
    for case in ET.parse(path).getroot().iter("testcase"):
        node = case.get("classname").replace(".", "/") + ".py::" + case.get("name")
        times[node] = float(case.get("time") or 0)
    return times


def collect() -> list[str]:
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "-q", "-m", "not slow", "--collect-only",
         "-p", "no:cacheprovider", "-p", "no:randomly"],
        capture_output=True, text=True, env=None).stdout
    return [line.strip() for line in out.splitlines() if "::" in line]


def simulate(order: list[str], times: dict[str, float], workers: int):
    """Returns (wall, ends, runs): ends[w] the time worker w finishes,
    runs[w] its (start, end, node id) in order; t = 0 when the first
    chunks are sent."""
    n = len(order)
    pending = list(range(n))
    queue = {w: [] for w in range(workers)}
    chunk = max(min(n // workers // 4, n), 2)
    for w in range(workers):
        queue[w] += pending[:chunk]
        del pending[:chunk]
    events = [(times.get(order[queue[w][0]], 0.0), w) for w in range(workers) if queue[w]]
    heapq.heapify(events)
    ends, runs = {}, {w: [] for w in range(workers)}
    while events:
        t, w = heapq.heappop(events)
        item = queue[w].pop(0)
        d = times.get(order[item], 0.0)
        runs[w].append((t - d, t, order[item]))
        if pending:
            lo = max(2, len(pending) // workers // 4)
            hi = max(2, len(pending) // workers // 2)
            # a worker busy with a test of 0.1 s or more that still holds
            # two is not refilled (LoadScheduling.check_schedule)
            if len(queue[w]) < lo and not (d >= 0.1 and len(queue[w]) >= 2):
                take = hi - len(queue[w])
                queue[w] += pending[:take]
                del pending[:take]
        if queue[w]:
            heapq.heappush(events, (t + times.get(order[queue[w][0]], 0.0), w))
        else:
            ends[w] = t
    return max(ends.values()), ends, runs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("junit")
    ap.add_argument("--collect", help="file of node ids (default: collect tests/ now)")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--tail", type=float, default=300.0,
                    help="seconds of the last worker's run to list")
    args = ap.parse_args(argv)
    order = ([line.strip() for line in open(args.collect) if "::" in line]
             if args.collect else collect())
    times = junit_times(args.junit)
    wall, ends, runs = simulate(order, times, args.workers)
    n, w = len(order), args.workers
    chunk = n // w // 4
    lo_n, hi_n = 4 * w * chunk, 4 * w * (chunk + 1) - 1
    print(f"tests collected {n}, test time {sum(times.get(o, 0.0) for o in order):.0f} s")
    print(f"initial chunk {chunk} (the same for {lo_n}-{hi_n} tests)")
    print(f"predicted wall {wall:.0f} s after the first chunks; workers end at "
          + ", ".join(f"{ends[k]:.0f}" for k in sorted(ends)))
    last = max(ends, key=ends.get)
    print(f"worker {last}, its tests of 30 s or more and its last {args.tail:.0f} s:")
    for start, end, node in runs[last]:
        if end - start >= 30 or start >= wall - args.tail:
            print(f"  {start:7.0f} {end - start:6.1f}  {node}")


if __name__ == "__main__":
    main()
