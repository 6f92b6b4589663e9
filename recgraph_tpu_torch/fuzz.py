"""Seeded random graphs and reads for kernel checks.

A copy of ``random_gfa`` / ``random_read`` from
``tests/test_fuzz_random_graphs.py:22,61``, kept in the package so
``chip_smoke.py`` can draw the same graphs without importing the test
module (which imports the JAX engines).  ``tests/test_torch_encode.py``
pins the copy to the original.
"""

from __future__ import annotations

import random

from .io.gfa import Gfa, GfaPath


def random_gfa(rng: random.Random, n_nodes=14, n_paths=4, cover_all=False) -> Gfa:
    """Random connected DAG with ids in topological order + random paths."""
    gfa = Gfa()
    for nid in range(1, n_nodes + 1):
        ln = rng.randint(1, 4)
        gfa.segments[nid] = "".join(rng.choice("ACGT") for _ in range(ln))
    for nid in range(2, n_nodes + 1):
        preds = rng.sample(range(1, nid), min(rng.randint(1, 3), nid - 1))
        for p in preds:
            gfa.edges.append((p, nid))
    succs = gfa.successors()
    preds = gfa.predecessors()

    def walk_through(node):
        left = [node]
        while preds.get(left[0]):
            left.insert(0, rng.choice(preds[left[0]]))
        while succs.get(left[-1]):
            left.append(rng.choice(succs[left[-1]]))
        return left

    for k in range(n_paths):
        start = 1 if rng.random() < 0.7 else rng.randint(1, max(1, n_nodes // 3))
        gfa.paths.append(GfaPath(f"p{k}", walk_through(start)))
    if cover_all:
        covered = {n for p in gfa.paths for n in p.nodes}
        for nid in range(1, n_nodes + 1):
            if nid not in covered:
                w = walk_through(nid)
                gfa.paths.append(GfaPath(f"c{nid}", w))
                covered.update(w)
    return gfa


def random_read(rng: random.Random, gfa: Gfa) -> str:
    """A read resembling a mutated path walk (plus the '$' sentinel)."""
    path = rng.choice(gfa.paths)
    bases = []
    for nid in path.nodes:
        bases.extend(gfa.segments[nid])
    s = "".join(bases)
    out = []
    for c in s:
        r = rng.random()
        if r < 0.08:
            continue  # deletion
        if r < 0.16:
            out.append(rng.choice("ACGT"))  # substitution
        else:
            out.append(c)
        if rng.random() < 0.05:
            out.append(rng.choice("ACGT"))  # insertion
    if len(out) < 3:
        out = list("ACG")
    return "$" + "".join(out)
