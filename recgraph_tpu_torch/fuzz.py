"""Seeded random graphs and reads for kernel checks.

A copy of ``random_gfa`` / ``random_read`` from
``tests/test_fuzz_random_graphs.py:22,61`` and of ``fragment_gfa`` /
``_random_reads`` (here ``fragment_reads``) from
``tests/test_rev_fill_leak_rows.py:29,91``, the fragment-path graphs
whose reverse graphs have the reference's delta-leak rows, with
``LEAK_SEEDS`` (:108), which cover every leak branch.  They are kept in
the package so ``chip_smoke.py`` can draw the same graphs without
importing the test modules (which import the JAX engines).
``tests/test_torch_encode.py`` and ``tests/test_torch_rec_graph.py``
pin the copies to the originals.  ``fan_gfa`` is the port's own: a row
of modes 6/7 with more hub lanes than the column program's warp holds;
so is ``bubble_gfa``, whose long bubble moves a windowed fill's window
back by more than its width.
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


def fan_gfa(k: int) -> Gfa:
    """A node with ``k`` predecessors, each on a path of its own: in modes
    6/7 its row is a hard row with k hub lanes."""
    rng = random.Random(k)
    seq = lambda n: "".join(rng.choice("ACGT") for _ in range(n))  # noqa: E731
    gfa = Gfa()
    for nid in range(1, k + 3):
        gfa.segments[nid] = seq(3 if nid == 1 else 4 if nid == k + 2 else 2)
    for p in range(k):
        gfa.edges += [(1, p + 2), (p + 2, k + 2)]
        gfa.paths.append(GfaPath(f"p{p}", [1, p + 2, k + 2]))
    return gfa


def bubble_gfa(arm: int, flank: int = 40, seed: int = 0) -> Gfa:
    """Two flanks joined by two parallel arms of ``arm`` bp, each arm on a
    path of its own: the first row of the second arm follows the last row
    of the first in the row order, so a band that follows the read jumps
    back by about ``arm`` columns there (the port's own; K6's window
    shifts of W or more)."""
    rng = random.Random(seed)
    seq = lambda n: "".join(rng.choice("ACGT") for _ in range(n))  # noqa: E731
    gfa = Gfa()
    gfa.segments.update({1: seq(flank), 2: seq(arm), 3: seq(arm), 4: seq(flank)})
    gfa.edges += [(1, 2), (1, 3), (2, 4), (3, 4)]
    gfa.paths += [GfaPath("a", [1, 2, 4]), GfaPath("b", [1, 3, 4])]
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


# seeds found by branch-coverage search; together they exercise all four
# reverse-fill leak branches plus clean graphs
LEAK_SEEDS = [1, 4, 18, 71, 2, 7, 23, 42, 55, 103]


def fragment_gfa(seed: int) -> Gfa:
    """Random DAG with a mix of full source->sink paths and 1-2 node
    fragment paths (the shapes that produce leak rows)."""
    r = random.Random(seed)
    nn = r.randint(2, 8)
    gfa = Gfa()
    for nid in range(1, nn + 1):
        gfa.segments[nid] = "".join(r.choice("ACGT") for _ in range(r.randint(1, 3)))
    for nid in range(2, nn + 1):
        for p in r.sample(range(1, nid), min(r.randint(1, 2), nid - 1)):
            gfa.edges.append((p, nid))
    preds = gfa.predecessors()
    succs = gfa.successors()

    def walk(start):
        w = [start]
        while preds.get(w[0]):
            w.insert(0, r.choice(preds[w[0]]))
        while succs.get(w[-1]):
            w.append(r.choice(succs[w[-1]]))
        return w

    for k in range(r.randint(2, 4)):
        if r.random() < 0.5:
            gfa.paths.append(GfaPath(f"p{k}", walk(r.randint(1, nn))))
        else:
            s = r.randint(1, nn)
            frag = [s]
            if r.random() < 0.5 and succs.get(s):
                frag.append(r.choice(succs[s]))
            gfa.paths.append(GfaPath(f"p{k}", frag))
    covered = {x for p in gfa.paths for x in p.nodes}
    for nid in range(1, nn + 1):
        if nid not in covered:
            gfa.paths.append(GfaPath(f"c{nid}", walk(nid)))
    return gfa


def fragment_reads(r: random.Random, gfa: Gfa, k=2) -> list[str]:
    """k reads along random paths with 15 % substitutions and 8 %
    deletions (plus the '$' sentinel)."""
    out = []
    for _ in range(k):
        path = r.choice(gfa.paths)
        bases = []
        for nid in path.nodes:
            for c in gfa.segments[nid]:
                if r.random() < 0.15:
                    c = r.choice("ACGT")
                if r.random() > 0.08:
                    bases.append(c)
        out.append("$" + ("".join(bases) or "A"))
    return out
