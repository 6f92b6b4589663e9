"""Minimal GFA1 parser.

Copy of ``recgraph_tpu/io/gfa.py``.

The reference consumes GFA through the `gfa` + `handlegraph` crates
(reference: src/graph.rs:11-17, src/pathwise_graph.rs:127-133) with
integer segment names (`GFA<usize, ()>`).  We parse the same subset
directly:

- ``S <id> <seq>``            segments (integer ids, DNA sequence)
- ``L <a> <ao> <b> <bo> <ov>`` links (edges), any +/- orientations
- ``P <name> <a+,b-,...> ...`` paths (haplotypes), in file order; the
  path id is the P-line index, matching HashGraph path-handle creation
  order (pathwise_graph.rs:176-178).

Orientation semantics match what the reference actually *does* with
them, not what GFA means by them:

- Path step orientations are ignored entirely — the reference reads
  only ``handle.id()`` per step (pathwise_graph.rs:196-233), so ``3-``
  behaves exactly like ``3+``.
- Link orientations select the adjacency bucket the edge lands in.
  The linearisation always uses each node's *forward* sequence
  (graph.rs:47-52 iterates forward handles); predecessors come from
  handlegraph's left-edge iteration of forward handles
  (graph.rs:75-88), which for an L line ``a ao b bo`` yields:
  pred(b) += a iff bo == '+', and pred(a) += b iff ao == '-'
  (the implied flipped edge flip(b,bo) -> flip(a,ao)).  An ``a + b -``
  line is therefore invisible to the forward graph — a preserved
  reference quirk, not a bug here.
- The amb-strand graph iterates *flipped* handles (graph.rs:34-40), so
  its predecessor rule is the mirror: pred(b) += a iff bo == '-', and
  pred(a) += b iff ao == '+'.

Node iteration everywhere downstream is by *numerically sorted id*
(graph.rs:32-33 `sorted_handles.sort()`), and the reference requires ids
to be in topological order (graph.rs:10).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class GfaPath:
    name: str
    nodes: list[int]


@dataclass
class Gfa:
    """In-memory GFA: segments, edges, haplotype paths.

    ``edges`` holds plain (a, b) pairs and implies all-'+' orientations
    (the common case, and what tests construct directly);
    ``oriented_edges`` — (a, ao, b, bo) in file order — takes precedence
    when set by the parser on input containing '-' links.
    """

    segments: dict[int, str] = field(default_factory=dict)
    edges: list[tuple[int, int]] = field(default_factory=list)
    paths: list[GfaPath] = field(default_factory=list)
    oriented_edges: list[tuple[int, str, int, str]] | None = None

    @property
    def sorted_ids(self) -> list[int]:
        return sorted(self.segments)

    def _oriented(self) -> list[tuple[int, str, int, str]]:
        if self.oriented_edges is not None:
            return self.oriented_edges
        return [(a, "+", b, "+") for a, b in self.edges]

    def predecessors(self) -> dict[int, list[int]]:
        """node id -> predecessor ids (forward-handle left edges,
        graph.rs:75-88), in edge-insertion order, deduplicated."""
        preds: dict[int, list[int]] = {nid: [] for nid in self.segments}
        for a, ao, b, bo in self._oriented():
            if bo == "+" and a not in preds[b]:
                preds[b].append(a)
            if ao == "-" and b not in preds[a]:
                preds[a].append(b)
        return preds

    def successors(self) -> dict[int, list[int]]:
        """node id -> predecessor ids of the *flipped* graph (amb-strand
        handle.flip() iteration, graph.rs:34-40)."""
        succs: dict[int, list[int]] = {nid: [] for nid in self.segments}
        for a, ao, b, bo in self._oriented():
            if bo == "-" and a not in succs[b]:
                succs[b].append(a)
            if ao == "+" and b not in succs[a]:
                succs[a].append(b)
        return succs


def parse_gfa(path: str) -> Gfa:
    gfa = Gfa()
    oriented: list[tuple[int, str, int, str]] = []
    any_minus = False
    with open(path) as fh:
        for raw in fh:
            line = raw.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            tag = fields[0]
            if tag == "S":
                if len(fields) < 3:
                    raise ValueError(f"bad S line: {line!r}")
                gfa.segments[int(fields[1])] = fields[2].upper()
            elif tag == "L":
                if len(fields) < 5:
                    raise ValueError(f"bad L line: {line!r}")
                a, ao, b, bo = fields[1], fields[2], fields[3], fields[4]
                if ao not in "+-" or bo not in "+-":
                    raise ValueError(f"bad link orientations: {line!r}")
                any_minus |= ao == "-" or bo == "-"
                oriented.append((int(a), ao, int(b), bo))
                gfa.edges.append((int(a), int(b)))
            elif tag == "P":
                if len(fields) < 3:
                    raise ValueError(f"bad P line: {line!r}")
                nodes = []
                for step in fields[2].split(","):
                    if not step:
                        continue
                    orient = step[-1]
                    if orient not in "+-":
                        raise ValueError(f"bad path step: {step!r}")
                    # orientation ignored: the reference consumes only
                    # handle.id() per step (pathwise_graph.rs:196-233)
                    nodes.append(int(step[:-1]))
                gfa.paths.append(GfaPath(fields[1], nodes))
            # H and other lines ignored
    if any_minus:
        gfa.oriented_edges = oriented
    return gfa
