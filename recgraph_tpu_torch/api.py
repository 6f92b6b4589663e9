"""Library API: one-call POA alignments (modes 0-3).

Counterpart of ``recgraph_tpu/api.py:28-105`` (reference: src/api.rs:11-164):
``align_global_no_gap``, ``align_global_gap``, ``align_local_no_gap``,
``align_local_gap`` and the score-matrix constructors.  Inputs are a raw
read string and a parsed GFA (``io.gfa.Gfa``); the graph is encoded on
each call, as the reference does (callers aligning many reads should use
``align.pipeline``, which encodes once).

Defaults are api.rs's: M=2, X=-4, a band of 0.1 of the read's length,
o=-10 and e=-6 for the gap modes (api.rs:20-21,56-58,116-118).  Each
call runs its one read through the CLI's engine and emitter
(``poa_engine.run_batch_walks``, ``native.gaf_emit_poa_walk``) on
``device``: the CUDA kernels on ``"cuda"`` (the default; it raises
without CUDA), their plain versions on ``"cpu"``.
"""

from __future__ import annotations

from . import _backend
from .align.pipeline import _emit_poa
from .graph.poagraph import PoaGraph
from .io.fasta import build_align_string
from .io.gaf import GafRecord
from .io.gfa import Gfa
from .ops import poa_engine
from .scoring import ScoreMatrix


def create_score_matrix_i32(match: int, mismatch: int) -> ScoreMatrix:
    """Mirrors api::create_score_matrix_i32 (api.rs:131-141)."""
    return ScoreMatrix.match_mismatch(match, mismatch)


def create_score_matrix_f32(match: float, mismatch: float) -> ScoreMatrix:
    """Mirrors api::create_score_matrix_f32 (api.rs:153-164).

    The engines are integer-exact, so the f32 variant shares the int
    table (the reference's f32 path exists only for its AVX2 SIMD).
    """
    return ScoreMatrix.match_mismatch(int(match), int(mismatch))


def _align(mode, read, gfa, name, score_matrix, bases_to_add, o, e, device) -> GafRecord:
    """One read through mode ``mode``'s engine on ``device``, as a record."""
    device = _backend.resolve_device(device)
    g = PoaGraph.from_gfa(gfa, amb_mode=False)
    sm = score_matrix or ScoreMatrix.match_mismatch(2, -4)
    bta = int(len(read) * (0.1 if bases_to_add is None else bases_to_add))
    seq = build_align_string(read)
    (st,) = poa_engine.run_batch_walks(mode, [seq], g, sm, o, e, [bta], device)
    return GafRecord.from_string(_emit_poa(mode, st, seq, name, False, g).to_string())


def align_global_no_gap(
    read: str,
    gfa: Gfa,
    sequence_name: str = "no_name",
    score_matrix: ScoreMatrix | None = None,
    bases_to_add: float | None = None,
    *,
    device="cuda",
) -> GafRecord:
    """Mirrors api::align_global_no_gap (api.rs:11-41)."""
    return _align(0, read, gfa, sequence_name, score_matrix, bases_to_add, -10, -6, device)


def align_global_gap(
    read: str,
    gfa: Gfa,
    sequence_name: str = "no_name",
    score_matrix: ScoreMatrix | None = None,
    bases_to_add: float | None = None,
    o: int = -10,
    e: int = -6,
    *,
    device="cuda",
) -> GafRecord:
    """Mirrors api::align_global_gap (api.rs:43-74)."""
    return _align(2, read, gfa, sequence_name, score_matrix, bases_to_add, o, e, device)


def align_local_no_gap(
    read: str,
    gfa: Gfa,
    sequence_name: str = "no_name",
    score_matrix: ScoreMatrix | None = None,
    *,
    device="cuda",
) -> GafRecord:
    """Mirrors api::align_local_no_gap (api.rs:76-100)."""
    return _align(1, read, gfa, sequence_name, score_matrix, 0, -10, -6, device)


def align_local_gap(
    read: str,
    gfa: Gfa,
    sequence_name: str = "no_name",
    score_matrix: ScoreMatrix | None = None,
    o: int = -10,
    e: int = -6,
    *,
    device="cuda",
) -> GafRecord:
    """Mirrors api::align_local_gap (api.rs:102-128)."""
    return _align(3, read, gfa, sequence_name, score_matrix, 0, o, e, device)
