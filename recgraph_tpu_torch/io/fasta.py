"""FASTA reading and read preparation.

Copy of ``recgraph_tpu/io/fasta.py``; reads go through the port's
native reader (``csrc/host/io_native.cpp``) with no Python fallback.

Behavioural contract (reference: src/sequences.rs):

- multi-line FASTA; records delimited by '>' header lines.
- every base uppercased; '-' mapped to 'N' (sequences.rs:17-23).
- a '$' sentinel is prepended to every read (sequences.rs:30,37) so that
  DP matrices have a 0-column for the empty prefix.
- blank lines are skipped; a record-count / name-count mismatch is an
  error (sequences.rs:41-43).
"""

from __future__ import annotations

from .. import native


def _prepare(line: str) -> str:
    return line.upper().replace("-", "N")


def get_sequences(path: str) -> tuple[list[str], list[str]]:
    """Read a FASTA file -> ([ '$' + read, ... ], [name, ...]).

    Mirrors sequences.rs:5-45 including the '$' sentinel and '-'->'N'.
    """
    return native.read_fasta(path)


def build_align_string(read: str) -> str:
    """Prepare a raw read for alignment: '$' sentinel + normalisation.

    Mirrors sequences.rs:48-61 (library API entry point).
    """
    return "$" + _prepare(read)


_COMPL = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}


def rev_and_compl(seq: str) -> str:
    """Reverse-complement of a '$'-prefixed read, '$'-prefixed again.

    Mirrors sequences.rs:65-82 (used by the ambiguous-strand retry).
    """
    body = seq[1:]
    try:
        rc = "".join(_COMPL[c] for c in reversed(body))
    except KeyError as e:
        raise ValueError(f"wrong char: {e.args[0]}, unable to rev&compl")
    return "$" + rc
