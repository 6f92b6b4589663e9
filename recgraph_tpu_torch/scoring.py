"""Substitution score matrices as dense int32 tables.

Copy of ``recgraph_tpu/scoring.py``; the HOXD tables are the port's own
copies in ``recgraph_tpu_torch/data/``.

The reference keeps scores in ``HashMap<(char,char), i32>``
(reference: src/score_matrix.rs).  On TPU we want a dense
``int32[7,7]`` lookup indexed by base codes, which XLA turns into a
cheap gather.

Alphabet codes (module-wide convention):

====  ====
base  code
====  ====
A     0
C     1
G     2
T     3
N     4
'-'   5   (gap pseudo-base; row/col used for indel scores)
$/F   6   (sentinels; never scored, row/col kept at 0)
====  ====

Reference quirks preserved:

- match/mismatch builder: the gap entry ``(c,'-')`` is ``2 * mismatch``
  (score_matrix.rs:41-42), ``('N','N')`` is forced to *mismatch*
  (score_matrix.rs:48), and ``('-','-')`` is absent (we keep it 0 and it
  is never read).
- HOXD70/HOXD55 matrices: 5x5 body from the .mtx file; every
  ``(c,'-')``/``('-',c)`` entry is hardcoded to -200
  (score_matrix.rs:99-102).
"""

from __future__ import annotations

import os

import numpy as np

ALPHABET = "ACGTN-"
A, C, G, T, N, GAP = range(6)
SENTINEL = 6  # '$' and 'F'

_CODE = {"A": A, "C": C, "G": G, "T": T, "N": N, "-": GAP, "$": SENTINEL, "F": SENTINEL}


def encode(s: str) -> np.ndarray:
    """Encode a base string into int8 codes (see module table)."""
    try:
        return np.array([_CODE[c] for c in s], dtype=np.int8)
    except KeyError as e:
        raise ValueError(f"unknown base {e.args[0]!r}") from None


def decode(codes) -> str:
    table = "ACGTN-?"
    return "".join(table[int(c)] for c in codes)


class ScoreMatrix:
    """Dense int32[7,7] substitution table over the ALPHABET codes."""

    def __init__(self, table: np.ndarray):
        assert table.shape == (7, 7) and table.dtype == np.int32
        self.table = table

    def get(self, a: str, b: str) -> int:
        return int(self.table[_CODE[a], _CODE[b]])

    @classmethod
    def match_mismatch(cls, m: int, x: int) -> "ScoreMatrix":
        """Mirrors create_score_matrix_match_mis (score_matrix.rs:35-51).

        ``x`` must already be the *negated* CLI value (args_parser.rs:155).
        """
        t = np.zeros((7, 7), dtype=np.int32)
        for i in range(6):
            for j in range(6):
                if i == j:
                    t[i, j] = m
                elif i == GAP or j == GAP:
                    t[i, j] = 2 * x
                else:
                    t[i, j] = x
        t[N, N] = x  # ('N','N') forced to mismatch (score_matrix.rs:48)
        t[GAP, GAP] = 0  # entry removed in the reference; never read
        return cls(t)

    @classmethod
    def from_mtx_file(cls, path: str) -> "ScoreMatrix":
        """Load a HOXD-style 5x5 whitespace table.

        Mirrors create_score_matrix_from_matrix_file
        (score_matrix.rs:67-105): header row of bases, body of scores,
        gap entries hardcoded to -200.
        """
        with open(path) as fh:
            rows = [line.split() for line in fh if line.strip()]
        header = rows[0]
        t = np.zeros((7, 7), dtype=np.int32)
        for row in rows[1:]:
            c1 = row[0]
            for j, val in enumerate(row[1:]):
                c2 = header[j]
                t[_CODE[c1], _CODE[c2]] = int(val)
        for ch in "ACGTN":
            t[_CODE[ch], GAP] = -200
            t[GAP, _CODE[ch]] = -200
        return cls(t)

    @classmethod
    def create(cls, matrix_type: str, match: int, mismatch_neg: int) -> "ScoreMatrix":
        """CLI-level dispatch, mirrors create_score_matrix (score_matrix.rs:21-34).

        HOXD matrices are looked up next to this package's data dir first
        and then in the current directory (the reference resolves them
        from the project root, score_matrix.rs:69).
        """
        if matrix_type in ("HOXD70.mtx", "HOXD70", "HOXD55.mtx", "HOXD55"):
            fname = matrix_type if matrix_type.endswith(".mtx") else matrix_type + ".mtx"
            for base in (os.path.join(os.path.dirname(__file__), "data"), os.getcwd()):
                p = os.path.join(base, fname)
                if os.path.exists(p):
                    return cls.from_mtx_file(p)
            raise FileNotFoundError(fname)
        if matrix_type == "none":
            return cls.match_mismatch(match, mismatch_neg)
        raise ValueError("wrong matrix type")
