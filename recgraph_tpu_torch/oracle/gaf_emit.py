"""Traceback walkers + GAF emission for POA modes 0-3.

Copy of ``recgraph_tpu/oracle/gaf_emit.py``.

Ports of reference src/gaf_output.rs (cited per function).  ``hofp`` is
a list[str] mapping lnz position -> GFA node id ("-1" at position 0),
the dense equivalent of the reference's HashMap.

These walkers are shared by the oracle and the production pipeline: the
device kernels return score planes, the host re-derives directions with
the same tie rules used at fill time, producing identical (pred, dir)
matrices, and these emitters turn them into GAF lines.
"""

from __future__ import annotations

from ..io.gaf import GafRecord
from .poa import PoaState


def set_cigar_substring(count_m: int, count_i: int, count_d: int, cs: str) -> str:
    """Mirrors gaf_output.rs:876-892."""
    if (count_m * count_i) + (count_i * count_d) + (count_m * count_d) != 0:
        raise RuntimeError("wrong format in cigar string")
    if count_m > 0:
        return f"{count_m}M{cs}"
    if count_i > 0:
        return f"{count_i}I{cs}"
    if count_d > 0:
        return f"{count_d}D{cs}"
    return cs


def node_start(hofp: list[str], row: int) -> int:
    """Offset-within-node helper; mirrors gaf_output.rs:867-874."""
    handle_id = hofp[row]
    i = row
    while hofp[i] == handle_id and i > 0:
        i -= 1
    return row - i


def gaf_of_global_abpoa(
    st: PoaState, sequence: str, seq_name: str, amb_mode: bool, hofp: list[str]
) -> GafRecord:
    """Mirrors gaf_of_global_abpoa (gaf_output.rs:254-381)."""
    path, ampl = st.path, st.ampl
    col, row = st.last_col, st.last_row

    handle_id_alignment: list[str] = []
    cigars: list[str] = []
    cigar = ""
    count_m = count_i = count_d = 0
    curr_handle = ""
    last_dir = " "
    path_length = 0
    residue_matching = 0

    while path[row][col][1] != "O":
        pred, direction = path[row][col]
        if hofp[row] != curr_handle:
            cigar = set_cigar_substring(count_m, count_i, count_d, cigar)
            cigars.insert(0, cigar)
            cigar = ""
            count_m = count_i = count_d = 0
        curr_handle = hofp[row]
        if direction.upper() != last_dir.upper():
            cigar = set_cigar_substring(count_m, count_i, count_d, cigar)
            count_m = count_i = count_d = 0
        last_dir = direction

        p_left = ampl[pred][0]
        j_pos = col + ampl[row][0] - p_left
        if direction == "D":
            handle_id_alignment.append(hofp[row])
            row, col = pred, j_pos - 1
            count_m += 1
            path_length += 1
            residue_matching += 1
        elif direction == "d":
            handle_id_alignment.append(hofp[row])
            row, col = pred, j_pos - 1
            count_m += 1
            path_length += 1
        elif direction == "L":
            col -= 1
            count_d += 1
        elif direction == "U":
            handle_id_alignment.append(hofp[row])
            row, col = pred, j_pos
            count_i += 1
            path_length += 1
        else:
            raise RuntimeError("impossible value in poa path")
    cigar = set_cigar_substring(count_m, count_i, count_d, cigar)
    cigars.insert(0, cigar)

    handle_id_alignment = _dedup(handle_id_alignment)
    handle_id_alignment.reverse()

    return GafRecord(
        query_name=seq_name,
        query_length=len(sequence) - 1,
        query_start=col,
        query_end=st.last_col + ampl[st.last_row][0],
        strand="-" if amb_mode else "+",
        path=[int(h) for h in handle_id_alignment],
        path_length=path_length,
        path_start=node_start(hofp, row),
        path_end=node_start(hofp, st.last_row),
        residue_matches_number=residue_matching,
        alignment_block_length="*",
        mapping_quality="*",
        comments=",".join(cigars[:-1]),
    )


def gaf_of_local_poa(
    st: PoaState, sequence: str, seq_name: str, amb_mode: bool, hofp: list[str]
) -> GafRecord:
    """Mirrors gaf_of_local_poa (gaf_output.rs:383-500)."""
    path = st.path
    col, row = st.last_col, st.last_row

    handle_id_alignment: list[str] = []
    cigars: list[str] = []
    cigar = ""
    count_m = count_i = count_d = 0
    curr_handle = ""
    last_dir = " "
    path_length = 0
    residue_matching = 0

    while path[row][col][1] != "O":
        pred, direction = path[row][col]
        if hofp[row] != curr_handle:
            cigar = set_cigar_substring(count_m, count_i, count_d, cigar)
            cigars.insert(0, cigar)
            cigar = ""
            count_m = count_i = count_d = 0
        curr_handle = hofp[row]
        if direction.upper() != last_dir.upper():
            cigar = set_cigar_substring(count_m, count_i, count_d, cigar)
            count_m = count_i = count_d = 0
        last_dir = direction

        if direction == "D":
            handle_id_alignment.append(hofp[row])
            row, col = pred, col - 1
            count_m += 1
            path_length += 1
            residue_matching += 1
        elif direction == "d":
            handle_id_alignment.append(hofp[row])
            row, col = pred, col - 1
            count_m += 1
            path_length += 1
        elif direction == "L":
            col -= 1
            count_d += 1
        elif direction == "U":
            handle_id_alignment.append(hofp[row])
            row = pred
            count_i += 1
            path_length += 1
        else:
            raise RuntimeError("impossible value in poa path")
    cigar = set_cigar_substring(count_m, count_i, count_d, cigar)
    cigars.insert(0, cigar)

    handle_id_alignment = _dedup(handle_id_alignment)
    handle_id_alignment.reverse()

    return GafRecord(
        query_name=seq_name,
        query_length=len(sequence) - 1,
        query_start=col,
        query_end=st.last_col,
        strand="-" if amb_mode else "+",
        path=[int(h) for h in handle_id_alignment],
        path_length=path_length,
        path_start=node_start(hofp, row),
        path_end=node_start(hofp, st.last_row),
        residue_matches_number=residue_matching,
        alignment_block_length="*",
        mapping_quality="*",
        comments=",".join(cigars[:-1]),
    )


def gaf_of_gap_abpoa(
    st: PoaState, sequence: str, seq_name: str, amb_mode: bool, hofp: list[str]
) -> GafRecord:
    """Mirrors gaf_of_gap_abpoa (gaf_output.rs:96-253)."""
    path, path_x, path_y, ampl = st.path, st.path_x, st.path_y, st.ampl
    col, row = st.last_col, st.last_row

    handle_id_alignment: list[str] = []
    cigars: list[str] = []
    cigar = ""
    count_m = count_i = count_d = 0
    curr_handle = ""
    last_dir = " "
    path_length = 0
    residue_matching = 0

    while path[row][col][1] != "O":
        pred, direction = path[row][col]
        if hofp[row] != curr_handle:
            cigar = set_cigar_substring(count_m, count_i, count_d, cigar)
            cigars.insert(0, cigar)
            cigar = ""
            count_m = count_i = count_d = 0
        curr_handle = hofp[row]
        if direction.upper() != last_dir.upper():
            cigar = set_cigar_substring(count_m, count_i, count_d, cigar)
            count_m = count_i = count_d = 0
        last_dir = direction

        p_left = ampl[pred][0]
        j_pos = col + ampl[row][0] - p_left
        if direction == "D":
            handle_id_alignment.append(hofp[row])
            row, col = pred, j_pos - 1
            count_m += 1
            path_length += 1
            residue_matching += 1
        elif direction == "d":
            handle_id_alignment.append(hofp[row])
            row, col = pred, j_pos - 1
            count_m += 1
            path_length += 1
        elif direction == "L":
            if path_x[row][col][1] == "X":
                while path_x[row][col][1] == "X":
                    count_d += 1
                    col -= 1
            else:
                count_d += 1
                col -= 1
        elif direction == "U":
            if path_y[row][col][1] == "Y":
                while path_y[row][col][1] == "Y":
                    left_row = ampl[row][0]
                    p = path_y[row][col][0]
                    left_p = ampl[p][0]
                    handle_id_alignment.append(hofp[row])
                    count_i += 1
                    path_length += 1
                    col = col + left_row - left_p
                    row = p
            else:
                handle_id_alignment.append(hofp[row])
                count_i += 1
                path_length += 1
                row, col = pred, j_pos
        else:
            raise RuntimeError("impossible value in poa path")
    cigar = set_cigar_substring(count_m, count_i, count_d, cigar)
    cigars.insert(0, cigar)

    handle_id_alignment = _dedup(handle_id_alignment)
    handle_id_alignment.reverse()

    return GafRecord(
        query_name=seq_name,
        query_length=len(sequence) - 1,
        query_start=col,
        query_end=st.last_col + ampl[st.last_row][0],
        strand="-" if amb_mode else "+",
        path=[int(h) for h in handle_id_alignment],
        path_length=path_length,
        path_start=node_start(hofp, row),
        path_end=node_start(hofp, st.last_row),
        residue_matches_number=residue_matching,
        alignment_block_length="*",
        mapping_quality="*",
        comments=",".join(cigars[:-1]),
    )


def gaf_of_gap_local_poa(
    st: PoaState, sequence: str, seq_name: str, amb_mode: bool, hofp: list[str]
) -> GafRecord:
    """Mirrors gaf_of_gap_local_poa (gaf_output.rs:502-637)."""
    path, path_x, path_y = st.path, st.path_x, st.path_y
    col, row = st.last_col, st.last_row

    handle_id_alignment: list[str] = []
    cigars: list[str] = []
    cigar = ""
    count_m = count_i = count_d = 0
    curr_handle = ""
    last_dir = " "
    path_length = 0
    residue_matching = 0

    while path[row][col][1] != "O":
        pred, direction = path[row][col]
        if hofp[row] != curr_handle:
            cigar = set_cigar_substring(count_m, count_i, count_d, cigar)
            cigars.insert(0, cigar)
            cigar = ""
            count_m = count_i = count_d = 0
        curr_handle = hofp[row]
        if direction.upper() != last_dir.upper():
            cigar = set_cigar_substring(count_m, count_i, count_d, cigar)
            count_m = count_i = count_d = 0
        last_dir = direction

        if direction == "D":
            handle_id_alignment.append(hofp[row])
            row, col = pred, col - 1
            count_m += 1
            path_length += 1
            residue_matching += 1
        elif direction == "d":
            handle_id_alignment.append(hofp[row])
            row, col = pred, col - 1
            count_m += 1
            path_length += 1
        elif direction == "L":
            if path_x[row][col][1] == "X":
                while path_x[row][col][1] == "X":
                    count_d += 1
                    col -= 1
            else:
                count_d += 1
                col -= 1
        elif direction == "U":
            if path_y[row][col][1] == "Y":
                while path_y[row][col][1] == "Y":
                    p = path_y[row][col][0]
                    handle_id_alignment.append(hofp[row])
                    row = p
                    count_i += 1
                    path_length += 1
            else:
                handle_id_alignment.append(hofp[row])
                count_i += 1
                path_length += 1
                row = pred
        else:
            raise RuntimeError("impossible value in poa path")
    cigar = set_cigar_substring(count_m, count_i, count_d, cigar)
    cigars.insert(0, cigar)

    handle_id_alignment = _dedup(handle_id_alignment)
    handle_id_alignment.reverse()

    return GafRecord(
        query_name=seq_name,
        query_length=len(sequence) - 1,
        query_start=col,
        query_end=st.last_col,
        strand="-" if amb_mode else "+",
        path=[int(h) for h in handle_id_alignment],
        path_length=path_length,
        path_start=node_start(hofp, row),
        path_end=node_start(hofp, st.last_row),
        residue_matches_number=residue_matching,
        alignment_block_length="*",
        mapping_quality="*",
        comments=",".join(cigars[:-1]),
    )


def _dedup(items: list[str]) -> list[str]:
    """Rust Vec::dedup — collapse *consecutive* duplicates."""
    out: list[str] = []
    for it in items:
        if not out or out[-1] != it:
            out.append(it)
    return out


def build_cigar(cigar: list[str]) -> str:
    """Run-length CIGAR: D->M, U->I, L->D, d->X.

    Mirrors pathwise_alignment_output.rs:471-556 (also used by the POA
    SIMD emitters in the reference).
    """
    out = []
    d_count = u_count = l_count = mm_count = 0
    for ch in cigar:
        if ch == "D":
            if u_count:
                out.append(f"{u_count}I")
                u_count = 0
            if l_count:
                out.append(f"{l_count}D")
                l_count = 0
            if mm_count:
                out.append(f"{mm_count}X")
                mm_count = 0
            d_count += 1
        elif ch == "U":
            if d_count:
                out.append(f"{d_count}M")
                d_count = 0
            if l_count:
                out.append(f"{l_count}D")
                l_count = 0
            if mm_count:
                out.append(f"{mm_count}X")
                mm_count = 0
            u_count += 1
        elif ch == "d":
            if d_count:
                out.append(f"{d_count}M")
                d_count = 0
            if l_count:
                out.append(f"{l_count}D")
                l_count = 0
            if u_count:
                out.append(f"{u_count}I")
                u_count = 0
            mm_count += 1
        else:
            if d_count:
                out.append(f"{d_count}M")
                d_count = 0
            if u_count:
                out.append(f"{u_count}I")
                u_count = 0
            if mm_count:
                out.append(f"{mm_count}X")
                mm_count = 0
            l_count += 1
    if d_count:
        out.append(f"{d_count}M")
    if u_count:
        out.append(f"{u_count}I")
    if l_count:
        out.append(f"{l_count}D")
    if mm_count:
        out.append(f"{mm_count}X")
    return "".join(out)
