"""Command line interface (counterpart of recgraph_tpu/cli.py:18-141).

Flag-compatible with the reference CLI (reference: src/args_parser.rs):

    recgraph-tpu-torch [options] <reads.fa> <graph.gfa>

with -m/-M/-X/-t/-O/-E/-r/-R/-B/-s/-b/-f/-o, plus ``--engine
{torch,oracle}`` and ``--device {cuda,cpu}``.  The device defaults to
``cuda``; without CUDA the run raises rather than moving to the CPU.
``--num-processes/--process-id/--coordinator`` make a multi-process run
(``parallel.distributed``; it needs ``-o``).  ``--no-data-parallel`` is
accepted for recgraph_tpu's flag set: a CLI run never splits its reads
over the host's GPUs (``parallel.mesh``).
"""

from __future__ import annotations

import argparse

from .align.pipeline import Options, run


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="recgraph-tpu-torch",
        description="GPU sequence-to-variation-graph aligner "
        "(RecGraph-compatible CLI; PyTorch/CUDA port of recgraph-tpu)",
    )
    p.add_argument("sequence_path", help="Input sequences (.fasta)")
    p.add_argument("graph_path", help="Input graph (.gfa)")
    p.add_argument(
        "-o", "--out_file", default="standard output", help="Output alignment file"
    )
    p.add_argument(
        "-m",
        "--aln-mode",
        dest="alignment_mode",
        type=int,
        default=0,
        help="0: global POA, 1: local POA, 2: affine gap POA, 3: local gap POA, "
        "4: global pathwise, 5: semiglobal pathwise, 6/7: pathwise affine gap "
        "(EXPERIMENTAL), 8: global recombination, 9: semiglobal recombination",
    )
    p.add_argument("-M", "--match", dest="match_score", type=int, default=2)
    p.add_argument("-X", "--mismatch", dest="mismatch_score", type=int, default=4)
    p.add_argument(
        "-t",
        "--matrix",
        default="none",
        help="Scoring matrix file (HOXD70/HOXD55); overrides -M/-X",
    )
    p.add_argument("-O", "--gap-open", dest="gap_open", type=int, default=4)
    p.add_argument("-E", "--gap-ext", dest="gap_extension", type=int, default=2)
    p.add_argument(
        "-r", "--multi-rec-cost", dest="multi_rec_cost", type=float, default=0.1
    )
    p.add_argument(
        "-R", "--base-rec-cost", dest="base_rec_cost", type=int, default=4
    )
    p.add_argument(
        "-B", "--rec-band-width", dest="rec_band_width", type=float, default=1.0
    )
    p.add_argument(
        "-s",
        "--amb-strand",
        dest="amb_strand",
        choices=["true", "false"],
        default="false",
    )
    p.add_argument("-b", "--extra-b", dest="extra_b", type=int, default=1)
    p.add_argument("-f", "--extra-f", dest="extra_f", type=float, default=0.01)
    p.add_argument(
        "--engine",
        choices=["torch", "oracle"],
        default="torch",
        help="compute engine: batched GPU kernels (torch) or the scalar spec (oracle)",
    )
    p.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="device of the torch engine; cpu runs the kernels' plain versions",
    )
    # scale-out: multi-process data parallelism
    p.add_argument(
        "--num-processes",
        dest="num_processes",
        type=int,
        default=1,
        help="number of host processes in a multi-process run",
    )
    p.add_argument(
        "--process-id",
        dest="process_id",
        type=int,
        default=None,
        help="this process's index in [0, num-processes)",
    )
    p.add_argument(
        "--coordinator",
        dest="coordinator",
        default=None,
        help="address of process 0's rendezvous (host:port)",
    )
    p.add_argument(
        "--no-data-parallel",
        dest="no_data_parallel",
        action="store_true",
        help="accepted for recgraph_tpu's flag set; runs never split their reads "
        "over the host's GPUs",
    )
    return p


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    opts = Options(
        sequence_path=args.sequence_path,
        graph_path=args.graph_path,
        out_file=args.out_file,
        alignment_mode=args.alignment_mode,
        match_score=args.match_score,
        mismatch_score=args.mismatch_score,
        matrix=args.matrix,
        gap_open=args.gap_open,
        gap_extension=args.gap_extension,
        multi_rec_cost=args.multi_rec_cost,
        base_rec_cost=args.base_rec_cost,
        rec_band_width=args.rec_band_width,
        amb_strand=(args.amb_strand == "true"),
        extra_b=args.extra_b,
        extra_f=args.extra_f,
        engine=args.engine,
        device=args.device,
        num_processes=args.num_processes,
        process_id=args.process_id,
        coordinator=args.coordinator,
    )
    run(opts)


if __name__ == "__main__":
    main()
