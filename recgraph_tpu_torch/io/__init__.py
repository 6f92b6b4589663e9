"""FASTA, GFA and GAF I/O (copy of recgraph_tpu/io/)."""

from . import fasta, gaf, gfa  # noqa: F401
