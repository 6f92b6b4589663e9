"""Scalar oracle for POA modes 0-3 (copy of part of recgraph_tpu/oracle/).

Only the POA fills and their GAF emitters are copied; the pathwise and
recombination oracles belong to later slices.
"""

from . import gaf_emit, poa  # noqa: F401
