"""Scalar oracles, copied from ``recgraph_tpu/oracle/``: the POA fills
and their GAF emitters (modes 0-3), the pathwise DP (modes 4/5), the
pathwise affine-gap DP (modes 6/7) and the recombination DP (modes
8/9)."""

from . import gaf_emit, poa  # noqa: F401
