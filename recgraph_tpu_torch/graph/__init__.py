"""The POA graph (copy of recgraph_tpu/graph/poagraph.py)."""

from .poagraph import PoaGraph  # noqa: F401
