"""Synthetic graph datasets (numpy host code)."""
from .graphs import (citeseer_like, clustered_like, cora_like,
                     dynamic_graph_stream, planetoid_like)

__all__ = ["cora_like", "citeseer_like", "planetoid_like", "clustered_like",
           "dynamic_graph_stream"]
