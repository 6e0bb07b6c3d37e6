"""Synthetic data (numpy host code): graph datasets and the LM token
stream."""
from .graphs import (citeseer_like, clustered_like, cora_like,
                     dynamic_graph_stream, planetoid_like)
from .synthetic import TokenStream, lm_batch_iterator

__all__ = ["cora_like", "citeseer_like", "planetoid_like", "clustered_like",
           "dynamic_graph_stream", "TokenStream", "lm_batch_iterator"]
