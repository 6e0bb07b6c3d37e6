"""Collectives of the port over an explicit shard dimension
(`dist.compress`)."""
