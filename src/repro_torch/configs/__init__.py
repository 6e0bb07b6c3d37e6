"""The paper's model configs (GCN in this slice of the port)."""
