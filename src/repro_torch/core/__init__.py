"""Host graph preprocessing, GCN layers, models and execution plans."""
