"""The paper's GCN config (Section V): 2-layer GCN on Cora/Citeseer-shaped
graphs, hidden width 64. GAT and SAGE arrive with their slice of the port.
"""
from __future__ import annotations

from repro_torch.core.models import GNNConfig

CORA_FEATS, CORA_CLASSES = 1433, 7
CITESEER_FEATS, CITESEER_CLASSES = 3703, 6


def gcn(dataset: str = "cora") -> GNNConfig:
    f, c = ((CORA_FEATS, CORA_CLASSES) if dataset == "cora"
            else (CITESEER_FEATS, CITESEER_CLASSES))
    return GNNConfig(kind="gcn", in_feats=f, hidden=64, num_classes=c)


GNN_MODELS = {"gcn": gcn}
