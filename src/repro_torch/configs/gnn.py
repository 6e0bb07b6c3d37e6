"""The paper's model configs (Section V): 2-layer GCN, GAT and GraphSAGE
on Cora/Citeseer-shaped graphs, hidden width 64, GAT 8 heads of 8, SAGE
fan-out 10 with the mean or max aggregator.
"""
from __future__ import annotations

from repro_torch.core.models import GNNConfig

CORA_FEATS, CORA_CLASSES = 1433, 7
CITESEER_FEATS, CITESEER_CLASSES = 3703, 6


def gcn(dataset: str = "cora") -> GNNConfig:
    f, c = ((CORA_FEATS, CORA_CLASSES) if dataset == "cora"
            else (CITESEER_FEATS, CITESEER_CLASSES))
    return GNNConfig(kind="gcn", in_feats=f, hidden=64, num_classes=c)


def gat(dataset: str = "cora") -> GNNConfig:
    f, c = ((CORA_FEATS, CORA_CLASSES) if dataset == "cora"
            else (CITESEER_FEATS, CITESEER_CLASSES))
    return GNNConfig(kind="gat", in_feats=f, hidden=64, num_classes=c, heads=8)


def sage(dataset: str = "cora", aggregator: str = "mean") -> GNNConfig:
    f, c = ((CORA_FEATS, CORA_CLASSES) if dataset == "cora"
            else (CITESEER_FEATS, CITESEER_CLASSES))
    return GNNConfig(kind="sage", in_feats=f, hidden=64, num_classes=c,
                     aggregator=aggregator, max_neighbors=10)


GNN_MODELS = {
    "gcn": gcn, "gat": gat,
    "sage-mean": lambda d="cora": sage(d, "mean"),
    "sage-max": lambda d="cora": sage(d, "max"),
}
