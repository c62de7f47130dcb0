"""Models."""

from gnn_tpu_torch.models.gat import GAT
from gnn_tpu_torch.models.gcn import GCN

__all__ = ["GAT", "GCN"]
