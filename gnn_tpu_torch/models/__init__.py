"""Models."""

from gnn_tpu_torch.models.gat import GAT, GATv2
from gnn_tpu_torch.models.gcn import GCN, EncoderGCN
from gnn_tpu_torch.models.gin import GIN
from gnn_tpu_torch.models.sage import GraphSAGE

__all__ = ["GAT", "GATv2", "GCN", "EncoderGCN", "GIN", "GraphSAGE"]
