"""Models."""

from gnn_tpu_torch.models.gat import GAT
from gnn_tpu_torch.models.gcn import GCN, EncoderGCN
from gnn_tpu_torch.models.gin import GIN
from gnn_tpu_torch.models.sage import GraphSAGE

__all__ = ["GAT", "GCN", "EncoderGCN", "GIN", "GraphSAGE"]
