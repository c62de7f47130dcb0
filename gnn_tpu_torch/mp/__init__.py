"""Message-passing layers."""

from gnn_tpu_torch.mp.gat import GATConv
from gnn_tpu_torch.mp.gcn import GCNConv
from gnn_tpu_torch.mp.message_passing import MessagePassing

__all__ = ["GATConv", "GCNConv", "MessagePassing"]
