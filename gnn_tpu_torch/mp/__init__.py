"""Message-passing layers."""

from gnn_tpu_torch.mp.gat import GATConv
from gnn_tpu_torch.mp.gatv2 import GATv2Conv
from gnn_tpu_torch.mp.gcn import GCNConv
from gnn_tpu_torch.mp.gin import GINConv
from gnn_tpu_torch.mp.message_passing import MessagePassing
from gnn_tpu_torch.mp.sage import SAGEConv

__all__ = ["GATConv", "GATv2Conv", "GCNConv", "GINConv", "MessagePassing", "SAGEConv"]
