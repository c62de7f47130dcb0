"""Message-passing layers."""

from gnn_tpu_torch.mp.gcn import GCNConv
from gnn_tpu_torch.mp.message_passing import MessagePassing

__all__ = ["GCNConv", "MessagePassing"]
