"""GIN — Graph Isomorphism Network convolution.

    h_i = MLP((1 + eps) * x_i + sum_{j in N(i)} x_j)

Port of ``gnn_tpu/mp/gin.py::GINConv``. The sum is the SpMM with the
adjacency's weights dropped (kernel K1 with a null weight on the card); the
MLP has LayerNorm between its layers. ``eps`` is a parameter (it is in the
JAX package's ``state_dict``), trained only with ``train_eps=True``. With
``train_eps=False`` it gets no gradient here and every optimizer skips it,
while the JAX package hands its optimizer a zero gradient, so that a
*non-zero* frozen eps still moves there under weight decay; at the default
``eps = 0`` the two agree.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gnn_tpu_torch.graphs.adjacency import Adjacency
from gnn_tpu_torch.mp.message_passing import MessagePassing
from gnn_tpu_torch.nn.containers import MLP
from gnn_tpu_torch.ops.spmm import spmm

__all__ = ["GINConv"]


class GINConv(MessagePassing):
    def __init__(
        self,
        in_features: int,
        hidden_features: Sequence[int],
        *,
        eps: float = 0.0,
        train_eps: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(aggr="sum")
        self.mlp = MLP(in_features, hidden_features, use_norm=True, generator=generator)
        self.eps = nn.Parameter(torch.tensor(eps, dtype=torch.float32), requires_grad=train_eps)
        self.train_eps = train_eps

    def forward(
        self,
        x: torch.Tensor,
        adj: Adjacency,
        x_dst: Optional[torch.Tensor] = None,
        *,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """x: source-node features; ``x_dst`` [N_dst, F] defaults to x
        (full-graph use)."""
        if x_dst is None:
            x_dst = x
        agg = spmm(adj.unweighted(), x)
        return self.mlp((1.0 + self.eps).to(x.dtype) * x_dst + agg, generator=generator)
