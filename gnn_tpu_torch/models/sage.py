"""GraphSAGE model.

Port of ``gnn_tpu/models/sage.py::GraphSAGE``: SAGEConv layers with ReLU and
dropout between them. Parameter names (``convs.{i}.lin_self.weight``,
``convs.{i}.lin_self.bias``, ``convs.{i}.lin_neigh.weight``) match the JAX
model's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gnn_tpu_torch.graphs.adjacency import Adjacency
from gnn_tpu_torch.mp.sage import SAGEConv
from gnn_tpu_torch.nn.activations import relu
from gnn_tpu_torch.nn.dropout import Dropout

__all__ = ["GraphSAGE"]


class GraphSAGE(nn.Module):
    def __init__(
        self,
        in_features: int,
        hidden_features: int,
        out_features: int,
        *,
        num_layers: int = 2,
        aggr: str = "mean",
        dropout: float = 0.5,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dims = [in_features] + [hidden_features] * (num_layers - 1) + [out_features]
        self.convs = nn.ModuleList(
            SAGEConv(d_in, d_out, aggr=aggr, generator=generator)
            for d_in, d_out in zip(dims[:-1], dims[1:])
        )
        self.dropout = Dropout(rate=dropout)

    def forward(
        self, x: torch.Tensor, adj: Adjacency, *, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        n = len(self.convs)
        for i, conv in enumerate(self.convs):
            x = conv(x, adj)
            if i < n - 1:
                x = self.dropout(relu(x), generator=generator)
        return x

    def forward_sampled(
        self,
        x: torch.Tensor,
        adjs: Sequence[Adjacency],
        *,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Minibatch forward over one bipartite adjacency per hop (outermost
        first), as neighbour sampling makes them; x holds the features of the
        sampled node list. After hop i only the first
        ``adjs[i].num_dst_nodes`` rows remain."""
        n = len(self.convs)
        if len(adjs) != n:
            raise ValueError(f"need {n} hop adjacencies, got {len(adjs)}")
        for i, (conv, adj) in enumerate(zip(self.convs, adjs)):
            x = conv(x, adj, x[: adj.num_dst_nodes])
            if i < n - 1:
                x = self.dropout(relu(x), generator=generator)
        return x
