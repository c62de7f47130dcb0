"""GIN model.

Port of ``gnn_tpu/models/gin.py::GIN``: stacked GINConv (each an MLP of two
``hidden_features`` layers) and a Linear head; with ``graph_id`` and
``num_graphs`` (from :class:`gnn_tpu_torch.graphs.Batch`) the node features
are summed per graph before the head. Parameter names
(``convs.{i}.mlp.blocks.layers.{j}.weight``, ``convs.{i}.eps``,
``head.blocks.layers.0.weight``) match the JAX model's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gnn_tpu_torch.graphs.adjacency import Adjacency
from gnn_tpu_torch.mp.gin import GINConv
from gnn_tpu_torch.nn.containers import MLP
from gnn_tpu_torch.ops.segment import segment_sum

__all__ = ["GIN"]


class GIN(nn.Module):
    def __init__(
        self,
        in_features: int,
        hidden_features: int,
        out_features: int,
        *,
        num_layers: int = 2,
        train_eps: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dims = [in_features] + [hidden_features] * num_layers
        self.convs = nn.ModuleList(
            GINConv(d, [hidden_features, hidden_features], train_eps=train_eps, generator=generator)
            for d in dims[:-1]
        )
        self.head = MLP(dims[-1], [out_features], generator=generator)

    def forward(
        self,
        x: torch.Tensor,
        adj: Adjacency,
        *,
        generator: Optional[torch.Generator] = None,
        graph_id: Optional[torch.Tensor] = None,
        num_graphs: int = 0,
    ) -> torch.Tensor:
        """Node-level logits, or graph-level ones with ``graph_id`` and
        ``num_graphs``."""
        for conv in self.convs:
            x = conv(x, adj, generator=generator)
        if graph_id is not None:
            x = segment_sum(x, graph_id, num_graphs)
        return self.head(x)

    def forward_sampled(
        self,
        x: torch.Tensor,
        adjs: Sequence[Adjacency],
        *,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Minibatch forward over one bipartite adjacency per hop (outermost
        first): the protocol of ``GraphSAGE.forward_sampled``."""
        n = len(self.convs)
        if len(adjs) != n:
            raise ValueError(f"need {n} hop adjacencies, got {len(adjs)}")
        for conv, adj in zip(self.convs, adjs):
            x = conv(x, adj, x[: adj.num_dst_nodes], generator=generator)
        return self.head(x)
