"""GAT model.

Port of ``gnn_tpu/models/gat.py::GAT``: multi-head attention layers, for each
layer dropout then GATConv, ELU between layers; hidden layers concatenate
their heads, the output layer averages ``out_heads`` heads. Parameter names
(``convs.{i}.lin.weight``, ``convs.{i}.att_src``, ``convs.{i}.att_dst``,
``convs.{i}.bias``) match the JAX model's, so
:func:`gnn_tpu_torch.nn.load_jax_state_dict` carries its weights over. The
dropout generator of ``forward`` is threaded through the input dropouts and
the attention dropouts in turn.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gnn_tpu_torch.graphs.adjacency import Adjacency
from gnn_tpu_torch.mp.gat import GATConv
from gnn_tpu_torch.nn.activations import elu
from gnn_tpu_torch.nn.dropout import Dropout

__all__ = ["GAT"]


class GAT(nn.Module):
    def __init__(
        self,
        in_features: int,
        hidden_features: int,
        out_features: int,
        *,
        num_layers: int = 2,
        heads: int = 8,
        out_heads: int = 1,
        dropout: float = 0.6,
        message_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        convs = []
        d_in = in_features
        for i in range(num_layers):
            last = i == num_layers - 1
            convs.append(
                GATConv(
                    d_in,
                    out_features if last else hidden_features,
                    heads=out_heads if last else heads,
                    concat=not last,
                    dropout=dropout,
                    message_dtype=message_dtype,
                    generator=generator,
                )
            )
            d_in = hidden_features * heads
        self.convs = nn.ModuleList(convs)
        self.dropout = Dropout(rate=dropout)

    def forward(
        self, x: torch.Tensor, adj: Adjacency, *, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        n = len(self.convs)
        for i, conv in enumerate(self.convs):
            x = conv(self.dropout(x, generator=generator), adj, generator=generator)
            if i < n - 1:
                x = elu(x)
        return x

    def forward_sampled(
        self,
        x: torch.Tensor,
        adjs: Sequence[Adjacency],
        *,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Minibatch forward over one bipartite adjacency per hop (outermost
        first): the protocol of ``GraphSAGE.forward_sampled``. Each conv
        takes the hop's destinations from the prefix of its input itself.
        As in the JAX package, this path applies the attention dropout only,
        not ``forward``'s dropout of each layer's input."""
        n = len(self.convs)
        if len(adjs) != n:
            raise ValueError(f"need {n} hop adjacencies, got {len(adjs)}")
        for i, (conv, adj) in enumerate(zip(self.convs, adjs)):
            x = conv(x, adj, generator=generator)
            if i < n - 1:
                x = elu(x)
        return x
