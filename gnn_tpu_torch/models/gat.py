"""GAT and GATv2 models.

:class:`GAT` is the port of ``gnn_tpu/models/gat.py::GAT``: multi-head
attention layers, for each layer dropout then GATConv, ELU between layers;
hidden layers concatenate their heads, the output layer averages
``out_heads`` heads. Parameter names (``convs.{i}.lin.weight``,
``convs.{i}.att_src``, ``convs.{i}.att_dst``, ``convs.{i}.bias``) match the
JAX model's, so :func:`gnn_tpu_torch.nn.load_jax_state_dict` carries its
weights over. The dropout generator of ``forward`` is threaded through the
input dropouts and the attention dropouts in turn.

:class:`GATv2` is the same stack of :class:`~gnn_tpu_torch.mp.gatv2.GATv2Conv`
layers (parameters ``convs.{i}.lin_src.weight``, ``convs.{i}.lin_dst.weight``,
``convs.{i}.att``, ``convs.{i}.bias``), full graph only: it has no
``forward_sampled``, so ``fit`` refuses it with ``train.batch_size > 0``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gnn_tpu_torch.graphs.adjacency import Adjacency
from gnn_tpu_torch.mp.gat import GATConv
from gnn_tpu_torch.mp.gatv2 import GATv2Conv
from gnn_tpu_torch.nn.activations import elu
from gnn_tpu_torch.nn.dropout import Dropout

__all__ = ["GAT", "GATv2"]


class _AttentionStack(nn.Module):
    """``num_layers`` attention convs of ``conv``: ``heads`` heads of
    ``hidden_features`` concatenated in the hidden layers, ``out_heads``
    heads over ``out_features`` averaged in the last; each layer's input
    dropped out, ELU between the layers."""

    def __init__(self, conv, in_features, hidden_features, out_features, *, num_layers, heads, out_heads,
                 dropout, **conv_kwargs):
        super().__init__()
        convs = []
        d_in = in_features
        for i in range(num_layers):
            last = i == num_layers - 1
            convs.append(
                conv(
                    d_in,
                    out_features if last else hidden_features,
                    heads=out_heads if last else heads,
                    concat=not last,
                    dropout=dropout,
                    **conv_kwargs,
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


class GAT(_AttentionStack):
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
        super().__init__(
            GATConv, in_features, hidden_features, out_features, num_layers=num_layers, heads=heads,
            out_heads=out_heads, dropout=dropout, message_dtype=message_dtype, generator=generator,
        )

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


class GATv2(_AttentionStack):
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
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(
            GATv2Conv, in_features, hidden_features, out_features, num_layers=num_layers, heads=heads,
            out_heads=out_heads, dropout=dropout, generator=generator,
        )
