"""GCN model.

Port of ``gnn_tpu/models/gcn.py::GCN``, the Kipf-Welling N-layer GCN: for each
layer dropout, then GCNConv, then ReLU between layers. Parameter names
(``convs.{i}.lin.weight``, ``convs.{i}.bias``) match the JAX model's, so
:func:`gnn_tpu_torch.nn.load_jax_state_dict` carries its weights over.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gnn_tpu_torch.graphs.adjacency import Adjacency
from gnn_tpu_torch.mp.gcn import GCNConv
from gnn_tpu_torch.nn.activations import relu
from gnn_tpu_torch.nn.dropout import Dropout

__all__ = ["GCN"]


class GCN(nn.Module):
    def __init__(
        self,
        in_features: int,
        hidden_features: int,
        out_features: int,
        *,
        num_layers: int = 2,
        dropout: float = 0.5,
        backend: str = "auto",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dims = [in_features] + [hidden_features] * (num_layers - 1) + [out_features]
        self.convs = nn.ModuleList(
            GCNConv(d_in, d_out, backend=backend, generator=generator)
            for d_in, d_out in zip(dims[:-1], dims[1:])
        )
        self.dropout = Dropout(rate=dropout)

    def forward(
        self, x: torch.Tensor, adj: Adjacency, *, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        n = len(self.convs)
        for i, conv in enumerate(self.convs):
            x = conv(self.dropout(x, generator=generator), adj)
            if i < n - 1:
                x = relu(x)
        return x
