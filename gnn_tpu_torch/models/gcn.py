"""GCN models.

Port of ``gnn_tpu/models/gcn.py``. :class:`GCN` is the Kipf-Welling N-layer
GCN: for each layer dropout, then GCNConv, then ReLU between layers.
:class:`EncoderGCN` is the reference's flagship model: a ``pre`` MLP (F -> 2F
-> F), k x [GCNConv with the BatchNorm/ReLU mid-block, tanh], a ``post`` MLP
to the classes. Parameter names (``convs.{i}.lin.weight``,
``convs.{i}.bias``, ``pre.blocks.layers.{j}.weight``, ...) match the JAX
models', so :func:`gnn_tpu_torch.nn.load_jax_state_dict` carries their
weights over.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gnn_tpu_torch.graphs.adjacency import Adjacency
from gnn_tpu_torch.mp.gcn import GCNConv
from gnn_tpu_torch.nn.activations import relu, tanh
from gnn_tpu_torch.nn.containers import MLP
from gnn_tpu_torch.nn.dropout import Dropout

__all__ = ["GCN", "EncoderGCN"]


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


class EncoderGCN(nn.Module):
    def __init__(
        self,
        in_features: int,
        n_classes: int,
        *,
        num_layers: int = 2,
        dropout: float = 0.0,
        backend: str = "auto",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.pre = MLP(in_features, [2 * in_features, in_features], dropout=dropout, generator=generator)
        self.convs = nn.ModuleList(
            GCNConv(
                in_features, in_features,
                mid_block=True, dropout=dropout, backend=backend, generator=generator,
            )
            for _ in range(num_layers)
        )
        self.post = MLP(in_features, [n_classes], generator=generator)

    def forward(
        self,
        x: torch.Tensor,
        adj: Adjacency,
        *,
        generator: Optional[torch.Generator] = None,
        mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``mask`` ([N] bool) leaves rows out of the BatchNorm statistics
        of every conv (for padded node layouts)."""
        x = self.pre(x, generator=generator)
        for conv in self.convs:
            x = tanh(conv(x, adj, generator=generator, mask=mask))
        return self.post(x, generator=generator)
