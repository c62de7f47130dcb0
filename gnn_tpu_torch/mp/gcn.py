"""GCNConv — graph convolution over the exact symmetric normalization.

Port of ``gnn_tpu/mp/gcn.py::GCNConv``: ``Linear`` without bias, then the
SpMM against the adjacency's ``gcn_norm`` weights (kernel K1 on the card),
then the bias. ``mid_block=False`` is the standard PyG GCNConv;
``mid_block=True`` is the reference's recipe, with BatchNorm -> ReLU (->
Dropout, built only when ``dropout > 0``) between the Linear and the SpMM.
The BatchNorm's running statistics are buffers of the module. ``backend`` is
passed on to :func:`gnn_tpu_torch.ops.spmm`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gnn_tpu_torch.graphs.adjacency import Adjacency
from gnn_tpu_torch.mp.message_passing import MessagePassing
from gnn_tpu_torch.nn import init as init_lib
from gnn_tpu_torch.nn.activations import relu
from gnn_tpu_torch.nn.dropout import Dropout
from gnn_tpu_torch.nn.linear import Linear
from gnn_tpu_torch.nn.normalization import BatchNorm
from gnn_tpu_torch.ops.spmm import spmm

__all__ = ["GCNConv"]


class GCNConv(MessagePassing):
    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        use_bias: bool = True,
        mid_block: bool = False,
        dropout: float = 0.0,
        backend: str = "auto",
        generator: Optional[torch.Generator] = None,
        dtype=torch.float32,
    ):
        super().__init__(aggr="sum")
        self.in_features = in_features
        self.out_features = out_features
        self.use_mid_block = mid_block
        self.backend = backend
        self.lin = Linear(in_features, out_features, use_bias=False, generator=generator, dtype=dtype)
        if use_bias:
            self.bias = nn.Parameter(
                init_lib.kaiming_uniform(
                    (out_features,), fan_in=in_features, generator=generator, dtype=dtype
                )
            )
        else:
            self.register_parameter("bias", None)
        self.batch_norm = BatchNorm(out_features, dtype=dtype) if mid_block else None
        self.dropout = Dropout(rate=dropout) if mid_block and dropout > 0 else None

    def forward(
        self,
        x: torch.Tensor,
        adj: Adjacency,
        *,
        generator: Optional[torch.Generator] = None,
        mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """adj must carry the gcn_norm edge weights
        (``Data.to_adjacency(norm='sym')``). ``mask`` ([N] bool) leaves rows
        out of the mid-block BatchNorm's statistics."""
        h = self.lin(x)
        if self.use_mid_block:
            h = relu(self.batch_norm(h, mask=mask))
            if self.dropout is not None:
                h = self.dropout(h, generator=generator)
        out = spmm(adj, h, backend=self.backend)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out
