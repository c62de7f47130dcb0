"""GCNConv — graph convolution over the exact symmetric normalization.

Port of ``gnn_tpu/mp/gcn.py::GCNConv`` with ``mid_block=False`` (the
standard PyG GCNConv): ``Linear`` without bias, then the SpMM against the
adjacency's ``gcn_norm`` weights (kernel K1 on the card), then the bias. The
reference's BatchNorm/ReLU mid-block (``mid_block=True``) comes with the
EncoderGCN port and raises until then. ``backend`` is passed on to
:func:`gnn_tpu_torch.ops.spmm`, which accepts it for parity with the JAX
package only.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gnn_tpu_torch.graphs.adjacency import Adjacency
from gnn_tpu_torch.mp.message_passing import MessagePassing
from gnn_tpu_torch.nn import init as init_lib
from gnn_tpu_torch.nn.linear import Linear
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
        backend: str = "auto",
        generator: Optional[torch.Generator] = None,
        dtype=torch.float32,
    ):
        if mid_block:
            raise NotImplementedError(
                "GCNConv(mid_block=True) needs BatchNorm and comes with the "
                "EncoderGCN port (ROADMAP Queue 1 items 4-5)"
            )
        super().__init__(aggr="sum")
        self.in_features = in_features
        self.out_features = out_features
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

    def forward(self, x: torch.Tensor, adj: Adjacency) -> torch.Tensor:
        """adj must carry the gcn_norm edge weights
        (``Data.to_adjacency(norm='sym')``)."""
        out = spmm(adj, self.lin(x), backend=self.backend)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out
