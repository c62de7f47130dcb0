"""GATv2Conv — multi-head graph attention with dynamic attention (Brody,
Alon and Yahav, "How Attentive are Graph Attention Networks?", ICLR 2022;
PyG's ``GATv2Conv`` with ``share_weights=False``), per head:

    e_ij = sum_f a[f] * LeakyReLU(W_dst x_i + W_src x_j)[f]
    alpha_ij = softmax over j in N(i) of e_ij
    h_i = sum_j alpha_ij (W_src x_j)

The LeakyReLU sits inside the dot product, so the score does not split into
per-node terms as GAT's does: it is one fused op over the edges
(:func:`~gnn_tpu_torch.ops.cuda.gatv2_score.gatv2_score_edges`, a hand-written
kernel forward and backward on the card). From the scores on the layer is
GAT's (:func:`~gnn_tpu_torch.mp.gat.attend`): the softmax by destination
(shift, ``exp`` and denominator in one kernel), dropout of the numerator's
weights and the numerator on K3. Parameter names: ``lin_src.weight`` and
``lin_dst.weight`` [H * F, d_in] (no bias), ``att`` [H, F], ``bias``;
Glorot initialisation as GATConv's. float32.

The layer takes one device's full-graph :class:`Adjacency`; a
node-partitioned ``DistGraph`` raises, and the model has no
``forward_sampled``: both paths are left for later.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gnn_tpu_torch.graphs.adjacency import Adjacency
from gnn_tpu_torch.mp.gat import attend
from gnn_tpu_torch.mp.message_passing import MessagePassing
from gnn_tpu_torch.nn import init as init_lib
from gnn_tpu_torch.nn.linear import Linear
from gnn_tpu_torch.ops.cuda.gatv2_score import gatv2_score_edges

__all__ = ["GATv2Conv"]


class GATv2Conv(MessagePassing):
    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        heads: int = 1,
        concat: bool = True,
        negative_slope: float = 0.2,
        dropout: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(aggr="sum")
        self.in_features = in_features
        self.out_features = out_features
        self.heads = heads
        self.concat = concat
        self.negative_slope = negative_slope
        self.dropout_rate = dropout
        width = heads * out_features
        self.lin_src = Linear(in_features, width, use_bias=False, generator=generator)
        self.lin_dst = Linear(in_features, width, use_bias=False, generator=generator)
        self.att = nn.Parameter(init_lib.glorot_uniform((heads, out_features), generator=generator))
        self.bias = nn.Parameter(torch.zeros(width if concat else out_features, dtype=torch.float32))

    def forward(
        self, x: torch.Tensor, adj: Adjacency, *, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """Returns [N_dst, H * F] (concat) or [N_dst, F] (mean over heads)."""
        if not isinstance(adj, Adjacency):
            raise ValueError(
                f"GATv2Conv takes one device's full-graph Adjacency, got {type(adj).__name__}: the "
                "partitioned DistGraph path (dist.num_parts > 1) and sampled minibatches are not supported"
            )
        H, F = self.heads, self.out_features
        h_src = self.lin_src(x).view(x.shape[0], H, F)
        # the whole x where every node is a destination: a slice would cost
        # its backward a zeroed copy of x's gradient
        x_dst = x if adj.num_dst_nodes == x.shape[0] else x[: adj.num_dst_nodes]
        h_dst = self.lin_dst(x_dst).view(adj.num_dst_nodes, H, F)
        e = gatv2_score_edges(adj, h_src, h_dst, self.att, self.negative_slope)  # [E, H]
        return attend(self, adj, e, h_src, generator=generator)
