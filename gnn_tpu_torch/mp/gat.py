"""GATConv — multi-head graph attention (GATv1, Velickovic et al.).

Port of ``gnn_tpu/mp/gat.py::GATConv``, per head:

    e_ij = LeakyReLU(a_dst . (W x_i) + a_src . (W x_j))
    alpha_ij = softmax over j in N(i) of e_ij
    h_i = sum_j alpha_ij (W x_j)

in the flash form of ``gnn_tpu/mp/gat.py:192-206``: the per-node scores
``a_src . h`` and ``a_dst . h`` are einsums, gathered to the edges
(:func:`~gnn_tpu_torch.ops.gather_src_edges`, whose VJP runs K1, and
:func:`~gnn_tpu_torch.ops.gather_dst_edges`, whose VJP runs K2); the scores
are shifted by their per-destination max and exponentiated; the numerator
sum_j ex_ij h_j runs on K3 (``ops/cuda/spmm_heads.py``) without the
[E, H * F] message array, and the denominator sum_j ex_ij on K2. Dropout
applies to the numerator's weights only. With the same dropout mask this
equals the JAX package's non-flash path (softmax, dropout of alpha, sum)
too, so the port has one path. On a node-partitioned
:class:`~gnn_tpu_torch.parallel.DistGraph` (x in its padded layout) the
layer is the JAX package's ``_forward_dist``: one exchange moves ``[h |
a_src . h]``, the softmax is local to each destination's part, and the
numerator and denominator reduce together by destination (K2).

``message_dtype`` (None = x's dtype) is the dtype of h and a_src . h on the
edges, as in the JAX package; scores, softmax and denominator stay float32.
Parameter names (``lin.weight``, ``att_src`` [H, F], ``att_dst`` [H, F],
``bias``) match the JAX module's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gnn_tpu_torch.graphs.adjacency import Adjacency
from gnn_tpu_torch.mp.message_passing import MessagePassing
from gnn_tpu_torch.nn import init as init_lib
from gnn_tpu_torch.nn.activations import leaky_relu
from gnn_tpu_torch.nn.dropout import dropout as dropout_fn
from gnn_tpu_torch.nn.linear import Linear
from gnn_tpu_torch.ops.cuda.spmm_heads import spmm_heads_csr
from gnn_tpu_torch.ops.gather import gather_dst_edges, gather_src_edges
from gnn_tpu_torch.ops.segment import segment_max, segment_sum_edges

__all__ = ["GATConv"]


def _segment_max_shift(adj: Adjacency, e: torch.Tensor) -> torch.Tensor:
    """Per-destination max of the edge scores, gathered back per edge and
    held constant in the backward. The shift must be per segment: a global
    max underflows every segment whose scores sit far below it. One
    plain-torch max for every layout: the JAX package's choice between
    ``edge_aggregate_max`` and ``segment_max`` (``gnn_tpu/mp/gat.py:52-57``)
    is between two layouts of the same max."""
    m = segment_max(e.detach(), adj.dst, adj.num_dst_nodes)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # empty segments
    return m.index_select(0, adj.dst.long())


class GATConv(MessagePassing):
    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        heads: int = 1,
        concat: bool = True,
        negative_slope: float = 0.2,
        dropout: float = 0.0,
        use_bias: bool = True,
        message_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
        dtype=torch.float32,
    ):
        super().__init__(aggr="sum")
        self.in_features = in_features
        self.out_features = out_features
        self.heads = heads
        self.concat = concat
        self.negative_slope = negative_slope
        self.dropout_rate = dropout
        self.message_dtype = message_dtype
        self.lin = Linear(in_features, heads * out_features, use_bias=False, generator=generator, dtype=dtype)
        self.att_src = nn.Parameter(
            init_lib.glorot_uniform((heads, out_features), generator=generator, dtype=dtype)
        )
        self.att_dst = nn.Parameter(
            init_lib.glorot_uniform((heads, out_features), generator=generator, dtype=dtype)
        )
        out_dim = heads * out_features if concat else out_features
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(out_dim, dtype=dtype))
        else:
            self.register_parameter("bias", None)

    def forward(
        self,
        x: torch.Tensor,
        adj: Adjacency,
        *,
        generator: Optional[torch.Generator] = None,
        return_attention: bool = False,
    ):
        """Returns [N_dst, H * F] (concat) or [N_dst, F] (mean over heads);
        with ``return_attention`` also alpha [E, H] in the adjacency's edge
        order (after dropout in training mode, as in the JAX package)."""
        if not isinstance(adj, Adjacency):
            if return_attention:
                raise ValueError(
                    "return_attention is single-device only (per-edge alphas live in the "
                    "parts' local edge orders)"
                )
            return self._forward_dist(x, adj, generator=generator)
        N, H, F = x.shape[0], self.heads, self.out_features
        n_out = adj.num_dst_nodes
        h = self.lin(x).view(N, H, F)
        alpha_src = torch.einsum("nhf,hf->nh", h, self.att_src.to(h.dtype))
        alpha_dst = torch.einsum("nhf,hf->nh", h, self.att_dst.to(h.dtype))
        mdt = self.message_dtype or x.dtype
        # a_src . h rides the edges in the message dtype, as it rides the
        # same gather as h in the JAX package (gnn_tpu/mp/gat.py:164-169).
        e = gather_dst_edges(alpha_dst[:n_out], adj).float() + gather_src_edges(
            alpha_src.to(mdt), adj
        ).float()
        e = leaky_relu(e, self.negative_slope)
        ex = torch.exp(e - _segment_max_shift(adj, e))  # [E, H]
        ex_num = dropout_fn(ex, self.dropout_rate, training=self.training, generator=generator)
        num = spmm_heads_csr(adj, h.to(mdt), ex_num).float()  # [N_dst, H, F]
        den = segment_sum_edges(ex, adj).clamp_min(1e-16)  # [N_dst, H]
        out = num / den[:, :, None]
        out = out.reshape(n_out, H * F) if self.concat else out.mean(dim=1)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        if return_attention:
            return out, ex_num / den.index_select(0, adj.dst.long())
        return out

    def _forward_dist(self, x: torch.Tensor, dist, *, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Port of ``gnn_tpu/mp/gat.py::_forward_dist`` (flash style, scores
        and softmax in float32)."""
        from gnn_tpu_torch.parallel.halo import (
            edge_reduce_by_dst,
            edge_valid_mask,
            gather_dst_dist,
            gather_src_dist,
        )

        H, F = self.heads, self.out_features
        N = x.shape[0]  # L n_max
        h = self.lin(x)  # padding rows stay zero (no bias)
        hh = h.view(N, H, F)
        alpha_src = torch.einsum("nhf,hf->nh", hh, self.att_src.to(h.dtype))
        alpha_dst = torch.einsum("nhf,hf->nh", hh, self.att_dst.to(h.dtype))
        ecat = gather_src_dist(dist, torch.cat([h, alpha_src], dim=1))  # one exchange: [E, H F + H]
        h_src = ecat[:, : H * F].view(-1, H, F)
        e = leaky_relu(ecat[:, H * F :].float() + gather_dst_dist(dist, alpha_dst).float(), self.negative_slope)
        valid = edge_valid_mask(dist)[:, None]
        neg = torch.finfo(e.dtype).min
        e = torch.where(valid, e, torch.full_like(e, neg))
        m = edge_reduce_by_dst(dist, e.detach(), op="max")  # per-segment shift, local
        m = torch.where(m > neg / 2, m, torch.zeros_like(m))  # empty / padding-only segments
        ex = torch.exp(e - gather_dst_dist(dist, m))
        ex = torch.where(valid, ex, torch.zeros_like(ex))
        ex_num = dropout_fn(ex, self.dropout_rate, training=self.training, generator=generator)
        combined = torch.cat([(ex_num[:, :, None] * h_src.float()).reshape(-1, H * F), ex], dim=1)
        agg = edge_reduce_by_dst(dist, combined)  # [N, H F + H]
        out = agg[:, : H * F].view(N, H, F) / agg[:, H * F :].clamp_min(1e-16)[:, :, None]
        out = out.reshape(N, H * F) if self.concat else out.mean(dim=1)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out
