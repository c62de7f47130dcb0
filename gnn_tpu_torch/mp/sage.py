"""GraphSAGE convolution.

Port of ``gnn_tpu/mp/sage.py::SAGEConv``:

    h_i = W_self x_i + W_neigh * aggr_{j in N(i)} w_ij x_j   (+ optional L2 norm)

The messages are the source features scaled by the adjacency's edge weights
(when it has any). ``sum`` and ``mean`` are one SpMM over the CSR (kernel K1
on the card); ``mean`` then divides by the destination's *edge count*
clamped to 1 (``segment_mean``'s denominator), not by its weight sum. ``max``
has no kernel in the JAX package either: it is ``scatter_reduce('amax')``
over the weighted messages, with the rows of destinations without in-edges
set to 0. With a bipartite adjacency (a sampled hop: fewer destinations than
sources) pass ``x_dst``. On a node-partitioned
:class:`~gnn_tpu_torch.parallel.DistGraph` (x in its padded layout) sum and
mean run ``spmm_dist`` and divide by the partition's in-degrees; max gathers
the source rows per edge and takes the per-destination max.
"""

from __future__ import annotations

from typing import Optional

import torch

from gnn_tpu_torch.graphs.adjacency import Adjacency
from gnn_tpu_torch.mp.message_passing import MessagePassing
from gnn_tpu_torch.nn.linear import Linear
from gnn_tpu_torch.ops.sddmm import gather_src
from gnn_tpu_torch.ops.segment import segment_max
from gnn_tpu_torch.ops.spmm import spmm

__all__ = ["SAGEConv"]


class SAGEConv(MessagePassing):
    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        aggr: str = "mean",
        use_bias: bool = True,
        normalize: bool = False,
        generator: Optional[torch.Generator] = None,
        dtype=torch.float32,
    ):
        if aggr not in ("mean", "sum", "max"):
            raise ValueError(f"unknown aggr '{aggr}'")
        super().__init__(aggr=aggr)
        self.in_features = in_features
        self.out_features = out_features
        self.normalize = normalize
        self.lin_self = Linear(in_features, out_features, use_bias=use_bias, generator=generator, dtype=dtype)
        self.lin_neigh = Linear(in_features, out_features, use_bias=False, generator=generator, dtype=dtype)

    def forward(
        self, x: torch.Tensor, adj: Adjacency, x_dst: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """x: source-node features [N_src, F]; ``x_dst`` [N_dst, F] defaults
        to x (full-graph use)."""
        if not isinstance(adj, Adjacency):
            return self._forward_dist(x, adj)
        if x_dst is None:
            x_dst = x
        if self.aggr == "max":
            msgs = gather_src(x, adj.src)
            if adj.weight is not None:
                msgs = msgs * adj.weight[:, None].to(msgs.dtype)
            agg = segment_max(msgs, adj.dst, adj.num_dst_nodes, indices_are_sorted=True)
            agg = torch.where(torch.isfinite(agg), agg, torch.zeros_like(agg))
        else:
            agg = spmm(adj, x)
            if self.aggr == "mean":
                count = (adj.row_ptr[1:] - adj.row_ptr[:-1]).clamp_min(1)
                agg = agg / count[:, None].to(agg.dtype)
        out = self.lin_self(x_dst) + self.lin_neigh(agg)
        if self.normalize:
            out = out / torch.linalg.norm(out, dim=-1, keepdim=True).clamp_min(1e-12)
        return out

    def _forward_dist(self, x: torch.Tensor, dist) -> torch.Tensor:
        """Port of ``gnn_tpu/mp/sage.py::_forward_dist``: the single-device
        semantics (baked weights scale the messages, 'mean' divides by the
        edge count) over the parts."""
        from gnn_tpu_torch.parallel.halo import edge_reduce_by_dst, gather_src_dist

        deg = dist.in_degree.reshape(-1)
        if self.aggr in ("mean", "sum"):
            agg = spmm(dist, x)
            if self.aggr == "mean":
                agg = agg / deg.clamp_min(1.0)[:, None].to(agg.dtype)
        else:
            if dist.has_weight:
                raise ValueError(
                    "SAGE aggr='max' on a weight-baked DistGraph: the single-device path maxes "
                    "WEIGHTED messages, but baked weights are not exposed in the edge-parallel "
                    "order; partition_graph without edge_weight for max aggregation"
                )
            agg = edge_reduce_by_dst(dist, gather_src_dist(dist, x), op="max")
            agg = torch.where(deg[:, None] > 0, agg, torch.zeros_like(agg))  # -inf on deg-0 rows
        out = self.lin_self(x) + self.lin_neigh(agg)
        if self.normalize:
            out = out / torch.linalg.norm(out, dim=-1, keepdim=True).clamp_min(1e-12)
        return out
