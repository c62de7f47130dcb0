"""Message-passing protocol.

Port of ``gnn_tpu/mp/message_passing.py::MessagePassing``: PyG-style
``message -> aggregate -> update`` hooks behind a ``propagate`` method, over
the adjacency's dst-sorted edges. The hooks run plain torch gathers and
segment reductions; a layer with a fused kernel (GCNConv's SpMM) bypasses
``propagate``.

* ``message(x_i, x_j, edge_attr)``: per-edge messages, default ``x_j`` (the
  source features); ``x_i`` are the destination features.
* ``aggregate(messages, dst, num_nodes)``: segment reduction by destination,
  ``aggr`` one of sum/mean/max/min; empty max/min segments come out 0.
* ``update(aggr_out, x)``: post-aggregation transform, default identity.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gnn_tpu_torch.graphs.adjacency import Adjacency
from gnn_tpu_torch.ops import segment as seg

__all__ = ["MessagePassing"]

_AGGRS = {
    "sum": seg.segment_sum,
    "mean": seg.segment_mean,
    "max": seg.segment_max,
    "min": seg.segment_min,
}


class MessagePassing(nn.Module):
    def __init__(self, aggr: str = "sum"):
        super().__init__()
        if aggr not in _AGGRS:
            raise ValueError(f"unknown aggr '{aggr}', expected one of {tuple(_AGGRS)}")
        self.aggr = aggr

    def message(
        self, x_i: torch.Tensor, x_j: torch.Tensor, edge_attr: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        del x_i, edge_attr
        return x_j

    def aggregate(self, messages: torch.Tensor, dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
        out = _AGGRS[self.aggr](messages, dst, num_nodes)
        if self.aggr in ("max", "min"):
            out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
        return out

    def update(self, aggr_out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        del x
        return aggr_out

    def propagate(
        self, adj: Adjacency, x: torch.Tensor, edge_attr: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        x_j = x.index_select(0, adj.src.long())
        x_i = x.index_select(0, adj.dst.long())
        msgs = self.message(x_i, x_j, edge_attr)
        return self.update(self.aggregate(msgs, adj.dst, adj.num_dst_nodes), x)
