"""Edge gathers whose backward passes are sorted reductions on the kernels.

Port of ``gnn_tpu/ops/gather.py``. The forward of each is a plain
``index_select`` (``jnp.take`` in the JAX package too); the backward sums the
per-edge cotangents into their nodes without a scatter, through
:func:`~gnn_tpu_torch.ops.edge_agg.edge_aggregate` over the adjacency's
edge-position CSRs (``Adjacency.edge_agg_layouts``: views of its arrays,
for every layout; the JAX package takes its slot tables where present,
``gnn_tpu/ops/gather.py:56-61, 93-96``):

* :func:`gather_src_edges` (x[adj.src]): dx[s] = sum over edges with
  src_e = s of g_e, through K1 over the transpose CSR with ``col = t_perm``
  and no weight, so the kernel's row load does the permute to src order that
  ``gnn_tpu/ops/gather.py:64`` makes as a separate copy;
* :func:`gather_dst_edges` (x[adj.dst]): dx[d] = sum over the dst-sorted
  edges of row d, through K2 over ``row_ptr``.

Each forward runs in the span ``agg.<function>`` and its backward in
``agg.<function>.bwd``.
"""

from __future__ import annotations

import torch

from gnn_tpu_torch.ops.edge_agg import _edge_aggregate
from gnn_tpu_torch.utils.tracing import span

__all__ = ["gather_src_edges", "gather_dst_edges"]


class _GatherEdges(torch.autograd.Function):
    """x[ids] forward; backward the edge-position CSR ``lay`` that sums
    each node's edges, in the span ``<name>.bwd``."""

    @staticmethod
    def forward(ctx, x, ids, lay, name):
        ctx.lay, ctx.shape, ctx.name = lay, x.shape, name
        return x.index_select(0, ids.long())

    @staticmethod
    def backward(ctx, g):
        with span(ctx.name + ".bwd"):
            gf = g.reshape(g.shape[0], -1)
            return _edge_aggregate(gf, ctx.lay).reshape(ctx.shape), None, None, None


def gather_src_edges(x: torch.Tensor, adj) -> torch.Tensor:
    """x_j = x[adj.src], x: [N_src, ...]; the VJP runs K1."""
    if x.shape[0] != adj.num_src_nodes:
        raise ValueError(f"expected {adj.num_src_nodes} source rows, got {x.shape[0]}")
    with span("agg.gather_src_edges"):
        return _GatherEdges.apply(x, adj.src, adj.edge_agg_layouts()[1], "agg.gather_src_edges")


def gather_dst_edges(x: torch.Tensor, adj) -> torch.Tensor:
    """x_i = x[adj.dst], x: [N_dst, ...]; the VJP runs K2."""
    if x.shape[0] != adj.num_dst_nodes:
        raise ValueError(f"expected {adj.num_dst_nodes} destination rows, got {x.shape[0]}")
    with span("agg.gather_dst_edges"):
        return _GatherEdges.apply(x, adj.dst, adj.edge_agg_layouts()[0], "agg.gather_dst_edges")
