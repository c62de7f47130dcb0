"""Edge gathers whose backward passes are sorted reductions on the kernels.

Port of ``gnn_tpu/ops/gather.py``. The forward of each is a plain
``index_select`` (``jnp.take`` in the JAX package too); the backward sums the
per-edge cotangents into their nodes without a scatter:

* :func:`gather_src_edges` (x[adj.src]): dx[s] = sum over edges with
  src_e = s of g_e, through K1 over the transpose CSR with ``col = t_perm``
  and no weight, so the kernel's row load does the permute to src order that
  ``gnn_tpu/ops/gather.py:64`` makes as a separate copy;
* :func:`gather_dst_edges` (x[adj.dst]): dx[d] = sum over the dst-sorted
  edges of row d, through K2 over ``row_ptr``.
"""

from __future__ import annotations

import torch

from gnn_tpu_torch.ops.cuda.segment import segment_sum_csr
from gnn_tpu_torch.ops.cuda.spmm import csr_spmm

__all__ = ["gather_src_edges", "gather_dst_edges"]


class _GatherSrc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj, ctx.shape = adj, x.shape
        return x.index_select(0, adj.src.long())

    @staticmethod
    def backward(ctx, g):
        adj = ctx.adj
        gf = g.reshape(g.shape[0], -1).contiguous()
        dx = csr_spmm(adj.t_row_ptr, adj.t_perm, None, gf)
        return dx.reshape(ctx.shape), None


class _GatherDst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj, ctx.shape = adj, x.shape
        return x.index_select(0, adj.dst.long())

    @staticmethod
    def backward(ctx, g):
        gf = g.reshape(g.shape[0], -1).contiguous()
        dx = segment_sum_csr(ctx.adj.row_ptr, gf)
        return dx.reshape(ctx.shape), None


def gather_src_edges(x: torch.Tensor, adj) -> torch.Tensor:
    """x_j = x[adj.src], x: [N_src, ...]; the VJP runs K1."""
    if x.shape[0] != adj.num_src_nodes:
        raise ValueError(f"expected {adj.num_src_nodes} source rows, got {x.shape[0]}")
    return _GatherSrc.apply(x, adj)


def gather_dst_edges(x: torch.Tensor, adj) -> torch.Tensor:
    """x_i = x[adj.dst], x: [N_dst, ...]; the VJP runs K2."""
    if x.shape[0] != adj.num_dst_nodes:
        raise ValueError(f"expected {adj.num_dst_nodes} destination rows, got {x.shape[0]}")
    return _GatherDst.apply(x, adj)
