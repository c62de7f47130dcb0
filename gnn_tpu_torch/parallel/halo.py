"""Distributed SpMM and the edge-parallel primitives over a partitioned graph.

Port of ``gnn_tpu/parallel/halo.py``. Every op is a
``torch.autograd.Function`` whose backward is the JAX package's custom VJP,
and every per-part product or reduction is one launch of a hand-written
kernel over the CSRs of :mod:`~gnn_tpu_torch.parallel.partition`, all local
parts at once: K1 (``csr_spmm``) for the products, K2 (``segment_sum_csr``)
for the reductions by destination. On the CPU their plain versions run.

The exchange of a targeted mode (``'alltoall'``, ``'overlap'``) gathers the
rows each part sends. Within one process that gather already lays them out
as the parts receive them (the JAX ``all_to_all`` is the transpose of the
gathered [L, P, H, F] rows, and the gather reads them in that order); in a
``torch.distributed`` group one ``all_to_all_single`` with equal splits moves
them between the processes of the mesh's data axis (``DistGraph.group``, the
mesh's ``data_group``: every process unless a model axis spans processes).
``'allgather'`` is the identity in one process and ``all_gather_into_tensor``
in a group; its reverse, ``reduce_scatter_tensor``.

* :func:`spmm_dist`: out = A x. allgather: gather, K1 over ``adj``; backward:
  gather g, K1 over ``t_adj``. alltoall: K1 over ``[own | recv]``. overlap:
  K1 over the owned rows, ``torch.bmm`` over the ``diag`` blocks
  (``local_blocked``; their transpose in the backward), K1 over the recv
  slots.
* :func:`gather_src_dist`: per-edge source rows; VJP: K1 over the incidence
  CSR (partials by buffer row), then the remote partials go back to their
  owners and K1 over the ``send`` CSR adds them to the owned rows, without a
  scatter or atomics (the JAX package adds them with ``.at[].add``).
* :func:`gather_dst_dist` / :func:`edge_reduce_by_dst` (``'sum'``): each the
  VJP of the other; the reduction is K2 over ``dst_row_ptr``, whose extra
  row a part collects the padding edges. ``'max'``: the port's plain
  ``segment_max``, -inf on rows without in-edges.
* :func:`spmm_dist_dynw`: the two composed, differentiable in the weights.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as tdist

from gnn_tpu_torch.graphs.blocked import _diag_product
from gnn_tpu_torch.ops.cuda.segment import segment_sum_csr
from gnn_tpu_torch.ops.cuda.spmm import csr_spmm
from gnn_tpu_torch.ops.segment import segment_max
from gnn_tpu_torch.parallel.partition import DistGraph

__all__ = [
    "spmm_dist",
    "spmm_dist_dynw",
    "gather_src_dist",
    "gather_dst_dist",
    "edge_reduce_by_dst",
    "edge_valid_mask",
    "shard_node_array",
]


def _k1(adj, v: torch.Tensor) -> torch.Tensor:
    return csr_spmm(adj.row_ptr, adj.src, adj.weight, v)


def _check(dist: DistGraph, x: torch.Tensor, rows: int, name: str) -> None:
    if x.ndim != 2:
        raise ValueError(f"{name} expects a rank-2 [rows, F] array, got {tuple(x.shape)}")
    if x.shape[0] != rows:
        raise ValueError(f"{name}: x has {x.shape[0]} rows, the partition's layout {rows}")
    if x.device != dist.device:
        raise ValueError(f"{name}: x is on {x.device}, the partition on {dist.device}")


def _check_mesh(dist: DistGraph, mesh, axis_name: str) -> None:
    if mesh is None:
        return
    if mesh.shape.get(axis_name) != dist.num_parts:
        raise ValueError(f"the mesh's '{axis_name}' axis has {mesh.shape.get(axis_name)} parts, the graph {dist.num_parts}")
    if mesh.grouped != dist.grouped or mesh.num_local_parts != dist.num_local_parts:
        raise ValueError("the graph was partitioned for another mesh: partition_graph(..., mesh=mesh)")


def _exchange(dist: DistGraph, v: torch.Tensor, idx: torch.Tensor, out=None) -> torch.Tensor:
    """The targeted exchange: the [L P H, F] rows the local parts receive,
    part q's from part g at ``q P H + g H`` (written into ``out`` if given)."""
    L, P, H, F = dist.num_local_parts, dist.num_parts, dist.h_max, v.shape[1]
    with torch.profiler.record_function("halo.exchange"):
        if not dist.grouped:
            return torch.index_select(v, 0, idx, out=out) if out is not None else v.index_select(0, idx)
        sent = v.index_select(0, idx)
        recv = torch.empty_like(sent)
        tdist.all_to_all_single(recv, sent, group=dist.group)
        recv = recv.view(P // L, L, L * H, F).transpose(0, 1).reshape(L * P * H, F)
        if out is None:
            return recv
        return out.copy_(recv)


def _return_partials(dist: DistGraph, rem: torch.Tensor) -> torch.Tensor:
    """The reverse exchange: remote partials [L (holder), P (owner), H, F]
    back to their owners. In one process the ``send`` CSR reads them where
    they lie; in a group, after one ``all_to_all_single``."""
    if not dist.grouped:
        return rem
    L, P, H, F = dist.num_local_parts, dist.num_parts, dist.h_max, rem.shape[1]
    with torch.profiler.record_function("halo.exchange"):
        sent = rem.view(L, P // L, L, H, F).permute(1, 2, 0, 3, 4).contiguous()
        recv = torch.empty_like(sent)
        tdist.all_to_all_single(recv, sent, group=dist.group)
    return recv.view(-1, F)


def _all_gather(dist: DistGraph, v: torch.Tensor) -> torch.Tensor:
    if not dist.grouped:
        return v
    out = v.new_empty((dist.num_parts * dist.n_max, v.shape[1]))
    with torch.profiler.record_function("halo.exchange"), warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)  # renamed in later torch releases
        tdist.all_gather_into_tensor(out, v.contiguous(), group=dist.group)
    return out


def _reduce_scatter(dist: DistGraph, v: torch.Tensor) -> torch.Tensor:
    if not dist.grouped:
        return v
    out = v.new_empty((dist.num_local_parts * dist.n_max, v.shape[1]))
    with torch.profiler.record_function("halo.exchange"), warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)  # renamed in later torch releases
        tdist.reduce_scatter_tensor(out, v.contiguous(), group=dist.group)
    return out


def _diag(dist: DistGraph, v: torch.Tensor, transpose: bool) -> torch.Tensor:
    """The dense product of the local intra-window blocks."""
    R = dist.block_rows
    d = dist.diag.view(-1, R, R)
    d = d.transpose(1, 2) if transpose else d
    with torch.profiler.record_function("blocked_matvec.diag"):
        vw = v.view(-1, R, v.shape[1]).to(d.dtype)
        return _diag_product(d, vw).view(v.shape).to(v.dtype)


def _aggregate(dist: DistGraph, v: torch.Tensor, transpose: bool) -> torch.Tensor:
    """A v (forward) or A^T v (``transpose``) over the local parts."""
    adj = dist.t_adj if transpose else dist.adj
    if dist.halo == "allgather":
        return _k1(adj, _all_gather(dist, v))
    idx = dist.t_exchange_idx if transpose else dist.exchange_idx
    n_own = v.shape[0]
    if dist.halo == "alltoall":
        buf = v.new_empty((adj.num_src_nodes, v.shape[1]))
        buf[:n_own] = v
        _exchange(dist, v, idx, out=buf[n_own:])
        return _k1(adj, buf)
    recv = _exchange(dist, v, idx)  # issued first: the local product needs none of it
    out = _k1(adj, v)
    if dist.diag is not None:
        out.add_(_diag(dist, v, transpose))
    return out.add_(_k1(dist.t_adj_rem if transpose else dist.adj_rem, recv))


class _SpmmDist(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist):
        ctx.dist = dist
        return _aggregate(dist, x, transpose=False)

    @staticmethod
    def backward(ctx, g):
        return _aggregate(ctx.dist, g.contiguous(), transpose=True), None


def spmm_dist(dist: DistGraph, x_sh: torch.Tensor, mesh=None, *, axis_name: str = "data") -> torch.Tensor:
    """out = A @ x over the partition. ``x_sh``: [P n_max, F] in the padded
    node layout (:meth:`DistGraph.shard_nodes`; this process's [L n_max, F]
    in a group). ``mesh`` (default: the graph's) must be the one the graph
    was partitioned for."""
    _check_mesh(dist, mesh, axis_name)
    if x_sh.ndim != 2:
        raise ValueError(f"spmm_dist expects [P*n_max, F], got {tuple(x_sh.shape)}")
    _check(dist, x_sh, dist.num_local_parts * dist.n_max, "spmm_dist")
    return _SpmmDist.apply(x_sh.contiguous(), dist)


# -- edge-parallel primitives (dynamic per-edge weights over the parts) ------
#
# Per-edge arrays use each part's local dst-sorted edge order, laid part by
# part into [L E_max, ...]; padding edges (edst_row == n_max) carry zero rows
# and drop out of every reduction.


def _require_edge_parallel(dist: DistGraph) -> None:
    if dist.esrc_coord is None or dist.inc is None:
        raise ValueError(
            "DistGraph was built with edge_parallel=False; rebuild with "
            "partition_graph(..., edge_parallel=True) for dynamic-weight ops"
        )
    if dist.mesh is None:
        raise ValueError("DistGraph has no mesh: partition_graph(..., mesh=mesh)")


def edge_valid_mask(dist: DistGraph) -> torch.Tensor:
    """[L E_max] bool: True for real edges, False for padding slots."""
    _require_edge_parallel(dist)
    return (dist.edst_row != dist.n_max).reshape(-1)


def _flat(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape[0], -1).contiguous()


class _GatherSrc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist):
        ctx.dist = dist
        F = x.shape[1]
        if dist.halo == "allgather":
            buf = torch.cat([_all_gather(dist, x), x.new_zeros((1, F))])
        else:
            n_own, n_buf = x.shape[0], dist.inc.num_dst_nodes
            buf = x.new_empty((n_buf + 1, F))
            buf[:n_own] = x
            _exchange(dist, x, dist.exchange_idx, out=buf[n_own:n_buf])
            buf[n_buf] = 0
        return buf.index_select(0, dist.esrc_index)

    @staticmethod
    def backward(ctx, g):
        dist = ctx.dist
        partials = _k1(dist.inc, g.contiguous())  # by buffer row, scatter-free
        if dist.halo == "allgather":
            return _reduce_scatter(dist, partials), None
        n_own = dist.num_local_parts * dist.n_max
        dx = _k1(dist.send, _return_partials(dist, partials[n_own:]))
        return dx.add_(partials[:n_own]), None


def gather_src_dist(dist: DistGraph, x_sh: torch.Tensor) -> torch.Tensor:
    """Per-edge source features over the parts: [P n_max, F] -> [P E_max, F]
    in each part's local dst-sorted edge order, zeros at padding edges. The
    VJP reduces the per-edge cotangents by source buffer row (K1 over the
    incidence CSR) and returns the remote partials to their owners (K1 over
    the ``send`` CSR; ``reduce_scatter`` in 'allgather' mode)."""
    _require_edge_parallel(dist)
    if x_sh.ndim != 2:
        raise ValueError(f"gather_src_dist expects [P*n_max, F], got {tuple(x_sh.shape)}")
    _check(dist, x_sh, dist.num_local_parts * dist.n_max, "gather_src_dist")
    return _GatherSrc.apply(x_sh.contiguous(), dist)


def _gather_dst(dist: DistGraph, u: torch.Tensor) -> torch.Tensor:
    return torch.cat([u, u.new_zeros((1, u.shape[1]))]).index_select(0, dist.edst_index)


def _reduce_dst(dist: DistGraph, v: torch.Tensor) -> torch.Tensor:
    """K2 over the per-edge rows; each part's extra row (its padding edges)
    is dropped."""
    L, n = dist.num_local_parts, dist.n_max
    out = segment_sum_csr(dist.dst_row_ptr, v)
    if L == 1:
        return out[:n]
    return out.view(L, n + 1, -1)[:, :n].reshape(L * n, -1)


class _GatherDst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, dist):
        ctx.dist = dist
        return _gather_dst(dist, u)

    @staticmethod
    def backward(ctx, g):
        return _reduce_dst(ctx.dist, g.contiguous()), None


class _ReduceDst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, dist):
        ctx.dist = dist
        return _reduce_dst(dist, v)

    @staticmethod
    def backward(ctx, g):
        return _gather_dst(ctx.dist, g.contiguous()), None


def gather_dst_dist(dist: DistGraph, u_sh: torch.Tensor) -> torch.Tensor:
    """Per-edge values of each edge's (locally owned) destination:
    [P n_max, ...] -> [P E_max, ...]; local, differentiable (the VJP is K2
    over the parts' destination CSR)."""
    _require_edge_parallel(dist)
    _check(dist, _flat(u_sh), dist.num_local_parts * dist.n_max, "gather_dst_dist")
    out = _GatherDst.apply(_flat(u_sh), dist)
    return out.view((out.shape[0],) + tuple(u_sh.shape[1:]))


def edge_reduce_by_dst(dist: DistGraph, v_sh: torch.Tensor, *, op: str = "sum") -> torch.Tensor:
    """Reduce per-edge values to their destination nodes: [P E_max, ...] ->
    [P n_max, ...], local to each part. ``op``: 'sum' (K2) or 'max' ('max'
    leaves -inf on rows without in-edges; mask them with ``dist.in_degree``)."""
    _require_edge_parallel(dist)
    if op not in ("sum", "max"):
        raise ValueError(f"unknown edge reduction '{op}'")
    v = _flat(v_sh)
    _check(dist, v, dist.num_local_parts * dist.e_max, "edge_reduce_by_dst")
    n_own = dist.num_local_parts * dist.n_max
    if op == "sum":
        out = _ReduceDst.apply(v, dist)
    else:  # every padding edge into one extra row, cut off
        out = segment_max(v, dist.edst_index, n_own + 1)[:n_own]
    return out.view((n_own,) + tuple(v_sh.shape[1:]))


def spmm_dist_dynw(dist: DistGraph, weight_sh: torch.Tensor, x_sh: torch.Tensor) -> torch.Tensor:
    """out = A(w) @ x with differentiable per-edge weights ``weight_sh``
    [P E_max] in the parts' local dst-sorted edge order (padding slots 0:
    :func:`edge_valid_mask`). dx rides gather_src_dist's VJP; dw is a local
    per-edge product through autograd."""
    msgs = gather_src_dist(dist, x_sh) * weight_sh[:, None].to(x_sh.dtype)
    return edge_reduce_by_dst(dist, msgs, op="sum")


def shard_node_array(dist: DistGraph, x, mesh, *, axis_name: str = "data", fill=0) -> torch.Tensor:
    """Pad a [N, ...] node array into the [P n_max, ...] layout (this
    process's rows of it in a group) on the mesh's device."""
    _check_mesh(dist, mesh, axis_name)
    return dist.shard_nodes(x, fill=fill).to(dist.device if mesh is None else mesh.device)
