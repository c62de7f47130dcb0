"""Sparse x dense product (SpMM) over an adjacency — the hot op.

Port of ``gnn_tpu/ops/spmm.py::spmm``: out[d] = sum over in-edges
e=(s -> d) of w_e * x[s], differentiable in x (dx = A^T g) and, through
:func:`spmm_edge_weighted`, in the edge weights. The backends:

* ``segment``: kernel K1 (``ops/cuda/spmm.py``) over the CSR, forward and
  dx through the transpose CSR;
* ``ell``, ``sorted`` and ``blocked``: the JAX package's ELL and sorted-ELL
  slot tables and its cluster-blocked windows are TPU layouts; here all
  three run K1 over the same CSR, and raise the JAX package's
  ``ValueError`` where its adjacency would lack that layout (``adj.layout``
  records which one it built; ``'blocked'`` is that of ``reorder='cluster'``).

``'auto'`` is K1 over the CSR, whatever the adjacency's relabelling; the
retired ``'pallas'`` raises, as in the JAX package. A node-partitioned
:class:`~gnn_tpu_torch.parallel.DistGraph` routes to
:func:`~gnn_tpu_torch.parallel.spmm_dist` (``gnn_tpu/ops/spmm.py:259-319``),
so GCN, GIN and EncoderGCN run on it unchanged; its ``with_weight(None)``
view of a weight-baked partition takes the dynamic path with unit weights. :func:`spmm_coo` is the
one-off product over a bare COO edge list, without a prepared adjacency:
plain torch on every device. The single-device :func:`spmm` runs in the
span ``agg.spmm`` and its backward in ``agg.spmm.bwd``. On the CPU the
kernels' plain versions run.
"""

from __future__ import annotations

from typing import Optional

import torch

from gnn_tpu_torch.graphs.adjacency import Adjacency
from gnn_tpu_torch.ops.cuda.spmm import spmm_csr
from gnn_tpu_torch.utils.tracing import span

__all__ = ["spmm", "spmm_coo", "spmm_edge_weighted"]

# The JAX package's error where its adjacency lacks the backend's layout
# (gnn_tpu/ops/spmm.py:330-361); here the backend names adj.layout.
_LAYOUT_ERRORS = {
    "sorted": "spmm backend 'sorted' needs the reordered layout: build the "
    "adjacency with build_adjacency(..., reorder=True)",
    "ell": "spmm backend 'ell' needs an ELL layout: build the adjacency "
    "with build_adjacency(..., layout='ell')",
    "blocked": "spmm backend 'blocked' needs the cluster-packed layout: build the "
    "adjacency with build_adjacency(..., reorder='cluster')",
}


def spmm(adj: Adjacency, x: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """out = A @ x, A given by ``adj`` (logically [N_dst, N_src]).

    ``backend``: 'auto', 'segment', 'ell', 'sorted' and 'blocked' run K1
    over the CSR (the last three where the JAX package's adjacency would
    have that layout).
    """
    if x.ndim != 2:
        raise ValueError(f"spmm expects x of rank 2 [N, F], got {tuple(x.shape)}")
    if not isinstance(adj, Adjacency):
        return _spmm_dist(adj, x)
    if backend == "pallas":
        raise ValueError(
            "spmm backend 'pallas' is retired: it wins no measured regime in the "
            "JAX package. Use backend='auto'."
        )
    elif backend in _LAYOUT_ERRORS:
        if adj.layout != backend:
            raise ValueError(_LAYOUT_ERRORS[backend])
    elif backend not in ("auto", "segment"):
        raise ValueError(f"unknown spmm backend '{backend}'")
    with span("agg.spmm"):
        return spmm_csr(adj, x)


def spmm_edge_weighted(adj: Adjacency, weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """SpMM with caller-supplied differentiable per-edge weights, in the
    adjacency's dst-sorted edge order, over the CSR (K1). On a
    ``DistGraph`` the weights are [P E_max] in the parts' local dst-sorted
    edge order, zeros at the padding slots (``parallel.edge_valid_mask``)."""
    if x.ndim != 2:
        raise ValueError(f"spmm expects x of rank 2 [N, F], got {tuple(x.shape)}")
    if not isinstance(adj, Adjacency):
        from gnn_tpu_torch.parallel.halo import spmm_dist_dynw

        return spmm_dist_dynw(adj, weight, x)
    return spmm_csr(adj, x, weight)


def _spmm_dist(dist, x: torch.Tensor) -> torch.Tensor:
    from gnn_tpu_torch.parallel.halo import edge_valid_mask, spmm_dist, spmm_dist_dynw

    if dist.mesh is None:
        raise ValueError("DistGraph has no mesh: partition_graph(..., mesh=mesh)")
    if dist.unit_weight and dist.has_weight:
        # with_weight(None) of a weight-baked partition: ones at real edges,
        # zeros at padding slots
        return spmm_dist_dynw(dist, edge_valid_mask(dist).float(), x)
    return spmm_dist(dist, x, dist.mesh, axis_name=dist.axis_name)


def _coo_messages(src, x, weight):
    msg = x.index_select(0, src.long())
    return msg if weight is None else msg * weight[:, None].to(msg.dtype)


def spmm_coo(
    src: torch.Tensor,
    dst: torch.Tensor,
    x: torch.Tensor,
    num_dst_nodes: int,
    weight: Optional[torch.Tensor] = None,
    *,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """One-off COO SpMM without a prepared Adjacency: out[d] = sum over
    edges (s -> d) of w_e * x[s], differentiable in x and ``weight`` (fine for
    small graphs and tests). Gather, scale and ``index_add`` on every device,
    as the JAX one is plain XLA; ``indices_are_sorted`` is accepted for its
    signature and changes nothing. A caller that wants K1 on an edge list
    builds an ``Adjacency`` and calls :func:`spmm`."""
    if x.ndim != 2:
        raise ValueError(f"spmm expects x of rank 2 [N, F], got {tuple(x.shape)}")
    out = x.new_zeros((int(num_dst_nodes), x.shape[1]))
    return out.index_add(0, dst.long(), _coo_messages(src, x, weight))
