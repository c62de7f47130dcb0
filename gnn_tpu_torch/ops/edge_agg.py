"""Per-node sums of per-edge message rows, as CSR reductions on the kernels.

Port of ``gnn_tpu/ops/edge_agg.py``: the same API, another layout. The JAX
package aggregates an [E, F] message array by node through degree-bucketed
slot tables of edge positions (``AggBucket``, ``WAggBucket``: unrolled
flat-gather chains, width-8 subrow streams and a hub tail, sized for the
TPU's gather unit). Those slot tables have no counterpart here. Per node the
in-edges are one contiguous run of the dst-sorted edge order, so the layout
is a CSR over edge positions:

* :class:`EdgeAggLayout` holds ``row_ptr`` over the aggregation nodes, the
  optional ``positions`` (the canonical edge position of each sorted slot:
  None for the identity, ``adj.t_perm`` for an aggregation by source) and
  ``edge_node`` (the aggregation node of each canonical edge, for the VJP);
* :func:`edge_aggregate` runs kernel K2 (``ops/cuda/segment.py``) over
  ``row_ptr`` when ``positions`` is None, and kernel K1
  (``ops/cuda/spmm.py``) over ``col = positions`` with a null weight
  otherwise, the row load doing the permute. Its VJP is the one-row gather
  ``g[edge_node]``, as at ``gnn_tpu/ops/edge_agg.py:260-261``;
* :func:`edge_aggregate_max` is ``segment_max`` by ``edge_node``, plain
  torch on every device, as the JAX package computes it in plain XLA, with
  -inf on empty rows and no gradient;
* :class:`WeightedAggLayout` (the static-weight variant) is a CSR of
  ``(col, w, eid)`` that :func:`weighted_agg_matvec` reduces on K1.

The single-device ops run in the spans ``agg.edge_aggregate``,
``agg.edge_aggregate.bwd`` and ``agg.edge_aggregate_max``. On the CPU the
kernels' plain versions run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gnn_tpu_torch.graphs.sorted_ell import KMAX
from gnn_tpu_torch.ops.cuda.segment import segment_sum_csr
from gnn_tpu_torch.ops.cuda.spmm import csr_spmm
from gnn_tpu_torch.utils.tracing import span

__all__ = [
    "EdgeAggLayout",
    "build_edge_agg",
    "edge_aggregate",
    "edge_aggregate_max",
    "WeightedAggLayout",
    "build_weighted_agg",
    "weighted_agg_matvec",
    "refresh_weighted_agg",
    "remap_weighted_agg",
]


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.int32))


def _move(lay, device):
    """A copy of a layout dataclass with every tensor on ``device``."""
    return dataclasses.replace(
        lay, **{
            f.name: getattr(lay, f.name).to(device)
            for f in dataclasses.fields(lay) if isinstance(getattr(lay, f.name), torch.Tensor)
        },
    )


@dataclasses.dataclass(frozen=True)
class EdgeAggLayout:
    """A CSR over canonical edge positions: aggregation node n sums the
    message rows ``positions[row_ptr[n]:row_ptr[n+1]]`` (or that range
    itself where ``positions`` is None)."""

    row_ptr: torch.Tensor  # [N + 1] int32
    positions: Optional[torch.Tensor]  # [E] int32, or None for the identity
    edge_node: torch.Tensor  # [E] int32: aggregation node of each canonical edge
    num_nodes: int
    num_edges: int

    def to(self, device) -> "EdgeAggLayout":
        return _move(self, device)


def build_edge_agg(
    node_of_edge_sorted: np.ndarray,
    num_nodes: int,
    num_edges: int,
    *,
    positions: Optional[np.ndarray] = None,
    kmax: int = KMAX,
) -> EdgeAggLayout:
    """Host-side, structure only (on the CPU; move it with ``.to``).

    ``node_of_edge_sorted``: [E] the aggregation node of each edge, sorted
    ascending (e.g. ``adj.dst``). ``positions``: [E] the canonical edge
    position each sorted slot refers to: None (the identity) for the forward
    layout, ``adj.t_perm`` for the transpose one. ``num_edges`` is the
    canonical edge count (the message array's length). ``kmax`` sizes the
    JAX package's hub tail; a CSR has none, so it is accepted and unused."""
    node = np.asarray(node_of_edge_sorted, np.int64)
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(node, minlength=num_nodes))])
    if positions is None:
        edge_node = node
    else:
        positions = np.asarray(positions, np.int64)
        edge_node = node[np.argsort(positions, kind="stable")]
    return EdgeAggLayout(
        row_ptr=_i32(row_ptr),
        positions=None if positions is None else _i32(positions),
        edge_node=_i32(edge_node),
        num_nodes=int(num_nodes),
        num_edges=int(num_edges),
    )


class _EdgeAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msg, lay):
        ctx.lay = lay
        if lay.positions is None:
            return segment_sum_csr(lay.row_ptr, msg)
        return csr_spmm(lay.row_ptr, lay.positions, None, msg)

    @staticmethod
    def backward(ctx, g):
        with span("agg.edge_aggregate.bwd"):
            return g.index_select(0, ctx.lay.edge_node.long()), None


def _check_edges(msg: torch.Tensor, lay: EdgeAggLayout) -> None:
    E = msg.shape[0]
    if E != lay.num_edges:
        raise ValueError(f"layout built for {lay.num_edges} edges, got {E}")


def edge_aggregate(msg: torch.Tensor, lay: EdgeAggLayout) -> torch.Tensor:
    """out[n] = sum of the msg rows whose aggregation node is n; msg [E, F]
    in the canonical edge order the layout was built against. K2 or K1 (see
    the module docstring); differentiable in msg (VJP: ``g[edge_node]``)."""
    with span("agg.edge_aggregate"):
        return _edge_aggregate(msg, lay)


def _edge_aggregate(msg: torch.Tensor, lay: EdgeAggLayout) -> torch.Tensor:
    """:func:`edge_aggregate` without its span, for the ops that call it
    inside a span of their own: the kernel's launch is then marked with
    the span of its call site."""
    _check_edges(msg, lay)
    return _EdgeAggregate.apply(msg.contiguous(), lay)


def edge_aggregate_max(msg: torch.Tensor, lay: EdgeAggLayout) -> torch.Tensor:
    """out[n] = max of the msg rows whose aggregation node is n, -inf where
    a node has none (``segment_max`` parity). Not differentiable: for
    constant uses such as the softmax shift."""
    from gnn_tpu_torch.ops.segment import segment_max  # segment.py imports this module

    _check_edges(msg, lay)
    with span("agg.edge_aggregate_max"):
        return segment_max(msg.detach(), lay.edge_node, lay.num_nodes)


@dataclasses.dataclass(frozen=True)
class WeightedAggLayout:
    """The static-weight variant: a dst-sorted CSR of source columns, baked
    weights and canonical edge ids (for re-baking the weights)."""

    row_ptr: torch.Tensor  # [N + 1] int32
    col: torch.Tensor  # [E] int32 source ids
    w: Optional[torch.Tensor]  # [E] float32, or None for ones
    eid: torch.Tensor  # [E] int32 canonical edge id of each slot
    num_nodes: int
    num_edges: int

    def to(self, device) -> "WeightedAggLayout":
        return _move(self, device)


def build_weighted_agg(
    dst_sorted: np.ndarray,
    src: np.ndarray,
    edge_ids: np.ndarray,
    weight: Optional[np.ndarray],
    num_nodes: int,
    num_edges: int,
    *,
    kmax: int = KMAX,
) -> WeightedAggLayout:
    """Host-side build (on the CPU). ``dst_sorted`` ascending destination
    per edge; ``src`` / ``edge_ids`` aligned with it; ``weight`` indexed by
    edge position (None = ones); ``num_edges`` is the canonical edge count.
    ``kmax`` is accepted for the JAX signature and unused, as in
    :func:`build_edge_agg`."""
    dst = np.asarray(dst_sorted, np.int64)
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=num_nodes))])
    return WeightedAggLayout(
        row_ptr=_i32(row_ptr),
        col=_i32(src),
        w=None if weight is None else torch.from_numpy(np.array(weight, np.float32)),
        eid=_i32(edge_ids),
        num_nodes=int(num_nodes),
        num_edges=int(num_edges),
    )


def weighted_agg_matvec(x: torch.Tensor, lay: WeightedAggLayout) -> torch.Tensor:
    """out[n] = sum over n's slots of w_slot * x[col_slot] through K1, in
    x's dtype. Forward only, as in the JAX package: a backward runs the
    caller's transpose layout."""
    return csr_spmm(lay.row_ptr, lay.col, lay.w, x.contiguous())


def refresh_weighted_agg(lay: WeightedAggLayout, w_ext: torch.Tensor) -> WeightedAggLayout:
    """Re-bake the slot weights from an extended weight vector (``w_ext[E]``
    plus a trailing 0 for the padding sentinel)."""
    return dataclasses.replace(lay, w=w_ext.index_select(0, lay.eid.long()).float().contiguous())


def remap_weighted_agg(lay: Optional[WeightedAggLayout], inv_ext: torch.Tensor) -> Optional[WeightedAggLayout]:
    """Map the canonical edge ids through a transpose permutation (see
    ``Adjacency.transpose``)."""
    if lay is None:
        return None
    return dataclasses.replace(lay, eid=inv_ext.index_select(0, lay.eid.long()).int())
