"""Segment reductions — the scatter side of message passing.

Port of ``gnn_tpu/ops/segment.py``. ``segment_sum``/``mean``/``max``/``min``
are plain torch reductions over explicit segment ids (what
``MessagePassing.aggregate`` uses), and so are ``segment_softmax`` and
``segment_normalize``: the max is ``scatter_reduce("amax")``, since the JAX
package has no kernel for it either. :func:`segment_sum_edges` reduces
per-edge values in an adjacency's dst-sorted order to per-destination sums
through kernel K2 (:func:`~gnn_tpu_torch.ops.edge_agg.edge_aggregate` over
the adjacency's destination CSR, in the span ``agg.segment_sum_edges``),
with the backward a gather by destination (as at
``gnn_tpu/ops/segment.py:204-206``). ``backend='agg'`` raises the JAX
package's error where the adjacency has no ``edge_agg``; the other
``backend=`` values, ``indices_are_sorted=`` and ``interpret=`` steer the JAX
package's lowering only; they are accepted and ignored here, so that its
callers' code carries over.
"""

from __future__ import annotations

import torch

from gnn_tpu_torch.ops.edge_agg import _edge_aggregate
from gnn_tpu_torch.utils.tracing import span

__all__ = [
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_softmax",
    "segment_normalize",
    "segment_sum_edges",
]


def _expand(ids: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return ids.long().view((-1,) + (1,) * (data.ndim - 1)).expand_as(data)


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, *, indices_are_sorted: bool = False
) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids.long(), data)


def segment_mean(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, *, indices_are_sorted: bool = False
) -> torch.Tensor:
    totals = segment_sum(data, segment_ids, num_segments)
    counts = segment_sum(
        torch.ones(segment_ids.shape[0], dtype=data.dtype, device=data.device),
        segment_ids,
        num_segments,
    ).clamp_min(1)
    return totals / counts.view((-1,) + (1,) * (data.ndim - 1))


def _segment_extreme(data, segment_ids, num_segments, reduce: str, fill: float):
    if not data.dtype.is_floating_point:
        info = torch.iinfo(data.dtype)
        fill = info.min if fill < 0 else info.max
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), fill)
    return out.scatter_reduce(0, _expand(segment_ids, data), data, reduce=reduce)


def segment_max(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, *, indices_are_sorted: bool = False
) -> torch.Tensor:
    """Empty segments come out -inf, as in JAX."""
    return _segment_extreme(data, segment_ids, num_segments, "amax", float("-inf"))


def segment_min(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, *, indices_are_sorted: bool = False
) -> torch.Tensor:
    """Empty segments come out +inf, as in JAX."""
    return _segment_extreme(data, segment_ids, num_segments, "amin", float("inf"))


def segment_softmax(
    logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, *, indices_are_sorted: bool = False
) -> torch.Tensor:
    """Softmax within each segment (a node's in-edges), shifted by the
    per-segment max (held constant in the backward, as ``stop_gradient``)."""
    maxes = segment_max(logits.detach(), segment_ids, num_segments)
    maxes = torch.where(torch.isfinite(maxes), maxes, torch.zeros_like(maxes))
    ids = segment_ids.long()
    exp = torch.exp(logits - maxes.index_select(0, ids))
    denom = segment_sum(exp, segment_ids, num_segments).clamp_min(1e-16)
    return exp / denom.index_select(0, ids)


def segment_normalize(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    p: float = 1.0,
    indices_are_sorted: bool = False,
    eps: float = 1e-12,
) -> torch.Tensor:
    """Scale entries so each segment's Lp mass is 1."""
    mass = segment_sum(data.abs() ** p, segment_ids, num_segments) ** (1.0 / p)
    return data / mass.index_select(0, segment_ids.long()).clamp_min(eps)


def segment_sum_edges(
    values: torch.Tensor, adj, *, backend: str = "auto", interpret: bool = False
) -> torch.Tensor:
    """Per-edge values [E, ...] (dst-sorted order) -> per-destination sums
    [N_dst, ...] through K2; differentiable in ``values``."""
    if backend == "agg" and getattr(adj, "edge_agg", None) is None:
        raise ValueError("adjacency has no edge_agg layout (layout='ell')")
    shape = values.shape
    if shape[0] != adj.num_edges:
        raise ValueError(f"expected {adj.num_edges} edge values, got {shape[0]}")
    lay = adj.edge_agg_layouts()[0]
    with span("agg.segment_sum_edges"):
        out = _edge_aggregate(values.reshape(shape[0], -1), lay)
    return out.reshape((adj.num_dst_nodes,) + tuple(shape[1:]))
