"""Graph preprocessing transforms (host-side numpy, one-time prep).

Port of ``gnn_tpu/graphs/transforms.py``: self loops, the exact GCN
normalization d_i^-1/2 a_ij d_j^-1/2 over A + I, coalescing and the
undirected closure. Every function returns the same arrays as its
counterpart for the same input; edge sorts are dst-major, src-minor and
stable (``np.lexsort((src, dst))``), the order the counting sort of
``gnn_tpu.native.sort_edges_csr`` produces.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "add_self_loops",
    "add_remaining_self_loops",
    "remove_self_loops",
    "coalesce",
    "to_undirected",
    "gcn_norm",
    "degree",
]


def _as_np(edge_index) -> np.ndarray:
    ei = np.asarray(edge_index)
    if ei.ndim != 2 or ei.shape[0] != 2:
        raise ValueError(f"edge_index must be [2, E], got {ei.shape}")
    return ei


def _num_nodes(ei: np.ndarray, num_nodes: Optional[int]) -> int:
    if num_nodes is not None:
        return num_nodes
    return int(ei.max()) + 1 if ei.size else 0


def add_self_loops(
    edge_index,
    edge_weight=None,
    fill_value: float = 1.0,
    num_nodes: Optional[int] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Append (i, i) for every node, whether it has a self loop or not."""
    ei = _as_np(edge_index)
    num_nodes = _num_nodes(ei, num_nodes)
    loops = np.arange(num_nodes, dtype=ei.dtype)
    out = np.concatenate([ei, np.stack([loops, loops])], axis=1)
    if edge_weight is None:
        return out, None
    w = np.asarray(edge_weight)
    return out, np.concatenate([w, np.full(num_nodes, fill_value, w.dtype)])


def add_remaining_self_loops(
    edge_index,
    edge_weight=None,
    fill_value: float = 1.0,
    num_nodes: Optional[int] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Append (i, i) only for nodes that have no self loop yet."""
    ei = _as_np(edge_index)
    num_nodes = _num_nodes(ei, num_nodes)
    has_loop = np.zeros(num_nodes, bool)
    has_loop[ei[0][ei[0] == ei[1]]] = True
    missing = np.nonzero(~has_loop)[0].astype(ei.dtype)
    out = np.concatenate([ei, np.stack([missing, missing])], axis=1)
    if edge_weight is None:
        return out, None
    w = np.asarray(edge_weight)
    return out, np.concatenate([w, np.full(len(missing), fill_value, w.dtype)])


def remove_self_loops(
    edge_index, edge_weight=None
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    ei = _as_np(edge_index)
    keep = ei[0] != ei[1]
    return ei[:, keep], None if edge_weight is None else np.asarray(edge_weight)[keep]


def coalesce(
    edge_index,
    edge_weight=None,
    num_nodes: Optional[int] = None,
    reduce: str = "sum",
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Sort by (dst, src) and merge duplicate edges (reducing weights)."""
    del num_nodes  # the sort needs no node count
    ei = _as_np(edge_index)
    src, dst = ei[0].astype(np.int64), ei[1].astype(np.int64)
    order = np.lexsort((src, dst))
    src, dst = src[order], dst[order]
    uniq_mask = np.ones(len(src), bool)
    if len(src):
        uniq_mask[1:] = (dst[1:] != dst[:-1]) | (src[1:] != src[:-1])
    idx = np.cumsum(uniq_mask) - 1
    out = np.stack([src[uniq_mask], dst[uniq_mask]])
    if edge_weight is None:
        return out, None
    w = np.asarray(edge_weight)[order]
    n_uniq = int(uniq_mask.sum())
    if reduce == "sum":
        merged = np.zeros(n_uniq, w.dtype)
        np.add.at(merged, idx, w)
    elif reduce == "max":
        merged = np.full(n_uniq, -np.inf, w.dtype)
        np.maximum.at(merged, idx, w)
    elif reduce == "mean":
        merged = np.zeros(n_uniq, w.dtype)
        counts = np.zeros(n_uniq, np.int64)
        np.add.at(merged, idx, w)
        np.add.at(counts, idx, 1)
        merged = merged / np.maximum(counts, 1)
    else:
        raise ValueError(f"unknown reduce '{reduce}'")
    return out, merged


def to_undirected(
    edge_index, edge_weight=None, num_nodes: Optional[int] = None
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Symmetrize: add reversed edges, then coalesce duplicates."""
    ei = _as_np(edge_index)
    both = np.concatenate([ei, ei[::-1]], axis=1)
    w = None if edge_weight is None else np.concatenate([np.asarray(edge_weight)] * 2)
    return coalesce(both, w, num_nodes=num_nodes, reduce="max")


def degree(
    edge_index, num_nodes: Optional[int] = None, edge_weight=None, kind: str = "in"
) -> np.ndarray:
    """Weighted (or unweighted) in/out degree, summed in float64."""
    ei = _as_np(edge_index)
    num_nodes = _num_nodes(ei, num_nodes)
    nodes = (ei[1] if kind == "in" else ei[0]).astype(np.int64)
    out = np.zeros(num_nodes, np.float64)
    np.add.at(out, nodes, 1.0 if edge_weight is None else np.asarray(edge_weight, np.float64))
    return out


def gcn_norm(
    edge_index,
    edge_weight=None,
    num_nodes: Optional[int] = None,
    *,
    self_loops: bool = True,
    improved: bool = False,
    norm: str = "sym",
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact GCN normalization: returns (edge_index', float32 per-edge weight).

    sym: w_ij = d_i^-1/2 * a_ij * d_j^-1/2 over A(+I); row ("rw"):
    w_ij = d_i^-1 * a_ij.
    """
    ei = _as_np(edge_index)
    num_nodes = _num_nodes(ei, num_nodes)
    if self_loops:
        ei, edge_weight = add_remaining_self_loops(
            ei,
            edge_weight if edge_weight is not None else np.ones(ei.shape[1]),
            fill_value=2.0 if improved else 1.0,
            num_nodes=num_nodes,
        )
    w = np.ones(ei.shape[1]) if edge_weight is None else np.asarray(edge_weight, np.float64)
    deg = degree(ei, num_nodes, w, kind="in")
    if norm == "sym":
        with np.errstate(divide="ignore"):
            dinv = np.where(deg > 0, deg**-0.5, 0.0)
        w = dinv[ei[1]] * w * dinv[ei[0]]
    elif norm in ("rw", "row"):
        with np.errstate(divide="ignore"):
            dinv = np.where(deg > 0, 1.0 / deg, 0.0)
        w = dinv[ei[1]] * w
    elif norm not in (None, "none"):
        raise ValueError(f"unknown norm '{norm}'")
    return ei, w.astype(np.float32)
