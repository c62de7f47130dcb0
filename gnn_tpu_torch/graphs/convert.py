"""Graph representation converters.

Port of ``gnn_tpu/graphs/convert.py``: source/destination vectors, dense
``A[dst, src]`` matrices and CSR arrays to and from the COO edge list. The
edge lists and dense matrices come back as torch tensors on the CPU (edge
lists int64, the port's COO dtype, where the JAX package gives int32), the CSR
arrays as numpy, as there. Dense conversion is for tests and small graphs: the
compute path never densifies.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "edge_list",
    "to_dense_adj",
    "dense_to_edge_list",
    "edge_list_to_csr",
    "csr_to_edge_list",
]


def as_numpy(a) -> np.ndarray:
    """A tensor's values on the host (no copy for a CPU tensor) or
    ``np.asarray`` of anything else (a memmap stays one)."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _num_nodes(ei: np.ndarray, num_nodes: Optional[int]) -> int:
    if num_nodes is not None:
        return int(num_nodes)
    return int(ei.max()) + 1 if ei.size else 0


def edge_list(src: Sequence[int], dst: Sequence[int]) -> torch.Tensor:
    """Source and destination id vectors -> COO [2, E] int64."""
    src, dst = np.asarray(as_numpy(src), np.int64), np.asarray(as_numpy(dst), np.int64)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("src and dst must be 1-D sequences of equal length")
    return torch.from_numpy(np.stack([src, dst]))


def to_dense_adj(edge_index, edge_weight=None, num_nodes: Optional[int] = None) -> torch.Tensor:
    """COO -> dense [N, N] float32, duplicate edges summed. ``A[dst, src] = w``
    (ones without weights), so that ``A @ X`` sums source features into
    destinations."""
    ei = as_numpy(edge_index)
    n = _num_nodes(ei, num_nodes)
    adj = np.zeros((n, n), np.float32)
    w = np.ones(ei.shape[1], np.float32) if edge_weight is None else as_numpy(edge_weight)
    np.add.at(adj, (ei[1], ei[0]), w)
    return torch.from_numpy(adj)


def dense_to_edge_list(adj) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense [N, N] -> (edge_index [2, E] int64, edge_attr [E] float32) of its
    nonzeros, sorted by destination then source: the inverse of
    :func:`to_dense_adj`."""
    a = as_numpy(adj)
    dst, src = np.nonzero(a)
    order = np.lexsort((src, dst))
    src, dst = src[order], dst[order]
    return (
        torch.from_numpy(np.stack([src, dst]).astype(np.int64)),
        torch.from_numpy(a[dst, src].astype(np.float32)),
    )


def edge_list_to_csr(
    edge_index, num_nodes: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO -> (row_ptr over dst, col = src, the sorting permutation), numpy
    int64, edges sorted by destination then source."""
    ei = as_numpy(edge_index)
    src, dst = ei[0], ei[1]
    n = _num_nodes(ei, num_nodes)
    order = np.lexsort((src, dst))
    src, dst = src[order], dst[order]
    row_ptr = np.zeros(n + 1, np.int64)
    np.add.at(row_ptr, dst + 1, 1)
    return np.cumsum(row_ptr), src.astype(np.int64), order


def csr_to_edge_list(row_ptr, col_idx) -> torch.Tensor:
    """(row_ptr over dst, col = src) -> COO [2, E] int64."""
    row_ptr, col_idx = as_numpy(row_ptr), as_numpy(col_idx)
    counts = np.diff(row_ptr)
    dst = np.repeat(np.arange(len(counts)), counts)
    return torch.from_numpy(np.stack([col_idx, dst]).astype(np.int64))
