"""Validation helpers with PyTorch-style error messages.

Port of ``gnn_tpu/utils/checks.py``, the same seven names and messages (the
reference's CHECK_* error system, include/utils.h:19-30,
src/utils.cpp:8-125). They read shapes and dtypes only, and take torch
tensors and numpy arrays alike.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = [
    "check_rank",
    "check_dim",
    "check_same_shape",
    "check_broadcastable",
    "check_matmul",
    "check_edge_index",
    "normalize_dim",
]


def normalize_dim(dim: int, rank: int) -> int:
    """Map a possibly-negative dim to [0, rank). Mirrors CHECK_VALID_DIMS
    (reference: src/utils.cpp:16-27)."""
    if not -rank <= dim < rank:
        raise ValueError(
            f"Dimension out of range (expected to be in range of [{-rank}, "
            f"{rank - 1}], but got {dim})"
        )
    return dim % rank


def check_rank(x, rank: int, name: str = "input") -> None:
    if x.ndim != rank:
        raise ValueError(f"{name} must have rank {rank}, got shape {tuple(x.shape)}")


def check_dim(x, dim: int, size: int, name: str = "input") -> None:
    d = normalize_dim(dim, x.ndim)
    if x.shape[d] != size:
        raise ValueError(
            f"{name} must have size {size} along dim {dim}, got shape {tuple(x.shape)}"
        )


def check_same_shape(a, b, msg: str = "") -> None:
    """Mirrors CHECK_EQUAL_SIZES semantics (reference: include/utils.h:19-30)."""
    if tuple(a.shape) != tuple(b.shape):
        raise ValueError(
            f"Expected tensors of the same shape, got {tuple(a.shape)} and "
            f"{tuple(b.shape)}. {msg}"
        )


def is_broadcastable(a_shape: Sequence[int], b_shape: Sequence[int]) -> bool:
    """Numpy broadcast compatibility (reference: src/utils.cpp:117-125)."""
    for x, y in zip(reversed(a_shape), reversed(b_shape)):
        if x != y and x != 1 and y != 1:
            return False
    return True


def check_broadcastable(a, b) -> None:
    """Mirrors CHECK_ARGS_OPS_BROADCAST (reference: src/utils.cpp:40-54)."""
    if not is_broadcastable(a.shape, b.shape):
        raise ValueError(
            f"The size of tensor a ({tuple(a.shape)}) must match the size of "
            f"tensor b ({tuple(b.shape)}) at non-singleton dimensions"
        )


def check_matmul(a, b) -> None:
    """Mirrors CHECK_MM_DIMS (reference: src/utils.cpp:56-78)."""
    if a.ndim < 2 or b.ndim < 2:
        raise ValueError("matmul requires tensors of rank >= 2")
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(
            f"mat1 and mat2 shapes cannot be multiplied "
            f"({a.shape[-2]}x{a.shape[-1]} and {b.shape[-2]}x{b.shape[-1]})"
        )
    if not is_broadcastable(a.shape[:-2], b.shape[:-2]):
        raise ValueError(
            f"batch dimensions {tuple(a.shape[:-2])} and {tuple(b.shape[:-2])} "
            "are not broadcastable"
        )


def _is_integer(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)
    return np.issubdtype(dtype, np.integer)


def check_edge_index(edge_index, num_nodes: int | None = None) -> None:
    """Validate a COO edge index [2, E] (a torch tensor or a numpy array).
    Mirrors the Data ctor invariant checks (reference:
    src/graph.cpp:77-100)."""
    if edge_index.ndim != 2 or edge_index.shape[0] != 2:
        raise ValueError(
            f"edge_index must have shape [2, num_edges], got {tuple(edge_index.shape)}"
        )
    if not _is_integer(edge_index.dtype):
        raise ValueError(f"edge_index must be integer-typed, got {edge_index.dtype}")
