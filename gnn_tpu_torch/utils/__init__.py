"""Validation, timing and roofline helpers (port of ``gnn_tpu/utils``)."""

from gnn_tpu_torch.utils.checks import (
    check_broadcastable,
    check_dim,
    check_edge_index,
    check_matmul,
    check_rank,
    check_same_shape,
    normalize_dim,
)

__all__ = [
    "check_rank",
    "check_dim",
    "check_same_shape",
    "check_broadcastable",
    "check_matmul",
    "check_edge_index",
    "normalize_dim",
]
