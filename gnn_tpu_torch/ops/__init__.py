"""Sparse ops: SpMM and segment reductions, on the hand-written kernels."""

from gnn_tpu_torch.ops.segment import (
    segment_max,
    segment_mean,
    segment_min,
    segment_sum,
    segment_sum_edges,
)
from gnn_tpu_torch.ops.spmm import spmm, spmm_edge_weighted

__all__ = [
    "spmm",
    "spmm_edge_weighted",
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_sum_edges",
]
