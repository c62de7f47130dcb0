"""Sparse ops: SpMM, edge gathers, segment reductions and graph pooling;
the hot ones on the hand-written kernels."""

from gnn_tpu_torch.ops.gather import gather_dst_edges, gather_src_edges
from gnn_tpu_torch.ops.pool import global_add_pool, global_max_pool, global_mean_pool
from gnn_tpu_torch.ops.sddmm import gather_dst, gather_src, sddmm
from gnn_tpu_torch.ops.segment import (
    segment_max,
    segment_mean,
    segment_min,
    segment_normalize,
    segment_softmax,
    segment_sum,
    segment_sum_edges,
)
from gnn_tpu_torch.ops.spmm import spmm, spmm_coo, spmm_edge_weighted

__all__ = [
    "spmm",
    "spmm_coo",
    "spmm_edge_weighted",
    "gather_src_edges",
    "gather_dst_edges",
    "sddmm",
    "gather_src",
    "gather_dst",
    "global_add_pool",
    "global_mean_pool",
    "global_max_pool",
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_softmax",
    "segment_normalize",
    "segment_sum_edges",
]
