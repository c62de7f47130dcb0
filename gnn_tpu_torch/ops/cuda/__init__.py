"""Hand-written CUDA kernels for Hopper (``gnn_tpu_torch/csrc``), their
wrappers, plain versions and launch counters.

K1 :func:`csr_spmm` replaces ``gnn_tpu/ops/pallas/spmm.py::spmm_pallas``;
K2 :func:`segment_sum_csr` replaces
``gnn_tpu/ops/pallas/segment.py::segment_sum_sorted``; K3
:func:`csr_spmm_heads` replaces GAT's numerator reduction
(``gnn_tpu/mp/gat.py:193-202``); :func:`sddmm_heads`, GAT's attention-weight
gradient in K3's backward, replaces no TPU kernel (XLA's VJP there), nor do
:func:`gatv2_score` and :func:`gatv2_score_bwd`, GATv2's fused attention
score and its gradient (the JAX package has no GATv2), nor do
:func:`edge_softmax` and :func:`edge_softmax_bwd`, the attention's softmax
by destination that GAT and GATv2 share (XLA's in the JAX package), nor do
:func:`gat_score` and :func:`gat_score_bwd`, GAT's node and edge scores and
their gradient, nor does :func:`adam_update`, Adam's update of a group of
leaves in one launch. The kernels build at first launch (``_build.load``),
never at import.
"""

from gnn_tpu_torch.ops.cuda.adam import adam_update, adam_update_plain
from gnn_tpu_torch.ops.cuda.edge_softmax import (
    edge_softmax, edge_softmax_bwd, edge_softmax_bwd_plain, edge_softmax_parts, edge_softmax_plain,
)
from gnn_tpu_torch.ops.cuda.gat_score import gat_score, gat_score_bwd, gat_score_bwd_plain, gat_score_plain, gat_scores
from gnn_tpu_torch.ops.cuda.gatv2_score import (
    gatv2_score, gatv2_score_bwd, gatv2_score_bwd_plain, gatv2_score_edges, gatv2_score_plain,
)
from gnn_tpu_torch.ops.cuda.segment import segment_sum_csr, segment_sum_csr_plain
from gnn_tpu_torch.ops.cuda.spmm import csr_spmm, csr_spmm_plain, spmm_csr
from gnn_tpu_torch.ops.cuda.spmm_heads import (
    csr_spmm_heads, csr_spmm_heads_plain, sddmm_heads, sddmm_heads_plain, spmm_heads_csr,
)

__all__ = [
    "csr_spmm",
    "csr_spmm_plain",
    "spmm_csr",
    "segment_sum_csr",
    "segment_sum_csr_plain",
    "csr_spmm_heads",
    "csr_spmm_heads_plain",
    "sddmm_heads",
    "sddmm_heads_plain",
    "spmm_heads_csr",
    "gatv2_score",
    "gatv2_score_plain",
    "gatv2_score_bwd",
    "gatv2_score_bwd_plain",
    "gatv2_score_edges",
    "edge_softmax",
    "edge_softmax_plain",
    "edge_softmax_bwd",
    "edge_softmax_bwd_plain",
    "edge_softmax_parts",
    "gat_score",
    "gat_score_plain",
    "gat_score_bwd",
    "gat_score_bwd_plain",
    "gat_scores",
    "adam_update",
    "adam_update_plain",
]
