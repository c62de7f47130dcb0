"""K1: the CSR SpMM kernel (``csrc/csr_spmm.cu``), its plain version, and the
autograd rule of the GCN aggregation.

Port of ``gnn_tpu/ops/pallas/spmm.py::spmm_pallas``: out[d] = sum over
in-edges e=(s -> d) of w_e * x[s]. Forward runs the kernel over
``(row_ptr, src, weight)``; backward runs the same kernel over the transpose
CSR ``(t_row_ptr, dst[t_perm], weight[t_perm])`` for dx = A^T g, and, only
when the weight requires grad, the SDDMM dw_e = <g[dst_e], x[src_e]> in plain
torch (the JAX package also computes dw outside its kernel).

:func:`csr_spmm` launches the kernel for CUDA tensors and takes
:func:`csr_spmm_plain` only for CPU tensors. It counts its launches in
``csr_spmm.launches``. The backward runs in the span ``agg.spmm.bwd``.
"""

from __future__ import annotations

from typing import Optional

import torch

from gnn_tpu_torch.ops.cuda import _build, _launch
from gnn_tpu_torch.utils.tracing import span

__all__ = ["csr_spmm", "csr_spmm_plain", "spmm_csr"]


def csr_spmm_plain(
    row_ptr: torch.Tensor, col: torch.Tensor, weight: Optional[torch.Tensor], x: torch.Tensor
) -> torch.Tensor:
    """Plain version of the kernel: gather, scale, ``index_add_`` in float32,
    then a cast to x's dtype."""
    msg = x.float().index_select(0, col.long())
    if weight is not None:
        msg = msg * weight.float()[:, None]
    out = torch.zeros((row_ptr.numel() - 1, x.shape[1]), dtype=torch.float32, device=x.device)
    out.index_add_(0, _launch.row_ids(row_ptr, col.numel()), msg)
    return out.to(x.dtype)


def csr_spmm(
    row_ptr: torch.Tensor, col: torch.Tensor, weight: Optional[torch.Tensor], x: torch.Tensor
) -> torch.Tensor:
    """out[r] = sum_{k in [row_ptr[r], row_ptr[r+1])} weight[k] * x[col[k]].

    int32 ``row_ptr``/``col``, float32 ``weight`` (or None for ones), float32
    or bfloat16 ``x`` [N_src, F]; the output has x's dtype.
    """
    if x.device.type == "cpu":
        return csr_spmm_plain(row_ptr, col, weight, x)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmm runs on CUDA or CPU tensors, got {x.device}")
    suffix = _launch.check_features("x", x)
    _launch.check_index("row_ptr", row_ptr, x.device)
    _launch.check_index("col", col, x.device)
    _launch.check_weight(weight, col.numel(), x.device)
    n_rows, n_edges, F = row_ptr.numel() - 1, col.numel(), x.shape[1]
    out = torch.empty((n_rows, F), dtype=x.dtype, device=x.device)
    if n_rows == 0 or F == 0:
        return out
    lib = _build.load()
    with _launch.on(x.device):
        part, part_row = _launch.reduce_scratch(lib, n_rows, n_edges, F, x.device)
        rc = getattr(lib, f"gnn_csr_spmm_{suffix}")(
            row_ptr.data_ptr(), col.data_ptr(),
            None if weight is None else weight.data_ptr(),
            x.data_ptr(), out.data_ptr(), part.data_ptr(), part_row.data_ptr(),
            n_rows, n_edges, F, _launch.vector_path(x, out), _launch.stream(x.device),
        )
    _launch.raise_on_error("csr_spmm", rc)
    csr_spmm.launches += 1
    return out


csr_spmm.launches = 0


class _CsrSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, t_weight, adj):
        ctx.adj = adj
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, weight, t_weight)
        return csr_spmm(adj.row_ptr, adj.src, weight, x)

    @staticmethod
    def backward(ctx, g):
        with span("agg.spmm.bwd"):
            x, weight, t_weight = ctx.saved_tensors
            adj = ctx.adj
            g = g.contiguous()
            dx = dw = None
            if ctx.needs_input_grad[0]:
                dx = csr_spmm(adj.t_row_ptr, adj.t_col, t_weight, g)
            if ctx.needs_input_grad[1]:
                dw = (
                    g.float().index_select(0, adj.dst.long())
                    * x.float().index_select(0, adj.src.long())
                ).sum(-1).to(weight.dtype)
        return dx, dw, None, None


def spmm_csr(adj, x: torch.Tensor, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A @ x through K1, differentiable in x and in ``weight``.

    ``weight=None`` uses the adjacency's own (constant) weights and their
    cached transpose order; a caller-supplied per-edge ``weight`` (in the
    adjacency's dst-sorted edge order) gets dw when it requires grad.
    """
    if weight is None:
        weight, t_weight = adj.weight, adj.t_weight
    else:
        t_weight = weight.detach().index_select(0, adj.t_perm.long()).contiguous()
    return _CsrSpmm.apply(x.contiguous(), weight, t_weight, adj)
