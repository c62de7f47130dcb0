"""K3: the multi-head edge-weighted CSR SpMM (``csrc/gat_spmm.cu``), its
plain version, and the autograd rule of GAT's numerator.

Port of the numerator of ``gnn_tpu/mp/gat.py::GATConv`` (:193-202):
num[d, h, :] = sum over in-edges e=(s -> d) of ex_num[e, h] * h[s, h, :], which
the JAX package writes out as an [E, H * F] array and reduces with the Pallas
segment sum. Forward runs the kernel over ``(row_ptr, src, w)``; backward runs
the same kernel over the transpose CSR ``(t_row_ptr, dst[t_perm], w[t_perm])``
for dh, and the SDDMM dw[e, h] = <g[dst_e, h, :], x[src_e, h, :]> in plain
torch (the JAX package computes it in XLA too).

The weights are rounded to x's dtype before they scale it, as
``ex_num.astype(h_src.dtype)`` does at ``gnn_tpu/mp/gat.py:199``; sums are
float32 and the output has x's dtype.

:func:`csr_spmm_heads` launches the kernel for CUDA tensors and takes
:func:`csr_spmm_heads_plain` only for CPU tensors. It counts its launches in
``csr_spmm_heads.launches``.
"""

from __future__ import annotations

import torch

from gnn_tpu_torch.ops.cuda import _build, _launch

__all__ = ["csr_spmm_heads", "csr_spmm_heads_plain", "spmm_heads_csr"]


def _round_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return w if dtype == torch.float32 else w.to(dtype).float()


def csr_spmm_heads_plain(
    row_ptr: torch.Tensor, col: torch.Tensor, w: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """Plain version of the kernel: gather, scale per head, ``index_add_`` in
    float32, then a cast to x's dtype."""
    msg = x.float().index_select(0, col.long()) * _round_weight(w, x.dtype).float()[:, :, None]
    out = torch.zeros((row_ptr.numel() - 1,) + tuple(x.shape[1:]), dtype=torch.float32, device=x.device)
    out.index_add_(0, _launch.row_ids(row_ptr, col.numel()), msg)
    return out.to(x.dtype)


def csr_spmm_heads(
    row_ptr: torch.Tensor, col: torch.Tensor, w: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """out[r, h, :] = sum_{k in [row_ptr[r], row_ptr[r+1])} w[k, h] * x[col[k], h, :].

    int32 ``row_ptr``/``col``, float32 ``w`` [E, H], float32 or bfloat16
    ``x`` [N_src, H, F]; the output [N_rows, H, F] has x's dtype.
    """
    if x.device.type == "cpu":
        return csr_spmm_heads_plain(row_ptr, col, w, x)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmm_heads runs on CUDA or CPU tensors, got {x.device}")
    if x.ndim != 3:
        raise ValueError(f"x must be [N, H, F], got {tuple(x.shape)}")
    n_src, H, F = x.shape
    x2 = x.view(n_src, H * F) if x.is_contiguous() else x
    suffix = _launch.check_features("x", x2)
    _launch.check_index("row_ptr", row_ptr, x.device)
    _launch.check_index("col", col, x.device)
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, expected {x.device}")
    if w.dtype != torch.float32 or w.shape != (col.numel(), H) or not w.is_contiguous():
        raise ValueError(
            f"w must be a contiguous float32 [{col.numel()}, {H}] tensor, got {w.dtype} {tuple(w.shape)}"
        )
    n_rows = row_ptr.numel() - 1
    out = torch.empty((n_rows, H, F), dtype=x.dtype, device=x.device)
    if n_rows == 0 or H * F == 0:
        return out
    w = _round_weight(w, x.dtype)
    vec = int(F % 4 == 0 and _launch.vector_path(x2, out.view(n_rows, H * F)))
    fn = getattr(_build.load(), f"gnn_gat_spmm_{suffix}")
    with torch.cuda.device(x.device):
        rc = fn(
            row_ptr.data_ptr(), col.data_ptr(), w.data_ptr(), x.data_ptr(), out.data_ptr(),
            n_rows, H, F, vec, _launch.stream(x.device),
        )
    _launch.raise_on_error("csr_spmm_heads", rc)
    csr_spmm_heads.launches += 1
    return out


csr_spmm_heads.launches = 0


class _SpmmHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, adj):
        ctx.adj = adj
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w)
        return csr_spmm_heads(adj.row_ptr, adj.src, w, x)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        adj = ctx.adj
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            t_w = w.index_select(0, adj.t_perm.long())
            dx = csr_spmm_heads(adj.t_row_ptr, adj.t_col, t_w, g)
        if ctx.needs_input_grad[1]:
            dw = (
                g.float().index_select(0, adj.dst.long())
                * x.float().index_select(0, adj.src.long())
            ).sum(-1)
        return dx, dw, None


def spmm_heads_csr(adj, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-head A_w @ x through K3, differentiable in x [N_src, H, F] and in
    the per-edge, per-head weights w [E, H] (the adjacency's dst-sorted edge
    order)."""
    if w.shape != (adj.num_edges, x.shape[1]):
        raise ValueError(f"w must be [{adj.num_edges}, {x.shape[1]}], got {tuple(w.shape)}")
    return _SpmmHeads.apply(x.contiguous(), w.float().contiguous(), adj)
