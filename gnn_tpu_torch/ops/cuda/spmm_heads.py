"""K3: the multi-head edge-weighted CSR SpMM (``csrc/gat_spmm.cu``), its
plain version, and the autograd rule of GAT's numerator.

Port of the numerator of ``gnn_tpu/mp/gat.py::GATConv`` (:193-202):
num[d, h, :] = sum over in-edges e=(s -> d) of ex_num[e, h] * h[s, h, :], which
the JAX package writes out as an [E, H * F] array and reduces with the Pallas
segment sum. Forward runs the kernel over ``(row_ptr, src, w)``; backward runs
the same kernel over the transpose CSR ``(t_row_ptr, dst[t_perm])`` for dh,
reading the weight of transposed edge k in place at ``w[t_perm[k]]``
(``w_index``), and the SDDMM dw[e, h] = <g[dst_e, h, :], x[src_e, h, :]> on
a kernel of its own (``csrc/gat_sddmm.cu``; the JAX package gets it from
XLA's VJP).

The kernel is the multi-head instance of the merge-path CSR reduction that
K1 and K2 share (``csrc/csr_reduce.cuh``): rows of H * F features, a weight
per edge and head, a fixup launch inside the same C entry for rows cut by a
tile boundary, its scratch from ``_launch.reduce_scratch``.

The weights are rounded to x's dtype before they scale it, as
``ex_num.astype(h_src.dtype)`` does at ``gnn_tpu/mp/gat.py:199``; sums are
float32 and the output has x's dtype.

:func:`csr_spmm_heads` launches the kernel for CUDA tensors and takes
:func:`csr_spmm_heads_plain` only for CPU tensors. It counts its launches in
``csr_spmm_heads.launches``; :func:`sddmm_heads` likewise takes
:func:`sddmm_heads_plain` only for CPU tensors and counts in
``sddmm_heads.launches``. :func:`spmm_heads_csr` runs in the span
``agg.spmm_heads``, its backward in ``agg.spmm_heads.bwd`` and the SDDMM
inside that in ``spmm_heads.dw``.
"""

from __future__ import annotations

from typing import Optional

import torch

from gnn_tpu_torch.ops.cuda import _build, _launch
from gnn_tpu_torch.utils.tracing import span

__all__ = ["csr_spmm_heads", "csr_spmm_heads_plain", "sddmm_heads", "sddmm_heads_plain", "spmm_heads_csr"]


def _round_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return w if dtype == torch.float32 else w.to(dtype).float()


def csr_spmm_heads_plain(
    row_ptr: torch.Tensor, col: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
    w_index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the kernel: gather, scale per head, ``index_add_`` in
    float32, then a cast to x's dtype."""
    w = _round_weight(w, x.dtype)
    if w_index is not None:
        w = w.index_select(0, w_index.long())
    msg = x.float().index_select(0, col.long()) * w[:, :, None]
    out = torch.zeros((row_ptr.numel() - 1,) + tuple(x.shape[1:]), dtype=torch.float32, device=x.device)
    out.index_add_(0, _launch.row_ids(row_ptr, col.numel()), msg)
    return out.to(x.dtype)


def csr_spmm_heads(
    row_ptr: torch.Tensor, col: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
    w_index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """out[r, h, :] = sum_{k in [row_ptr[r], row_ptr[r+1])} w[i(k), h] * x[col[k], h, :]
    with i(k) = k, or ``w_index[k]`` where ``w_index`` is given.

    int32 ``row_ptr``/``col``/``w_index``, float32 ``w`` [E, H], float32 or
    bfloat16 ``x`` [N_src, H, F]; the output [N_rows, H, F] has x's dtype.

    The caller guarantees the index ranges, which are not checked (a check
    would sync the device): ``row_ptr`` non-decreasing from 0 to E, ``col`` in
    [0, N_src) and ``w_index`` in [0, E). The kernel reads ``x`` and ``w`` at
    them as they are, so an entry out of range reads out of bounds. The
    training path passes an ``Adjacency``'s own arrays, built on the host.
    """
    if x.device.type == "cpu":
        return csr_spmm_heads_plain(row_ptr, col, w, x, w_index)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmm_heads runs on CUDA or CPU tensors, got {x.device}")
    if x.ndim != 3:
        raise ValueError(f"x must be [N, H, F], got {tuple(x.shape)}")
    n_src, H, F = x.shape
    x2 = x.view(n_src, H * F) if x.is_contiguous() else x
    suffix = _launch.check_features("x", x2)
    _launch.check_index("row_ptr", row_ptr, x.device)
    _launch.check_index("col", col, x.device)
    if w_index is not None:
        _launch.check_index("w_index", w_index, x.device)
        if w_index.numel() != col.numel():
            raise ValueError(f"w_index must have {col.numel()} entries, got {w_index.numel()}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, expected {x.device}")
    if w.dtype != torch.float32 or w.shape != (col.numel(), H) or not w.is_contiguous():
        raise ValueError(
            f"w must be a contiguous float32 [{col.numel()}, {H}] tensor, got {w.dtype} {tuple(w.shape)}"
        )
    n_rows, n_edges = row_ptr.numel() - 1, col.numel()
    out = torch.empty((n_rows, H, F), dtype=x.dtype, device=x.device)
    if n_rows == 0 or H * F == 0:
        return out
    w = _round_weight(w, x.dtype)
    # F % 4 == 0 keeps the four features of a vector load in one head
    vec = int(F % 4 == 0 and _launch.vector_path(x2, out.view(n_rows, H * F)))
    lib = _build.load()
    with _launch.on(x.device):
        part, part_row = _launch.reduce_scratch(lib, n_rows, n_edges, H * F, x.device)
        rc = getattr(lib, f"gnn_gat_spmm_{suffix}")(
            row_ptr.data_ptr(), col.data_ptr(), w.data_ptr(),
            None if w_index is None else w_index.data_ptr(),
            x.data_ptr(), out.data_ptr(), part.data_ptr(), part_row.data_ptr(),
            n_rows, n_edges, H, F, vec, _launch.stream(x.device),
        )
    _launch.raise_on_error("csr_spmm_heads", rc)
    csr_spmm_heads.launches += 1
    return out


csr_spmm_heads.launches = 0


def sddmm_heads_plain(dst: torch.Tensor, src: torch.Tensor, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: both rows gathered, multiplied and
    summed in float32."""
    return (g.float().index_select(0, dst.long()) * x.float().index_select(0, src.long())).sum(-1)


def sddmm_heads(dst: torch.Tensor, src: torch.Tensor, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dw[e, h] = sum_f g[dst[e], h, f] * x[src[e], h, f], float32 [E, H].

    int32 ``dst``/``src`` [E], float32 or bfloat16 ``g`` [N_dst, H, F] and
    ``x`` [N_src, H, F] of one dtype; products and sums in float32. The
    caller guarantees ``dst`` in [0, N_dst) and ``src`` in [0, N_src), which
    are not checked (a check would sync the device). The training path
    passes an ``Adjacency``'s own arrays, built on the host.
    """
    if g.ndim != 3 or x.ndim != 3 or g.shape[1:] != x.shape[1:]:
        raise ValueError(f"g and x must be [N, H, F] of one (H, F), got {tuple(g.shape)} and {tuple(x.shape)}")
    for name, t in (("dst", dst), ("src", src)):
        if t.dtype != torch.int32 or t.ndim != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor, got {t.dtype} {tuple(t.shape)}")
    if dst.numel() != src.numel():
        raise ValueError(f"dst and src must have one length, got {dst.numel()} and {src.numel()}")
    if x.device.type == "cpu":
        return sddmm_heads_plain(dst, src, g, x)
    if x.device.type != "cuda":
        raise ValueError(f"sddmm_heads runs on CUDA or CPU tensors, got {x.device}")
    _launch.check_index("dst", dst, x.device)
    _launch.check_index("src", src, x.device)
    if g.device != x.device:
        raise ValueError(f"g is on {g.device}, expected {x.device}")
    if g.dtype != x.dtype:
        raise ValueError(f"g and x must have one dtype, got {g.dtype} and {x.dtype}")
    (n_dst, H, F), n_src = g.shape, x.shape[0]
    g2 = g.view(n_dst, H * F) if g.is_contiguous() else g
    x2 = x.view(n_src, H * F) if x.is_contiguous() else x
    _launch.check_features("g", g2)
    suffix = _launch.check_features("x", x2)
    n_edges = dst.numel()
    if n_edges * H * F == 0:
        return torch.zeros((n_edges, H), dtype=torch.float32, device=x.device)
    dw = torch.empty((n_edges, H), dtype=torch.float32, device=x.device)
    # F % 4 == 0 keeps the four features of a vector load in one head
    vec = int(F % 4 == 0 and _launch.vector_path(g2, x2))
    lib = _build.load()
    with _launch.on(x.device):
        rc = getattr(lib, f"gnn_gat_sddmm_{suffix}")(
            dst.data_ptr(), src.data_ptr(), g.data_ptr(), x.data_ptr(), dw.data_ptr(),
            n_edges, H, F, vec, _launch.stream(x.device),
        )
    _launch.raise_on_error("sddmm_heads", rc)
    sddmm_heads.launches += 1
    return dw


sddmm_heads.launches = 0


class _SpmmHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, adj):
        ctx.adj = adj
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w)
        return csr_spmm_heads(adj.row_ptr, adj.src, w, x)

    @staticmethod
    def backward(ctx, g):
        with span("agg.spmm_heads.bwd"):
            x, w = ctx.saved_tensors
            adj = ctx.adj
            g = g.contiguous()
            dx = dw = None
            if ctx.needs_input_grad[0]:
                dx = csr_spmm_heads(adj.t_row_ptr, adj.t_col, w, g, w_index=adj.t_perm)
            if ctx.needs_input_grad[1]:
                # a span of its own around the SDDMM: the benchmark's
                # sddmm_ms and tools/profile_gcn_step.py read it
                with span("spmm_heads.dw"):
                    dw = sddmm_heads(adj.dst, adj.src, g, x)
        return dx, dw, None


def spmm_heads_csr(adj, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-head A_w @ x through K3, differentiable in x [N_src, H, F] and in
    the per-edge, per-head weights w [E, H] (the adjacency's dst-sorted edge
    order)."""
    if w.shape != (adj.num_edges, x.shape[1]):
        raise ValueError(f"w must be [{adj.num_edges}, {x.shape[1]}], got {tuple(w.shape)}")
    with span("agg.spmm_heads"):
        return _SpmmHeads.apply(x.contiguous(), w.float().contiguous(), adj)
