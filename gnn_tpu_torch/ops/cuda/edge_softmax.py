"""The attention's softmax by destination (``csrc/edge_softmax.cu``), its
plain versions and its autograd rule.

Over the E edges of an adjacency in its dst-sorted order, where each
destination's in-edges are one contiguous run, for scores e [E, H]:

    m[n]   = max over the in-edges of n of e        (0 where n has none)
    ex[k]  = exp(e[k] - m[row(k)])
    den[n] = max(sum over the in-edges of n of ex, 1e-16)

with m held constant in the backward, as GAT's softmax shift is:
de[k] = ex[k] * (g_ex[k] + g_den[row(k)]). GAT and GATv2 take ``ex``
through dropout into the numerator (K3) and divide by ``den``
(``mp/gat.py::attend``).

:func:`edge_softmax` launches the forward kernels for CUDA tensors and
takes :func:`edge_softmax_plain` (a scatter-max, the shift's gather,
``exp`` and an ``index_add_``) only for CPU tensors;
:func:`edge_softmax_bwd` likewise the backward's kernel and
:func:`edge_softmax_bwd_plain`. They count their launches in
``edge_softmax.launches`` and ``edge_softmax_bwd.launches``.
:func:`edge_softmax_parts`, the differentiable op over an ``Adjacency``,
runs in the span ``agg.edge_softmax`` and its backward in
``agg.edge_softmax.bwd``. Replaces no TPU kernel: the JAX package leaves
the softmax to XLA.
"""

from __future__ import annotations

import torch

from gnn_tpu_torch.ops.cuda import _build, _launch
from gnn_tpu_torch.utils.tracing import span

__all__ = ["edge_softmax", "edge_softmax_plain", "edge_softmax_bwd", "edge_softmax_bwd_plain", "edge_softmax_parts"]

DEN_MIN = 1e-16


def edge_softmax_plain(e: torch.Tensor, row_ptr: torch.Tensor) -> tuple:
    """Plain version of the forward, in e's dtype: (ex [E, H], den [N, H])."""
    n_rows, (n_edges, H) = row_ptr.numel() - 1, e.shape
    rows = _launch.row_ids(row_ptr, n_edges)
    m = e.new_full((n_rows, H), float("-inf")).scatter_reduce(0, rows[:, None].expand(n_edges, H), e, "amax")
    m = torch.nan_to_num(m, nan=0.0, posinf=0.0, neginf=0.0)  # rows without edges: -inf -> 0
    ex = torch.exp(e - m.index_select(0, rows))
    den = e.new_zeros((n_rows, H)).index_add_(0, rows, ex).clamp_min(DEN_MIN)
    return ex, den


def edge_softmax_bwd_plain(ex: torch.Tensor, g_ex: torch.Tensor, g_den: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward: ``ex * (g_ex + g_den[dst])``."""
    return (g_ex + g_den.index_select(0, dst.long())) * ex


def _check_scores(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor, got {t.dtype} {tuple(t.shape)}")


def edge_softmax(e: torch.Tensor, row_ptr: torch.Tensor) -> tuple:
    """(ex, den) of the scores ``e`` [E, H] over the destination CSR
    ``row_ptr`` (int32 [N + 1], edges in row order); float32 on the card.
    The caller guarantees row_ptr[N] == E, which is not checked (a check
    would sync the device): an ``Adjacency`` holds it, and
    :func:`edge_softmax_parts` checks E against its ``num_edges``."""
    if e.ndim != 2:
        raise ValueError(f"e must be [E, H], got {tuple(e.shape)}")
    if e.device.type == "cpu":
        return edge_softmax_plain(e, row_ptr)
    if e.device.type != "cuda":
        raise ValueError(f"edge_softmax runs on CUDA or CPU tensors, got {e.device}")
    dev = e.device
    (n_edges, H), n_rows = e.shape, row_ptr.numel() - 1
    _check_scores("e", e, dev)
    _launch.check_index("row_ptr", row_ptr, dev)
    ex = torch.empty_like(e)
    den = torch.empty((n_rows, H), dtype=torch.float32, device=dev)
    if H == 0 or n_rows == 0:
        return ex, den
    lib = _build.load()
    with _launch.on(dev):
        tiles = lib.gnn_csr_reduce_tiles(n_rows, n_edges)
        if tiles < 0:
            raise ValueError(f"{n_rows} rows + {n_edges} edges exceed the kernels' int32 merge coordinates")
        part = torch.empty(4 * tiles * H, dtype=torch.float32, device=dev)
        part_idx = torch.empty(6 * tiles, dtype=torch.int32, device=dev)
        rc = lib.gnn_edge_softmax_f32(
            row_ptr.data_ptr(), e.data_ptr(), ex.data_ptr(), den.data_ptr(), part.data_ptr(), part_idx.data_ptr(),
            n_rows, n_edges, H, _launch.vector_path(e, ex, den), _launch.stream(dev),
        )
    _launch.raise_on_error("edge_softmax", rc)
    edge_softmax.launches += 1
    return ex, den


edge_softmax.launches = 0


def edge_softmax_bwd(ex: torch.Tensor, g_ex: torch.Tensor, g_den: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """de [E, H] of :func:`edge_softmax` from the cotangents ``g_ex`` [E, H]
    and ``g_den`` [N, H], with ``dst`` (int32 [E]) the row of each edge;
    float32 on the card. The caller guarantees ``dst`` in [0, N), which is
    not checked (a check would sync the device)."""
    if ex.ndim != 2 or g_ex.shape != ex.shape or g_den.ndim != 2 or g_den.shape[1] != ex.shape[1]:
        raise ValueError(
            f"ex and g_ex must be one [E, H] and g_den [N, H], got {tuple(ex.shape)}, {tuple(g_ex.shape)} and "
            f"{tuple(g_den.shape)}"
        )
    if ex.device.type == "cpu":
        return edge_softmax_bwd_plain(ex, g_ex, g_den, dst)
    if ex.device.type != "cuda":
        raise ValueError(f"edge_softmax_bwd runs on CUDA or CPU tensors, got {ex.device}")
    dev = ex.device
    for name, t in (("ex", ex), ("g_ex", g_ex), ("g_den", g_den)):
        _check_scores(name, t, dev)
    _launch.check_index("dst", dst, dev)
    n_edges, H = ex.shape
    if dst.numel() != n_edges:
        raise ValueError(f"dst must have one entry an edge, {n_edges}, got {dst.numel()}")
    de = torch.empty_like(ex)
    if n_edges * H == 0:
        return de
    lib = _build.load()
    with _launch.on(dev):
        rc = lib.gnn_edge_softmax_bwd_f32(
            dst.data_ptr(), ex.data_ptr(), g_ex.data_ptr(), g_den.data_ptr(), de.data_ptr(), n_edges, H,
            _launch.vector_path(ex, g_ex, g_den, de), _launch.stream(dev),
        )
    _launch.raise_on_error("edge_softmax_bwd", rc)
    edge_softmax_bwd.launches += 1
    return de


edge_softmax_bwd.launches = 0


class _EdgeSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, adj):
        ex, den = edge_softmax(e, adj.row_ptr)
        ctx.adj = adj
        ctx.save_for_backward(ex)
        return ex, den

    @staticmethod
    def backward(ctx, g_ex, g_den):  # an unused output's cotangent comes as zeros
        with span("agg.edge_softmax.bwd"):
            (ex,) = ctx.saved_tensors
            return edge_softmax_bwd(ex, g_ex.contiguous(), g_den.contiguous(), ctx.adj.dst), None


def edge_softmax_parts(e: torch.Tensor, adj) -> tuple:
    """The two parts of the attention's softmax over the adjacency's
    dst-sorted edges, differentiable in the scores ``e`` [E, H]: ``ex`` [E,
    H] (each score less its destination's max, exponentiated) and ``den``
    [N_dst, H] (their sum by destination, at least 1e-16)."""
    if e.ndim != 2 or e.shape[0] != adj.num_edges:
        raise ValueError(f"expected [{adj.num_edges}, H] edge scores, got {tuple(e.shape)}")
    with span("agg.edge_softmax"):
        return _EdgeSoftmax.apply(e.contiguous(), adj)
