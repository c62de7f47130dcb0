"""GAT's attention score (``csrc/gat_score.cu``), forward and backward, its
plain versions, and the differentiable op from the messages h to the edge
scores.

Port of the score of ``gnn_tpu/mp/gat.py::GATConv`` (:160-170): per head,
``e_k = LeakyReLU(a_dst . h_{dst_k} + a_src . h_{src_k})``. The forward
(:func:`gat_score`) takes the per-node scores a [N, H, 2] (``a[n, h, 0] =
att_src[h] . h[n, h]``, ``a[n, h, 1] = att_dst[h] . h[n, h]``) and the edge
scores in one C entry; the backward (:func:`gat_score_bwd`) recomputes a,
takes LeakyReLU's VJP at the sum, its sums by destination on K2 and by
source on K1 over the transpose CSR (the VJPs of the two gathers,
``ops/gather.py``), and from them h's and the attention vectors'
gradients, in two C entries; nothing but h (K3's input as well) is kept
from the forward. :func:`gat_scores` is one autograd node a
layer where the node scores' GEMM, the gathers, the add and the LeakyReLU
recorded about fifteen, each with its host issue.

:func:`gat_score` and :func:`gat_score_bwd` launch the kernels for CUDA
tensors and take their plain versions only for CPU tensors; they count
their calls on the card in ``gat_score.launches`` and
``gat_score_bwd.launches``. :func:`gat_scores` runs in the span
``agg.gat_score`` and its backward in ``agg.gat_score.bwd``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F_

from gnn_tpu_torch.ops.cuda import _build, _launch
from gnn_tpu_torch.ops.cuda.segment import segment_sum_csr_plain
from gnn_tpu_torch.ops.cuda.spmm import csr_spmm_plain
from gnn_tpu_torch.utils.tracing import span

__all__ = ["gat_score", "gat_score_plain", "gat_score_bwd", "gat_score_bwd_plain", "gat_scores"]


def _sums(dst: torch.Tensor, src: torch.Tensor, a: torch.Tensor, round_src: bool) -> torch.Tensor:
    a_src = a[:, :, 0].to(torch.bfloat16).float() if round_src else a[:, :, 0]
    return a[:, :, 1].index_select(0, dst.long()) + a_src.index_select(0, src.long())


def gat_score_plain(
    h: torch.Tensor, att_src: torch.Tensor, att_dst: torch.Tensor, dst: torch.Tensor, src: torch.Tensor,
    negative_slope: float, round_src: bool = False,
) -> tuple:
    """Plain version of the forward: (e [E, H], a [N, H, 2])."""
    a = torch.stack([(h * att_src).sum(-1), (h * att_dst).sum(-1)], dim=2)
    return F_.leaky_relu(_sums(dst, src, a, round_src), negative_slope), a


def gat_score_bwd_plain(
    de: torch.Tensor, h: torch.Tensor, att_src: torch.Tensor, att_dst: torch.Tensor, dst: torch.Tensor,
    src: torch.Tensor, row_ptr: torch.Tensor, t_row_ptr: torch.Tensor, t_perm: torch.Tensor,
    negative_slope: float, round_src: bool = False,
) -> tuple:
    """Plain version of the backward: (dh [N, H, F], datt_src [H, F],
    datt_dst [H, F])."""
    a = torch.stack([(h * att_src).sum(-1), (h * att_dst).sum(-1)], dim=2)
    ds = torch.where(_sums(dst, src, a, round_src) > 0, de, de * negative_slope)
    d_dst = segment_sum_csr_plain(row_ptr, ds)
    d_src = csr_spmm_plain(t_row_ptr, t_perm, None, ds)
    d_dst = torch.cat([d_dst, d_dst.new_zeros(h.shape[0] - d_dst.shape[0], d_dst.shape[1])])
    dh = d_src[:, :, None] * att_src + d_dst[:, :, None] * att_dst
    return dh, (d_src[:, :, None] * h).sum(0), (d_dst[:, :, None] * h).sum(0)


def _check_card(dev: torch.device, index: dict, arrays: dict) -> None:
    for name, t in index.items():
        _launch.check_index(name, t, dev)
    for name, t in arrays.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor, got {t.dtype} {tuple(t.shape)}")


def _check(h: torch.Tensor, att_src: torch.Tensor, att_dst: torch.Tensor, dst: torch.Tensor, src: torch.Tensor):
    if h.ndim != 3 or att_src.shape != h.shape[1:] or att_dst.shape != h.shape[1:]:
        raise ValueError(
            f"h must be [N, H, F] and att_src, att_dst [H, F], got {tuple(h.shape)}, {tuple(att_src.shape)} "
            f"and {tuple(att_dst.shape)}"
        )
    if dst.numel() != src.numel():
        raise ValueError(f"dst and src must have one length, got {dst.numel()} and {src.numel()}")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the GAT score runs on CUDA or CPU tensors, got {h.device}")


def gat_score(
    h: torch.Tensor, att_src: torch.Tensor, att_dst: torch.Tensor, dst: torch.Tensor, src: torch.Tensor,
    negative_slope: float = 0.2, round_src: bool = False,
) -> tuple:
    """(e, a): e[k, h] = LeakyReLU(a[dst[k], h, 1] + a[src[k], h, 0]),
    float32 [E, H], and the node scores a [N, H, 2] it was taken from.

    float32 ``h`` [N, H, F], ``att_src``/``att_dst`` [H, F]; int32
    ``dst``/``src`` [E]. ``round_src`` rounds a[:, :, 0] to bfloat16 before
    the add. The caller guarantees both index arrays in [0, N), which is
    not checked (a check would sync the device). The training path passes
    an ``Adjacency``'s own arrays, built on the host."""
    _check(h, att_src, att_dst, dst, src)
    if h.device.type == "cpu":
        return gat_score_plain(h, att_src, att_dst, dst, src, negative_slope, round_src)
    dev = h.device
    _check_card(dev, {"dst": dst, "src": src}, {"h": h, "att_src": att_src, "att_dst": att_dst})
    (N, H, F), n_edges = h.shape, dst.numel()
    a = torch.empty((N, H, 2), dtype=torch.float32, device=dev)
    e = torch.empty((n_edges, H), dtype=torch.float32, device=dev)
    lib = _build.load()
    with _launch.on(dev):
        rc = lib.gnn_gat_score_f32(
            h.data_ptr(), att_src.data_ptr(), att_dst.data_ptr(), dst.data_ptr(), src.data_ptr(), a.data_ptr(),
            e.data_ptr(), N, n_edges, H, F, negative_slope, int(round_src), _launch.stream(dev),
        )
    _launch.raise_on_error("gat_score", rc)
    gat_score.launches += 1
    return e, a


gat_score.launches = 0


def gat_score_bwd(
    de: torch.Tensor, h: torch.Tensor, att_src: torch.Tensor, att_dst: torch.Tensor, dst: torch.Tensor,
    src: torch.Tensor, row_ptr: torch.Tensor, t_row_ptr: torch.Tensor, t_perm: torch.Tensor,
    negative_slope: float = 0.2, round_src: bool = False,
) -> tuple:
    """(dh [N, H, F], datt_src [H, F], datt_dst [H, F]) of :func:`gat_score`
    from the cotangent ``de`` [E, H] of e, all float32, the node scores
    recomputed. int32 ``row_ptr`` [N_dst + 1] is the destinations' CSR of
    the edges (the destinations the first N_dst nodes), ``t_row_ptr`` [N +
    1] and ``t_perm`` [E] the sources' CSR of edge positions, as an
    ``Adjacency`` holds them; their ranges are the caller's to guarantee."""
    _check(h, att_src, att_dst, dst, src)
    if de.shape != (dst.numel(), h.shape[1]):
        raise ValueError(f"de must be [{dst.numel()}, {h.shape[1]}], got {tuple(de.shape)}")
    if h.device.type == "cpu":
        return gat_score_bwd_plain(de, h, att_src, att_dst, dst, src, row_ptr, t_row_ptr, t_perm, negative_slope,
                                   round_src)
    dev = h.device
    _check_card(
        dev, {"dst": dst, "src": src, "row_ptr": row_ptr, "t_row_ptr": t_row_ptr, "t_perm": t_perm},
        {"h": h, "att_src": att_src, "att_dst": att_dst, "de": de},
    )
    (N, H, F), n_edges, n_dst = h.shape, dst.numel(), row_ptr.numel() - 1
    if t_row_ptr.numel() != N + 1 or t_perm.numel() != n_edges or not 0 <= n_dst <= N:
        raise ValueError(
            f"expected a destinations' CSR of at most {N} rows and a sources' CSR of {N} rows over {n_edges} "
            f"edges, got {n_dst} rows, {t_row_ptr.numel() - 1} rows and {t_perm.numel()} positions"
        )
    if 2 * H * F > 1024:
        raise ValueError(f"the backward takes 2 H F <= 1024, got H={H}, F={F}")
    lib = _build.load()
    tiles = max(lib.gnn_csr_reduce_tiles(n_dst, n_edges), lib.gnn_csr_reduce_tiles(N, n_edges))
    if tiles < 0:
        raise ValueError(f"{N} rows + {n_edges} edges exceed the kernels' int32 merge coordinates")
    f32 = dict(dtype=torch.float32, device=dev)
    d_dst, d_src = torch.empty((n_dst, H), **f32), torch.empty((N, H), **f32)
    with _launch.on(dev):
        # the first half's arrays are freed before dh is allocated
        a, ds = torch.empty((N, H, 2), **f32), torch.empty((n_edges, H), **f32)
        part, part_row = torch.empty(2 * tiles * H, **f32), torch.empty(2 * tiles, dtype=torch.int32, device=dev)
        rc = lib.gnn_gat_score_bwd_f32(
            h.data_ptr(), att_src.data_ptr(), att_dst.data_ptr(), dst.data_ptr(), src.data_ptr(), a.data_ptr(),
            de.data_ptr(), row_ptr.data_ptr(), t_row_ptr.data_ptr(), t_perm.data_ptr(), ds.data_ptr(),
            d_dst.data_ptr(), d_src.data_ptr(), part.data_ptr(), part_row.data_ptr(), N, n_dst, n_edges, H, F,
            negative_slope, int(round_src), _launch.stream(dev),
        )
        _launch.raise_on_error("gat_score_bwd", rc)
        del a, ds, part, part_row
        dh, datt = torch.empty((N, H, F), **f32), torch.empty((2, H, F), **f32)
        datt_part = torch.empty(lib.gnn_gat_datt_parts(N) * 2 * H * F, **f32)
        rc = lib.gnn_gat_score_node_bwd_f32(
            h.data_ptr(), att_src.data_ptr(), att_dst.data_ptr(), d_dst.data_ptr(), d_src.data_ptr(), dh.data_ptr(),
            datt.data_ptr(), datt_part.data_ptr(), N, n_dst, H, F, _launch.stream(dev),
        )
    _launch.raise_on_error("gat_score_bwd", rc)
    gat_score_bwd.launches += 1
    return dh, datt[0], datt[1]


gat_score_bwd.launches = 0


class _GatScores(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, att_src, att_dst, adj, negative_slope, round_src):
        e, _ = gat_score(h, att_src, att_dst, adj.dst, adj.src, negative_slope, round_src)
        ctx.adj, ctx.negative_slope, ctx.round_src = adj, negative_slope, round_src
        ctx.save_for_backward(h, att_src, att_dst)  # h is K3's saved input too
        return e

    @staticmethod
    def backward(ctx, de):
        with span("agg.gat_score.bwd"):
            h, att_src, att_dst = ctx.saved_tensors
            adj = ctx.adj
            grads = gat_score_bwd(
                de.contiguous(), h, att_src, att_dst, adj.dst, adj.src, adj.row_ptr, adj.t_row_ptr, adj.t_perm,
                ctx.negative_slope, ctx.round_src,
            )
        return (*grads, None, None, None)


def gat_scores(
    h: torch.Tensor, att_src: torch.Tensor, att_dst: torch.Tensor, adj, negative_slope: float,
    src_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """GAT's edge scores e [E, H], float32, of the messages ``h`` [N_src, H,
    F] and the attention vectors ``att_src``/``att_dst`` [H, F] over the
    adjacency's dst-sorted edges (its destinations the first N_dst nodes):
    LeakyReLU(att_dst . h_dst + att_src . h_src), differentiable in all
    three, computed in float32. ``src_dtype`` bfloat16 rounds ``att_src .
    h`` to it before it meets the edges (the message dtype, as the JAX
    package gathers it)."""
    if h.ndim != 3 or h.shape[0] != adj.num_src_nodes:
        raise ValueError(f"h must be [{adj.num_src_nodes}, H, F], got {tuple(h.shape)}")
    if src_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the score's message dtype is float32 or bfloat16, got {src_dtype}")
    f32 = lambda t: t.float().contiguous()  # noqa: E731
    with span("agg.gat_score"):
        e = _GatScores.apply(f32(h), f32(att_src), f32(att_dst), adj, negative_slope, src_dtype == torch.bfloat16)
    return e
