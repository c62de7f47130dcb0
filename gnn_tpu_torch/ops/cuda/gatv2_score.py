"""GATv2's attention score (``csrc/gatv2_score.cu``), its plain versions and
its autograd rule.

Per edge e = (s -> d) and head h, for GATv2 (Brody, Alon and Yahav, ICLR
2022; PyG's ``GATv2Conv``):

    s[e, h] = sum_f att[h, f] * LeakyReLU(h_dst[d, h, f] + h_src[s, h, f])

with the LeakyReLU inside the dot product, so the score does not split into
two per-node terms as GAT's does. The kernel writes only the [E, H] scores;
its backward recomputes the sum per edge and writes only ``dh_src``,
``dh_dst`` and ``datt``: no [E, H, F] tensor exists at any point. float32.

:func:`gatv2_score` launches the forward kernel for CUDA tensors and takes
:func:`gatv2_score_plain` only for CPU tensors; :func:`gatv2_score_bwd`
likewise the backward's kernels and :func:`gatv2_score_bwd_plain`. They count
their launches in ``gatv2_score.launches`` and ``gatv2_score_bwd.launches``.
:func:`gatv2_score_edges`, the differentiable op over an ``Adjacency``, runs
in the span ``agg.gatv2_score`` and its backward in ``agg.gatv2_score.bwd``.
Replaces no TPU kernel: the JAX package has no GATv2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gnn_tpu_torch.ops.cuda import _build, _launch
from gnn_tpu_torch.utils.tracing import span

__all__ = ["gatv2_score", "gatv2_score_plain", "gatv2_score_bwd", "gatv2_score_bwd_plain", "gatv2_score_edges"]


def gatv2_score_plain(
    h_src: torch.Tensor, h_dst: torch.Tensor, att: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """Plain version of the forward: both rows gathered, added, LeakyReLU,
    scaled by ``att`` and summed, in the inputs' dtype."""
    z = h_dst.index_select(0, dst.long()) + h_src.index_select(0, src.long())
    return (F.leaky_relu(z, negative_slope) * att).sum(-1)


def gatv2_score_bwd_plain(
    ds: torch.Tensor, h_src: torch.Tensor, h_dst: torch.Tensor, att: torch.Tensor,
    row_ptr: torch.Tensor, src: torch.Tensor, negative_slope: float = 0.2,
) -> tuple:
    """Plain version of the backward: (dh_src, dh_dst, datt) from the
    per-edge [E, H, F] terms, summed with ``index_add_``."""
    dst = _launch.row_ids(row_ptr, src.numel())
    z = h_dst.index_select(0, dst) + h_src.index_select(0, src.long())
    g = ds[:, :, None]
    dz = g * att * torch.where(z > 0, 1.0, negative_slope).to(z.dtype)
    dh_dst = torch.zeros_like(h_dst).index_add_(0, dst, dz)
    dh_src = torch.zeros_like(h_src).index_add_(0, src.long(), dz)
    return dh_src, dh_dst, (g * F.leaky_relu(z, negative_slope)).sum(0)


def _check(h_src: torch.Tensor, h_dst: torch.Tensor, att: torch.Tensor) -> None:
    if h_src.ndim != 3 or h_dst.ndim != 3 or h_src.shape[1:] != h_dst.shape[1:] or att.shape != h_src.shape[1:]:
        raise ValueError(
            f"h_src, h_dst must be [N, H, F] of one (H, F) and att [H, F], got {tuple(h_src.shape)}, "
            f"{tuple(h_dst.shape)} and {tuple(att.shape)}"
        )


def _check_card(device: torch.device, **tensors: torch.Tensor) -> int:
    """The card path's checks of the float32 arrays; returns the vector flag
    of ``h_src``, ``h_dst`` and ``att``, the arrays read four features at a
    time."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor, got {t.dtype} {tuple(t.shape)}")
    att = tensors["att"]
    rows = [tensors[k].view(-1, att.numel()) for k in ("h_src", "h_dst", "att")]
    # F % 4 == 0 keeps the four features of a vector load in one head
    return int(att.shape[1] % 4 == 0 and _launch.vector_path(*rows))


def gatv2_score(
    h_src: torch.Tensor, h_dst: torch.Tensor, att: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """s[e, h] = sum_f att[h, f] * LeakyReLU(h_dst[dst[e], h, f] + h_src[src[e], h, f]),
    float32 [E, H].

    float32 ``h_src`` [N_src, H, F], ``h_dst`` [N_dst, H, F], ``att`` [H, F];
    int32 ``src``/``dst`` [E]. The caller guarantees ``src`` in [0, N_src)
    and ``dst`` in [0, N_dst), which are not checked (a check would sync the
    device). The training path passes an ``Adjacency``'s own arrays, built
    on the host.
    """
    _check(h_src, h_dst, att)
    if h_src.device.type == "cpu":
        return gatv2_score_plain(h_src, h_dst, att, src, dst, negative_slope)
    if h_src.device.type != "cuda":
        raise ValueError(f"gatv2_score runs on CUDA or CPU tensors, got {h_src.device}")
    dev = h_src.device
    vec = _check_card(dev, h_src=h_src, h_dst=h_dst, att=att)
    _launch.check_index("src", src, dev)
    _launch.check_index("dst", dst, dev)
    if src.numel() != dst.numel():
        raise ValueError(f"src and dst must have one length, got {src.numel()} and {dst.numel()}")
    H, F_ = att.shape
    n_edges = src.numel()
    s = torch.empty((n_edges, H), dtype=torch.float32, device=dev)
    if n_edges * H * F_ == 0:
        return s.zero_()
    lib = _build.load()
    with _launch.on(dev):
        rc = lib.gnn_gatv2_score_f32(
            dst.data_ptr(), src.data_ptr(), h_src.data_ptr(), h_dst.data_ptr(), att.data_ptr(), s.data_ptr(),
            n_edges, H, F_, negative_slope, vec, _launch.stream(dev),
        )
    _launch.raise_on_error("gatv2_score", rc)
    gatv2_score.launches += 1
    return s


gatv2_score.launches = 0


def gatv2_score_bwd(
    ds: torch.Tensor, h_src: torch.Tensor, h_dst: torch.Tensor, att: torch.Tensor,
    row_ptr: torch.Tensor, src: torch.Tensor, t_row_ptr: torch.Tensor, t_perm: torch.Tensor,
    t_col: torch.Tensor, negative_slope: float = 0.2,
) -> tuple:
    """(dh_src, dh_dst, datt) of :func:`gatv2_score` from its cotangent
    ``ds`` [E, H], float32.

    The adjacency's arrays, int32: ``row_ptr`` [N_dst + 1] and ``src`` [E]
    in the dst-sorted edge order, ``t_row_ptr`` [N_src + 1], ``t_perm`` and
    ``t_col`` = dst[t_perm] [E] of its transpose. dh_dst sums each
    destination's edges over ``row_ptr``, dh_src each source's over
    ``t_row_ptr`` in the order ``t_perm``; datt over all edges, in two
    fixed stages. The caller guarantees the index ranges, as for
    :func:`gatv2_score`.
    """
    _check(h_src, h_dst, att)
    if ds.shape != (src.numel(), att.shape[0]):
        raise ValueError(f"ds must be [{src.numel()}, {att.shape[0]}], got {tuple(ds.shape)}")
    if h_src.device.type == "cpu":
        return gatv2_score_bwd_plain(ds, h_src, h_dst, att, row_ptr, src, negative_slope)
    if h_src.device.type != "cuda":
        raise ValueError(f"gatv2_score_bwd runs on CUDA or CPU tensors, got {h_src.device}")
    dev = h_src.device
    vec = _check_card(dev, ds=ds, h_src=h_src, h_dst=h_dst, att=att)
    for name, t in (("row_ptr", row_ptr), ("src", src), ("t_row_ptr", t_row_ptr), ("t_perm", t_perm),
                    ("t_col", t_col)):
        _launch.check_index(name, t, dev)
    (n_dst, H, F_), n_src, n_edges = h_dst.shape, h_src.shape[0], src.numel()
    if row_ptr.numel() != n_dst + 1 or t_row_ptr.numel() != n_src + 1 or not t_perm.numel() == t_col.numel() == n_edges:
        raise ValueError("row_ptr, t_row_ptr, t_perm and t_col must fit h_dst's, h_src's and src's lengths")
    dh_src, dh_dst = torch.empty_like(h_src), torch.empty_like(h_dst)
    datt = torch.empty_like(att)
    if n_edges * H * F_ == 0:
        return dh_src.zero_(), dh_dst.zero_(), datt.zero_()
    lib = _build.load()
    W = H * F_
    with _launch.on(dev):
        tiles = [lib.gnn_csr_reduce_tiles(n, n_edges) for n in (n_dst, n_src)]
        if min(tiles) < 0:
            raise ValueError(f"{max(n_dst, n_src)} rows + {n_edges} edges exceed the kernels' int32 merge coordinates")
        part = torch.empty(2 * max(tiles) * W, dtype=torch.float32, device=dev)
        part_row = torch.empty(2 * max(tiles), dtype=torch.int32, device=dev)
        datt_part = torch.empty(tiles[0] * W, dtype=torch.float32, device=dev)
        rc = lib.gnn_gatv2_score_bwd_f32(
            row_ptr.data_ptr(), src.data_ptr(), t_row_ptr.data_ptr(), t_perm.data_ptr(), t_col.data_ptr(),
            ds.data_ptr(), h_src.data_ptr(), h_dst.data_ptr(), att.data_ptr(),
            dh_src.data_ptr(), dh_dst.data_ptr(), datt.data_ptr(), part.data_ptr(), part_row.data_ptr(),
            datt_part.data_ptr(), n_dst, n_src, n_edges, H, F_, negative_slope, vec, _launch.stream(dev),
        )
    _launch.raise_on_error("gatv2_score_bwd", rc)
    gatv2_score_bwd.launches += 1
    return dh_src, dh_dst, datt


gatv2_score_bwd.launches = 0


class _Gatv2Score(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h_src, h_dst, att, adj, negative_slope):
        ctx.adj, ctx.negative_slope = adj, negative_slope
        ctx.save_for_backward(h_src, h_dst, att)
        return gatv2_score(h_src, h_dst, att, adj.src, adj.dst, negative_slope)

    @staticmethod
    def backward(ctx, ds):
        with span("agg.gatv2_score.bwd"):
            h_src, h_dst, att = ctx.saved_tensors
            a = ctx.adj
            grads = gatv2_score_bwd(
                ds.contiguous(), h_src, h_dst, att, a.row_ptr, a.src, a.t_row_ptr, a.t_perm, a.t_col,
                ctx.negative_slope,
            )
        return (*grads, None, None)


def gatv2_score_edges(
    adj, h_src: torch.Tensor, h_dst: torch.Tensor, att: torch.Tensor, negative_slope: float = 0.2
) -> torch.Tensor:
    """GATv2's scores [E, H] over the adjacency's dst-sorted edges,
    differentiable in ``h_src`` [N_src, H, F], ``h_dst`` [N_dst, H, F] and
    ``att`` [H, F]."""
    if h_src.shape[0] != adj.num_src_nodes or h_dst.shape[0] != adj.num_dst_nodes:
        raise ValueError(
            f"expected {adj.num_src_nodes} source and {adj.num_dst_nodes} destination rows, "
            f"got {h_src.shape[0]} and {h_dst.shape[0]}"
        )
    with span("agg.gatv2_score"):
        return _Gatv2Score.apply(h_src.contiguous(), h_dst.contiguous(), att.contiguous(), adj, negative_slope)
