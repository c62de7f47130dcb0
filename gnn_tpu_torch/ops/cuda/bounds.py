"""The least time an NVIDIA H100 could take for one call of K1, K2, K3,
GAT's SDDMM, GATv2's score or the attention's softmax (forward and
backward), from the call's shapes alone.

Plain arithmetic on integers: the measurement scripts (``chip_smoke.py``,
``tools/profile_gcn_step.py``) set a kernel's measured time beside these
figures; nothing on the training path calls this module.

A call's *compulsory bytes* count each input and each output once
(``row_ptr``, ``col``, the weights, ``x`` or ``msg``, ``out``), whatever the
kernel reads again. Its *no-reuse bytes* count a gathered row of ``x`` once
per edge instead of ``x`` once: what the call moves if no gathered row is
ever found in a cache, and never less than the compulsory bytes (for K2,
which gathers nothing, the two are equal; so are they for K1 and K3 over a
sampled hop's CSR, whose ``col`` names every source row once, in order: that
gather is a streamed read).
Its *operations* are one multiply and one add per edge and feature (K2: one
add). The bound is the larger of compulsory bytes over the card's memory
rate and operations over its float32 rate outside the tensor cores, which
these kernels cannot use (1-2 flops per 4-8 bytes moved).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "H100_BYTES_PER_S", "H100_F32_FLOPS", "H100_BF16_FLOPS", "Bound",
    "csr_spmm_bound", "segment_sum_bound", "csr_spmm_heads_bound", "sddmm_heads_bound", "gatv2_score_bound",
    "gatv2_score_bwd_bound", "edge_softmax_bound", "edge_softmax_bwd_bound", "exchange_bound",
]

# NVIDIA's data sheet, H100 SXM at its full 700 W power limit.
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12  # dense, on the tensor cores

_INDEX_BYTES = 4  # int32 row_ptr, col, w_index
_WEIGHT_BYTES = 4  # float32 weights, whatever x's dtype


@dataclass(frozen=True)
class Bound:
    bytes: int  # compulsory: each input and output once
    noreuse_bytes: int  # a gathered row once per edge
    operations: int  # float32 multiplies and adds

    @property
    def bytes_ms(self) -> float:
        return self.bytes / H100_BYTES_PER_S * 1e3

    @property
    def operations_ms(self) -> float:
        return self.operations / H100_F32_FLOPS * 1e3

    @property
    def bound_ms(self) -> float:
        return max(self.bytes_ms, self.operations_ms)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bytes_ms >= self.operations_ms else "operations"

    @property
    def noreuse_ms(self) -> float:
        return max(self.noreuse_bytes / H100_BYTES_PER_S * 1e3, self.operations_ms)


def _gather_bound(n_rows, n_src, n_edges, width, itemsize, weight_bytes_per_edge) -> Bound:
    fixed = (
        (n_rows + 1) * _INDEX_BYTES  # row_ptr
        + n_edges * _INDEX_BYTES  # col
        + n_edges * weight_bytes_per_edge
        + n_rows * width * itemsize  # out
    )
    return Bound(
        bytes=fixed + n_src * width * itemsize,
        noreuse_bytes=fixed + max(n_edges, n_src) * width * itemsize,
        operations=2 * n_edges * width,
    )


def csr_spmm_bound(
    n_rows: int, n_src: int, n_edges: int, F: int, itemsize: int, weighted: bool = True
) -> Bound:
    """K1: out[r] = sum_k w[k] * x[col[k]], x [n_src, F], out [n_rows, F].
    ``weighted=False`` is the call with ``w`` null (the source gather's VJP
    over ``col = t_perm``, where ``n_src`` is the number of edges)."""
    return _gather_bound(n_rows, n_src, n_edges, F, itemsize, _WEIGHT_BYTES if weighted else 0)


def segment_sum_bound(n_rows: int, n_edges: int, F: int, itemsize: int) -> Bound:
    """K2: out[r] = sum_k msg[k], msg [n_edges, F], out [n_rows, F]."""
    moved = (n_rows + 1) * _INDEX_BYTES + (n_edges + n_rows) * F * itemsize
    return Bound(bytes=moved, noreuse_bytes=moved, operations=n_edges * F)


def csr_spmm_heads_bound(
    n_rows: int, n_src: int, n_edges: int, H: int, F: int, itemsize: int, indexed: bool = False
) -> Bound:
    """K3: out[r, h] = sum_k w[i(k), h] * x[col[k], h], x [n_src, H, F], w
    [n_edges, H]; ``indexed`` adds the int32 ``w_index`` [n_edges]."""
    per_edge = H * _WEIGHT_BYTES + (_INDEX_BYTES if indexed else 0)
    return _gather_bound(n_rows, n_src, n_edges, H * F, itemsize, per_edge)


def sddmm_heads_bound(n_dst: int, n_src: int, n_edges: int, H: int, F: int, itemsize: int) -> Bound:
    """GAT's SDDMM: dw[e, h] = <g[dst[e], h], x[src[e], h]>, g [n_dst, H, F],
    x [n_src, H, F], float32 dw [n_edges, H], int32 ``dst`` and ``src``. The
    edges come in ``dst`` order, so a g row is a streamed read and only x's
    rows count once per edge without reuse."""
    fixed = 2 * n_edges * _INDEX_BYTES + n_edges * H * _WEIGHT_BYTES + n_dst * H * F * itemsize
    return Bound(
        bytes=fixed + n_src * H * F * itemsize,
        noreuse_bytes=fixed + max(n_edges, n_src) * H * F * itemsize,
        operations=2 * n_edges * H * F,
    )


def gatv2_score_bound(n_dst: int, n_src: int, n_edges: int, H: int, F: int) -> Bound:
    """GATv2's score forward, float32: s[e, h] = <att[h], LeakyReLU(h_dst[dst[e],
    h] + h_src[src[e], h])>, int32 ``dst`` and ``src``, s [n_edges, H]; 4
    operations an edge, head and feature. As for the SDDMM, the edges come
    in ``dst`` order and only h_src's rows count once per edge without
    reuse."""
    fixed = 2 * n_edges * _INDEX_BYTES + n_edges * H * _WEIGHT_BYTES + (n_dst + 1) * H * F * 4
    return Bound(
        bytes=fixed + n_src * H * F * 4,
        noreuse_bytes=fixed + max(n_edges, n_src) * H * F * 4,
        operations=4 * n_edges * H * F,
    )


def gatv2_score_bwd_bound(n_dst: int, n_src: int, n_edges: int, H: int, F: int) -> Bound:
    """GATv2's score backward, float32: ds [n_edges, H], h_src, h_dst, att
    and the edge list (int32 ``src`` and ``dst``, as the forward reads it)
    in; dh_src, dh_dst, datt out; 8 operations an edge, head and feature.
    The transpose order and the row offsets that the kernels walk are the
    layout they chose, not what the function needs, and are not counted.
    Without reuse each of its two passes gathers the other side's row, and
    the pass by source reads ds again, per edge."""
    W = H * F * 4
    fixed = (n_edges * H * _WEIGHT_BYTES + 2 * W + 2 * n_edges * _INDEX_BYTES
             + (n_src + n_dst) * W)  # the outputs dh_src, dh_dst and datt (2 W: att and datt)
    return Bound(
        bytes=fixed + (n_src + n_dst) * W,
        noreuse_bytes=fixed + 2 * max(n_edges, n_src, n_dst) * W + n_edges * H * _WEIGHT_BYTES,
        operations=8 * n_edges * H * F,
    )


def edge_softmax_bound(n_rows: int, n_edges: int, H: int) -> Bound:
    """The attention's softmax by destination, forward, float32: the scores
    e [n_edges, H] and ``row_ptr`` in, ex [n_edges, H] and den [n_rows, H]
    out; a max, a subtract, an exp and an add a score. Nothing is gathered."""
    moved = (n_rows + 1) * _INDEX_BYTES + 2 * n_edges * H * 4 + n_rows * H * 4
    return Bound(bytes=moved, noreuse_bytes=moved, operations=4 * n_edges * H)


def edge_softmax_bwd_bound(n_rows: int, n_edges: int, H: int) -> Bound:
    """Its backward: ex and g_ex [n_edges, H], g_den [n_rows, H] and the
    edges' rows as ``row_ptr`` in, de [n_edges, H] out; an add and a multiply
    a score. The kernel reads the rows as an int32 ``dst`` [n_edges], the
    layout it chose, not counted; without reuse g_den's row is read once an
    edge."""
    fixed = (n_rows + 1) * _INDEX_BYTES + 3 * n_edges * H * 4
    return Bound(
        bytes=fixed + n_rows * H * 4,
        noreuse_bytes=fixed + max(n_edges, n_rows) * H * 4,
        operations=2 * n_edges * H,
    )


def exchange_bound(n_slots: int, F: int, itemsize: int) -> Bound:
    """The halo exchange of ``parallel/halo.py`` within one card: each of
    ``n_slots`` received rows read once and written once, with its int64
    gather index (the rows a collective would carry between cards)."""
    moved = n_slots * (2 * F * itemsize + 8)
    return Bound(bytes=moved, noreuse_bytes=moved, operations=0)
