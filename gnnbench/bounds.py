"""The least time an NVIDIA H100 could take for one call of the port's
kernels, from the call's shapes alone, and the card's published peaks.

A frozen copy of ``gnn_tpu_torch/ops/cuda/bounds.py`` (the parts the
benchmark reads): a call's bytes are its *compulsory* bytes, each input and
each output once (``row_ptr``, ``col``, the weights, ``x``, ``out``); its
operations one multiply and one add per edge and feature. The bound is the
larger of bytes over the memory rate and operations over the float32 rate
outside the tensor cores, which these kernels cannot use.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA's data sheet, H100 SXM at its full 700 W power limit.
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12  # dense, on the tensor cores

_INDEX_BYTES = 4  # int32 row_ptr, col, w_index
_WEIGHT_BYTES = 4  # float32 weights, whatever x's dtype


@dataclass(frozen=True)
class Bound:
    bytes: int
    operations: int

    @property
    def bound_s(self) -> float:
        return max(self.bytes / H100_BYTES_PER_S, self.operations / H100_F32_FLOPS)


def _gather_bound(n_rows, n_src, n_edges, width, itemsize, weight_bytes_per_edge) -> Bound:
    moved = (
        (n_rows + 1) * _INDEX_BYTES  # row_ptr
        + n_edges * _INDEX_BYTES  # col
        + n_edges * weight_bytes_per_edge
        + n_rows * width * itemsize  # out
        + n_src * width * itemsize  # x
    )
    return Bound(bytes=moved, operations=2 * n_edges * width)


def csr_spmm_bound(n_rows: int, n_src: int, n_edges: int, F: int, itemsize: int, weighted: bool = True) -> Bound:
    """K1: out[r] = sum_k w[k] * x[col[k]], x [n_src, F], out [n_rows, F]."""
    return _gather_bound(n_rows, n_src, n_edges, F, itemsize, _WEIGHT_BYTES if weighted else 0)


def csr_spmm_heads_bound(
    n_rows: int, n_src: int, n_edges: int, H: int, F: int, itemsize: int, indexed: bool = False
) -> Bound:
    """K3: out[r, h] = sum_k w[i(k), h] * x[col[k], h], x [n_src, H, F], w
    [n_edges, H]; ``indexed`` adds the int32 ``w_index`` [n_edges]."""
    per_edge = H * _WEIGHT_BYTES + (_INDEX_BYTES if indexed else 0)
    return _gather_bound(n_rows, n_src, n_edges, H * F, itemsize, per_edge)
