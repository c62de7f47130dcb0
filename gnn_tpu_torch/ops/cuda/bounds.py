"""The least time an NVIDIA H100 could take for one call of K1, K2 or K3,
from the call's shapes alone.

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
    "csr_spmm_bound", "segment_sum_bound", "csr_spmm_heads_bound", "blocked_matvec_bound",
    "blocked_layout_cost_ms", "exchange_bound",
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


def blocked_matvec_bound(n_rows: int, n_edges: int, F: int, itemsize: int) -> Bound:
    """``blocked_matvec`` computes A @ x, so its bound is that of the
    function, whatever the layout: K1's over the whole CSR of ``n_edges``
    weighted edges, x and out once."""
    return csr_spmm_bound(n_rows, n_rows, n_edges, F, itemsize)


def blocked_layout_cost_ms(
    n_blocks: int, block_rows: int, block_itemsize: int, n_rows: int, n_rem_edges: int, F: int, itemsize: int
) -> float:
    """The least time for what the blocked *layout* asks of the card, which
    is more than the function needs: every entry of the dense [n_blocks, R,
    R] diagonal blocks is read and multiplied, zero or not (at the float32
    rate outside the tensor cores for float32 blocks, at the tensor cores'
    bfloat16 rate for 2-byte blocks), then K1 runs over the remainder CSR."""
    blocks = n_blocks * block_rows * block_rows
    remainder = csr_spmm_bound(n_rows, n_rows, n_rem_edges, F, itemsize)
    block_rate = H100_BF16_FLOPS if block_itemsize == 2 else H100_F32_FLOPS
    seconds = max(
        (blocks * block_itemsize + remainder.bytes) / H100_BYTES_PER_S,
        2 * blocks * F / block_rate + remainder.operations / H100_F32_FLOPS,
    )
    return seconds * 1e3


def exchange_bound(n_slots: int, F: int, itemsize: int) -> Bound:
    """The halo exchange of ``parallel/halo.py`` within one card: each of
    ``n_slots`` received rows read once and written once, with its int64
    gather index (the rows a collective would carry between cards)."""
    moved = n_slots * (2 * F * itemsize + 8)
    return Bound(bytes=moved, noreuse_bytes=moved, operations=0)
