"""SDDMM: per-edge dot products, and the plain edge gathers.

Port of ``gnn_tpu/ops/sddmm.py``: plain torch gathers and a reduction, as
the JAX package's are plain ``jnp``. (The gathers whose backward runs the
kernels are :mod:`gnn_tpu_torch.ops.gather`'s, over an adjacency.)
"""

from __future__ import annotations

import torch

__all__ = ["sddmm", "gather_src", "gather_dst"]


def sddmm(
    src: torch.Tensor, dst: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *, backend: str = "auto"
) -> torch.Tensor:
    """out[e] = <a[dst[e]], b[src[e]]>; a [N_dst, F], b [N_src, F] -> [E]."""
    del backend  # accepted for parity with the JAX package
    return (a.index_select(0, dst.long()) * b.index_select(0, src.long())).sum(-1)


def gather_src(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """x_j: the features of each edge's source."""
    return x.index_select(0, src.long())


def gather_dst(x: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """x_i: the features of each edge's destination."""
    return x.index_select(0, dst.long())
