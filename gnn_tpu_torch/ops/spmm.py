"""Sparse x dense product (SpMM) over a CSR adjacency — the hot op.

Port of ``gnn_tpu/ops/spmm.py::spmm``: out[d] = sum over in-edges
e=(s -> d) of w_e * x[s], differentiable in x (dx = A^T g through the
transpose CSR) and in the edge weights. On the card both directions run
kernel K1 (``ops/cuda/spmm.py``); on the CPU its plain version.

The JAX package's layout backends ('ell', 'sorted', 'blocked') are TPU
layouts that the port does not build (ROADMAP Queue 1 items 9 and 12); they
raise here.
"""

from __future__ import annotations

import torch

from gnn_tpu_torch.graphs.adjacency import Adjacency
from gnn_tpu_torch.ops.cuda.spmm import spmm_csr

__all__ = ["spmm", "spmm_edge_weighted"]

_UNPORTED = ("ell", "sorted", "blocked", "pallas")


def spmm(adj: Adjacency, x: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """out = A @ x, A given by ``adj`` (logically [N_dst, N_src]).

    ``backend`` is accepted for signature parity with the JAX package only:
    'auto' and 'segment' both run K1, and the TPU layouts raise.
    """
    if x.ndim != 2:
        raise ValueError(f"spmm expects x of rank 2 [N, F], got {tuple(x.shape)}")
    if backend in _UNPORTED:
        raise NotImplementedError(
            f"spmm backend '{backend}' is a TPU layout the port does not build "
            "(ROADMAP Queue 1 items 9 and 12); use 'auto' or 'segment'"
        )
    if backend not in ("auto", "segment"):
        raise ValueError(f"unknown spmm backend '{backend}'")
    return spmm_csr(adj, x)


def spmm_edge_weighted(adj: Adjacency, weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """SpMM with caller-supplied differentiable per-edge weights, in the
    adjacency's dst-sorted edge order."""
    if x.ndim != 2:
        raise ValueError(f"spmm expects x of rank 2 [N, F], got {tuple(x.shape)}")
    return spmm_csr(adj, x, weight)
