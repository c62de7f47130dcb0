"""Sparse adjacency in CSR form, as torch tensors.

Port of ``gnn_tpu/graphs/adjacency.py`` (``Adjacency``, ``build_adjacency``)
for the CSR layout, which is what the hand-written kernels read:

* ``src``/``dst``: COO endpoints sorted by dst, stable in src
  (``np.lexsort((src, dst))``), so row i's in-edges are the contiguous range
  ``[row_ptr[i], row_ptr[i+1])``;
* ``weight``: optional per-edge value (e.g. the exact GCN norm);
* ``t_perm``/``t_row_ptr``: the src-sorted permutation and its offsets, so
  the transpose product of the backward pass is a CSR product too;
* ``t_col``/``t_weight``: the transpose's column and weight arrays
  (``dst[t_perm]``, ``weight[t_perm]``), cached so that the backward pass
  gathers nothing per step.

Index arrays are int32, as the kernels take them. The JAX package's relabelled
and TPU-specific layouts (ELL, sorted-ELL, blocked, chunk plans) are not
built: ``reorder=True``/``'cluster'`` and ``layout='ell'`` raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["Adjacency", "build_adjacency"]


@dataclasses.dataclass(frozen=True)
class Adjacency:
    src: torch.Tensor  # [E] int32, dst-sorted edge order
    dst: torch.Tensor  # [E] int32, ascending
    row_ptr: torch.Tensor  # [N_dst + 1] int32
    weight: Optional[torch.Tensor]  # [E] float32 or None (= all ones)
    t_perm: torch.Tensor  # [E] int32: src-sorted position -> dst-sorted edge
    t_row_ptr: torch.Tensor  # [N_src + 1] int32
    t_col: torch.Tensor  # [E] int32: dst[t_perm]
    t_weight: Optional[torch.Tensor]  # [E] float32: weight[t_perm]
    num_src_nodes: int
    num_dst_nodes: int

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    def to(self, device) -> "Adjacency":
        move = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self,
            **{
                f.name: move(getattr(self, f.name))
                for f in dataclasses.fields(self)
                if f.name not in ("num_src_nodes", "num_dst_nodes")
            },
        )


def _csr_offsets(sorted_ids: np.ndarray, n: int) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(np.bincount(sorted_ids, minlength=n))])


def build_adjacency(
    edge_index,
    edge_weight=None,
    *,
    num_nodes: Optional[int] = None,
    num_src_nodes: Optional[int] = None,
    num_dst_nodes: Optional[int] = None,
    layout: str = "auto",
    reorder=False,
) -> Adjacency:
    """Prepare an :class:`Adjacency` (on the CPU) from a COO edge list [2, E].

    ``reorder`` of ``False`` or ``"auto"`` keeps the node ids: there is no
    relabelled layout to build for. ``layout`` of ``"auto"`` or ``"csr"``
    builds the CSR arrays, which is all the kernels read.
    """
    if reorder not in (False, "auto"):
        raise NotImplementedError(
            f"build_adjacency(reorder={reorder!r}) is not ported yet "
            "(ROADMAP Queue 1 items 9 and 12); use reorder=False"
        )
    if layout not in ("auto", "csr"):
        raise NotImplementedError(
            f"layout '{layout}' is not ported (ROADMAP Queue 1 item 9); "
            "the port builds CSR only"
        )
    ei = np.asarray(edge_index)
    if ei.ndim != 2 or ei.shape[0] != 2:
        raise ValueError(f"edge_index must be [2, E], got {ei.shape}")
    src, dst = ei[0].astype(np.int64), ei[1].astype(np.int64)
    if num_nodes is not None:
        num_src_nodes = num_dst_nodes = num_nodes
    if num_src_nodes is None:
        num_src_nodes = int(src.max()) + 1 if src.size else 0
    if num_dst_nodes is None:
        num_dst_nodes = int(dst.max()) + 1 if dst.size else 0
    if src.size and (src.min() < 0 or src.max() >= num_src_nodes):
        raise ValueError("edge source ids out of range")
    if dst.size and (dst.min() < 0 or dst.max() >= num_dst_nodes):
        raise ValueError("edge destination ids out of range")
    if max(num_src_nodes, num_dst_nodes, src.size) > np.iinfo(np.int32).max:
        raise ValueError("node and edge counts must fit int32 for the kernels")

    order = np.lexsort((src, dst))
    src, dst = src[order], dst[order]
    row_ptr = _csr_offsets(dst, num_dst_nodes)
    t_perm = np.lexsort((dst, src))
    t_row_ptr = _csr_offsets(src[t_perm], num_src_nodes)
    w = None if edge_weight is None else np.asarray(edge_weight, np.float32)[order]

    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    f32 = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))
    return Adjacency(
        src=i32(src),
        dst=i32(dst),
        row_ptr=i32(row_ptr),
        weight=f32(w),
        t_perm=i32(t_perm),
        t_row_ptr=i32(t_row_ptr),
        t_col=i32(dst[t_perm]),
        t_weight=None if w is None else f32(w[t_perm]),
        num_src_nodes=int(num_src_nodes),
        num_dst_nodes=int(num_dst_nodes),
    )
