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
  gathers nothing per step;
* ``edge_agg``/``t_edge_agg``: properties, the CSRs over edge positions of
  :mod:`gnn_tpu_torch.ops.edge_agg` made from the arrays above (no copy),
  not None exactly where the JAX package builds its slot tables.

``reorder=True`` / ``'auto'`` relabels a degree-symmetric graph's nodes by
degree bucket (:func:`~gnn_tpu_torch.graphs.sorted_ell.degree_bucket_order`,
the JAX package's ``perm`` element for element) and ``reorder='cluster'`` by
community into packed windows (:mod:`gnn_tpu_torch.graphs.blocked`, the JAX
package's ``perm`` too); ``perm`` is then the new -> old node map. Index
arrays are int32, as the kernels take them. ``layout`` records which layout
the JAX package would have built (``'sorted'``, ``'ell'``, ``'csr'`` or
``'blocked'``), so that the ``spmm`` backends raise where it raises; the TPU
layouts themselves (ELL and sorted-ELL slot tables, chunk plans, the blocked
layout's dense windows and remainder) are not built: every layout is the
CSR here.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

if TYPE_CHECKING:
    from gnn_tpu_torch.ops.edge_agg import EdgeAggLayout

__all__ = ["Adjacency", "build_adjacency"]

_NOT_TENSORS = ("num_src_nodes", "num_dst_nodes", "layout")
# the JAX package's backends for its blocked layout's remainder; checked,
# and none builds anything here
_REM_BACKENDS = ("auto", "bucket", "levels", "kernel")


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
    perm: Optional[torch.Tensor] = None  # [N] int32 new -> old node id (reorder)
    layout: str = "csr"  # the JAX package's layout: 'sorted', 'ell', 'csr' or 'blocked'

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    def edge_agg_layouts(self) -> tuple:
        """The two edge-position CSRs of this adjacency's arrays: by
        destination (``row_ptr``, identity positions, ``dst``) and by source
        (``t_row_ptr``, ``t_perm``, ``src``). Views, no copy."""
        from gnn_tpu_torch.ops.edge_agg import EdgeAggLayout

        E = self.num_edges
        return (
            EdgeAggLayout(self.row_ptr, None, self.dst, self.num_dst_nodes, E),
            EdgeAggLayout(self.t_row_ptr, self.t_perm, self.src, self.num_src_nodes, E),
        )

    @property
    def edge_agg(self) -> Optional[EdgeAggLayout]:
        """The by-destination edge-position CSR (K2) where the JAX package
        builds its ``edge_agg`` (layouts ``'ell'`` and ``'sorted'``), else None."""
        return self.edge_agg_layouts()[0] if self.layout in ("ell", "sorted") else None

    @property
    def t_edge_agg(self) -> Optional[EdgeAggLayout]:
        """The by-source edge-position CSR (K1 over ``t_perm``), present
        with :attr:`edge_agg`."""
        return self.edge_agg_layouts()[1] if self.layout in ("ell", "sorted") else None

    def to(self, device) -> "Adjacency":
        """A copy with every tensor and layout on ``device``."""
        move = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self,
            **{
                f.name: move(getattr(self, f.name))
                for f in dataclasses.fields(self)
                if f.name not in _NOT_TENSORS
            },
        )

    def with_weight(self, weight: Optional[torch.Tensor]) -> "Adjacency":
        """Swap the edge weights (in the dst-sorted edge order), re-baking the
        cached transpose weights. For differentiable per-edge weights use
        ``ops.spmm_edge_weighted``."""
        return dataclasses.replace(
            self,
            weight=weight,
            t_weight=None if weight is None else weight.index_select(0, self.t_perm.long()).contiguous(),
        )

    def unweighted(self) -> "Adjacency":
        """``with_weight(None)``, made once per adjacency and kept on it: a
        layer that sums plain neighbours (GIN) asks for it every forward,
        and the cache keeps the building of a new Adjacency out of the
        step's host work."""
        if self.weight is None:
            return self
        cached = self.__dict__.get("_unweighted")
        if cached is None:
            cached = self.with_weight(None)
            object.__setattr__(self, "_unweighted", cached)
        return cached

    def transpose(self) -> "Adjacency":
        """A^T as an Adjacency (edges re-sorted by the old src), keeping
        ``perm`` and ``layout``. The edge-position CSRs follow the
        transposed arrays, which is what the JAX package's remapping of its
        slot tables amounts to."""
        inv = torch.empty_like(self.t_perm)
        inv[self.t_perm.long()] = torch.arange(self.num_edges, dtype=inv.dtype, device=inv.device)
        idx = self.t_perm.long()
        return Adjacency(
            src=self.t_col,
            dst=self.src.index_select(0, idx),
            row_ptr=self.t_row_ptr,
            weight=self.t_weight,
            t_perm=inv,
            t_row_ptr=self.row_ptr,
            t_col=self.src,
            t_weight=self.weight,
            num_src_nodes=self.num_dst_nodes,
            num_dst_nodes=self.num_src_nodes,
            perm=self.perm,
            layout=self.layout,
        )


def _csr_offsets(sorted_ids: np.ndarray, n: int) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(np.bincount(sorted_ids, minlength=n))])


def _cluster_perm(src, dst, n, *, rows, labels, n_iters, seed, refine) -> np.ndarray:
    """The community-packed node order (new -> old) of
    ``gnn_tpu/graphs/adjacency.py:315-365``: label propagation capped at
    ``rows`` (or the caller's labels), packing into windows, boundary
    refinement, then a sort within windows by remainder degree."""
    from gnn_tpu_torch import native
    from gnn_tpu_torch.graphs.blocked import cluster_pack_order, refine_pack_order, refine_window_order

    order0, rp0 = native.sort_edges_csr(src, dst, n)
    if labels is None:
        labels, _ = native.label_propagation(rp0, src[order0], max_size=rows, n_iters=n_iters, seed=seed)
    else:
        labels = np.asarray(labels, np.int64)
        if labels.shape != (n,):
            raise ValueError(f"cluster_labels must be [{n}], got {labels.shape}")
    packed = refine_window_order(
        cluster_pack_order(labels, rows), rows, row_ptr=rp0, col=src[order0], n_sweeps=refine
    )
    return refine_pack_order(packed, src, dst, rows)


def _degree_perm(src, dst, num_src_nodes, num_dst_nodes, reorder, hub_dense) -> Optional[np.ndarray]:
    """The degree-bucket node order (new -> old) of
    ``gnn_tpu/graphs/adjacency.py:368-404``, or None where ``'auto'`` keeps
    the ids. Degrees count the non-self edges; with ``hub_dense`` the order
    comes from the in-degree over the edges whose source is not a hub."""
    from gnn_tpu_torch.graphs.sorted_ell import degree_bucket_order

    ns_mask = src != dst
    deg_in = np.bincount(dst[ns_mask], minlength=num_dst_nodes)
    symmetric = num_src_nodes == num_dst_nodes and np.array_equal(
        deg_in, np.bincount(src[ns_mask], minlength=num_src_nodes)
    )
    if not symmetric:
        if reorder != "auto":
            raise ValueError(
                "build_adjacency(reorder=True) needs a degree-symmetric "
                "graph (in-degree == out-degree per node); pass "
                "reorder='auto' to fall back, or symmetrize the edges "
                "(graphs.to_undirected)"
            )
        return None
    deg_order = deg_in
    if hub_dense is not None:
        is_hot = deg_in >= hub_dense
        if is_hot.any():
            deg_order = np.bincount(dst[ns_mask & ~is_hot[src]], minlength=num_dst_nodes)
    return degree_bucket_order(deg_order)


def _jax_layout(layout: str, num_edges: int, relabelled: bool, cluster: bool, ell_buckets) -> str:
    """The layout the JAX package builds for these arguments
    (``gnn_tpu/graphs/adjacency.py:430-481``), with its errors."""
    if layout == "auto":
        layout = "ell" if num_edges >= 2048 else "csr"
    if cluster:
        return "blocked"
    if relabelled and layout == "ell":
        return "sorted"
    if layout == "ell":
        if ell_buckets is not None and len(ell_buckets) == 0:
            raise ValueError("ell_buckets must be a non-empty width tuple")
    elif layout != "csr":
        raise ValueError(f"unknown layout '{layout}' (expected auto/ell/csr)")
    return layout


def build_adjacency(
    edge_index,
    edge_weight=None,
    *,
    num_nodes: Optional[int] = None,
    num_src_nodes: Optional[int] = None,
    num_dst_nodes: Optional[int] = None,
    layout: str = "auto",
    ell_buckets=None,
    reorder=False,
    hub_dense: Optional[int] = None,
    hub_dtype=None,
    block_rows: int = 256,
    block_dtype: Optional[torch.dtype] = None,
    rem_backend: str = "auto",
    cluster_labels=None,
    cluster_iters: int = 10,
    cluster_seed: int = 0,
    cluster_refine: int = 2,
) -> Adjacency:
    """Prepare an :class:`Adjacency` (on the CPU) from a COO edge list [2, E].

    ``reorder=True`` or ``"auto"`` relabels the nodes of a degree-symmetric
    graph (in-degree == out-degree per node over the non-self edges, e.g. any
    symmetrized GCN graph) by degree bucket, as the JAX package does for its
    sorted layout: ``perm`` equals its ``adj.perm``. On another graph
    ``True`` raises the JAX package's ``ValueError`` and ``"auto"`` keeps the
    ids. ``hub_dense`` (with ``True`` / ``"auto"`` only) takes the order from
    the in-degree over edges whose source has fewer than ``hub_dense``
    in-edges, as the JAX package does; its dense hub block and
    ``hub_dtype`` are TPU machinery and build nothing here. ``"cluster"``
    relabels them into community-packed windows of ``block_rows`` nodes
    (``cluster_*`` steer the label propagation and the boundary refinement)
    and builds the CSR over the new ids. The JAX package's blocked layout is
    TPU machinery too: ``block_dtype`` (its dense windows' type) and
    ``rem_backend`` (its remainder's backend, checked for the JAX package's
    values) build nothing here. A relabelled adjacency speaks the new id
    space: feed ``x[adj.perm]`` (``Data.permute_nodes``).

    ``layout`` (``"auto"``, ``"ell"`` or ``"csr"``; ``ell_buckets`` for
    ``"ell"``) takes the JAX package's values and errors, and every value
    builds the CSR; ``adj.layout`` records the JAX package's choice, and
    ``edge_agg`` / ``t_edge_agg`` are present where that choice is
    ``'ell'`` or ``'sorted'``, as there.
    """
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

    perm = None
    cluster = reorder == "cluster"
    if cluster:
        if num_src_nodes != num_dst_nodes:
            raise ValueError("reorder='cluster' needs a square adjacency")
        if hub_dense is not None:
            raise ValueError(
                "hub_dense applies to the degree-bucket layout only; the "
                "blocked layout absorbs dense structure into its diagonal "
                "blocks instead"
            )
        perm = _cluster_perm(
            src, dst, num_dst_nodes, rows=int(block_rows), labels=cluster_labels,
            n_iters=cluster_iters, seed=cluster_seed, refine=cluster_refine,
        )
        if rem_backend not in _REM_BACKENDS:
            raise ValueError(f"unknown rem_backend '{rem_backend}'")
    else:
        if hub_dense is not None and not reorder:
            raise ValueError("hub_dense requires reorder=True/'auto'")
        if reorder:
            perm = _degree_perm(src, dst, num_src_nodes, num_dst_nodes, reorder, hub_dense)
    if perm is not None:
        old2new = np.empty(num_dst_nodes, np.int64)
        old2new[perm] = np.arange(num_dst_nodes)
        src, dst = old2new[src], old2new[dst]

    order = np.lexsort((src, dst))
    src, dst = src[order], dst[order]
    row_ptr = _csr_offsets(dst, num_dst_nodes)
    t_perm = np.lexsort((dst, src))
    t_row_ptr = _csr_offsets(src[t_perm], num_src_nodes)
    w = None if edge_weight is None else np.asarray(edge_weight, np.float32)[order]
    layout = _jax_layout(layout, len(src), perm is not None, cluster, ell_buckets)

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
        perm=None if perm is None else i32(perm),
        layout=layout,
    )
