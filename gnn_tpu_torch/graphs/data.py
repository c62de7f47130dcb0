"""Graph data container.

Port of ``gnn_tpu/graphs/data.py::Data``: node features ``x`` [N, F], COO
``edge_index`` [2, E], optional ``edge_attr``, labels ``y`` (integer labels
as int64, float targets in their own dtype, any trailing shape) and the
train/val/test masks, held as torch tensors. ``to(device)`` moves them;
``to_adjacency`` runs the one-time host prep (exact ``gcn_norm`` and the CSR
build) and returns an :class:`~gnn_tpu_torch.graphs.adjacency.Adjacency` on
the CPU, ``to_dist_graph`` the same prep partitioned over a mesh's parts;
``permute_nodes`` moves the node arrays into a relabelled order.
``Data(host_arrays=True)`` keeps every array as host numpy (``x`` may be an
``np.memmap``) for ``train.host_features``, which samples and gathers on the
host; such a ``Data`` never moves to a device.
:class:`Batch` merges several graphs into one block-diagonal graph.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from gnn_tpu_torch.graphs import convert, transforms
from gnn_tpu_torch.graphs.adjacency import Adjacency, build_adjacency

__all__ = ["Data", "Batch", "TRAIN", "VAL", "TEST"]

TRAIN, VAL, TEST = "train", "val", "test"  # the split names of ``set_mask``


def _tensor(a, dtype=None) -> Optional[torch.Tensor]:
    if a is None:
        return None
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _numpy(a) -> Optional[np.ndarray]:
    return None if a is None else convert.as_numpy(a)


@dataclasses.dataclass(init=False)
class Data:
    x: Optional[torch.Tensor]  # [N, F] node features
    edge_index: torch.Tensor  # [2, E] int64 COO
    edge_attr: Optional[torch.Tensor]  # [E] or [E, D]
    y: Optional[torch.Tensor]  # [N] or [N, ...] labels: int64, or a float dtype
    train_mask: Optional[torch.Tensor]  # [N] bool
    val_mask: Optional[torch.Tensor]
    test_mask: Optional[torch.Tensor]
    num_nodes: int
    host_arrays: bool  # every array above is numpy and stays on the host

    def __init__(
        self,
        x=None,
        edge_index=None,
        edge_attr=None,
        y=None,
        *,
        num_nodes: Optional[int] = None,
        train_mask=None,
        val_mask=None,
        test_mask=None,
        host_arrays: bool = False,
    ):
        """``host_arrays=True`` keeps every array as host numpy, ``edge_index``
        as int32, and copies nothing: the regime where ``x`` (and the edge
        list) exceed the device's memory. Pair it with
        ``train.host_features``. Every shape and range check still runs."""
        if edge_index is None:
            edge_index = np.zeros((2, 0), np.int64)
        edge_index = _numpy(edge_index) if host_arrays else _tensor(edge_index)
        if edge_index.ndim != 2 or edge_index.shape[0] != 2:
            raise ValueError(
                f"edge_index must have shape [2, num_edges], got {tuple(edge_index.shape)}"
            )
        integral = (
            np.issubdtype(edge_index.dtype, np.integer)
            if host_arrays
            else not (edge_index.dtype.is_floating_point or edge_index.dtype == torch.bool)
        )
        if not integral:
            raise ValueError(f"edge_index must be integer-typed, got {edge_index.dtype}")
        if num_nodes is None:
            if x is not None:
                num_nodes = int(x.shape[0])
            elif edge_index.shape[1]:
                num_nodes = int(edge_index.max()) + 1
            else:
                num_nodes = 0
        if edge_index.shape[1]:
            lo, hi = int(edge_index.min()), int(edge_index.max())
            if lo < 0 or hi >= num_nodes:
                raise ValueError(
                    f"edge_index references node {hi if hi >= num_nodes else lo} "
                    f"but num_nodes={num_nodes}"
                )
        if x is not None and x.shape[0] != num_nodes:
            raise ValueError(f"x has {x.shape[0]} rows but num_nodes={num_nodes}")
        if edge_attr is not None and edge_attr.shape[0] != edge_index.shape[1]:
            raise ValueError(
                f"edge_attr has {edge_attr.shape[0]} entries for "
                f"{edge_index.shape[1]} edges"
            )
        if y is not None and y.shape[0] not in (num_nodes, 1):
            raise ValueError(f"y has {y.shape[0]} entries for {num_nodes} nodes")
        for name, m in (
            ("train_mask", train_mask),
            ("val_mask", val_mask),
            ("test_mask", test_mask),
        ):
            if m is not None and m.shape[0] != num_nodes:
                raise ValueError(f"{name} has {m.shape[0]} entries for {num_nodes} nodes")
        self.num_nodes = int(num_nodes)
        self.host_arrays = bool(host_arrays)
        if host_arrays:
            # The int32 cast below would wrap node ids past 2^31 silently.
            if num_nodes > np.iinfo(np.int32).max:
                raise ValueError(
                    f"num_nodes={num_nodes} exceeds int32: host-array node ids would "
                    "overflow; shard the node space first"
                )
            mask = lambda m: None if m is None else np.asarray(_numpy(m), bool)
            self.x = _numpy(x)
            self.edge_index = np.asarray(edge_index, np.int32)
            self.edge_attr = _numpy(edge_attr)
            self.y = _numpy(y)
            self.train_mask, self.val_mask, self.test_mask = mask(train_mask), mask(val_mask), mask(test_mask)
            return
        self.x = _tensor(x)
        self.edge_index = edge_index.to(torch.int64)
        self.edge_attr = _tensor(edge_attr)
        self.y = _tensor(y)
        if self.y is not None and not self.y.dtype.is_floating_point:
            self.y = self.y.to(torch.int64)
        self.train_mask = _tensor(train_mask, torch.bool)
        self.val_mask = _tensor(val_mask, torch.bool)
        self.test_mask = _tensor(test_mask, torch.bool)

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    @property
    def num_features(self) -> int:
        return 0 if self.x is None else int(self.x.shape[-1])

    def to(self, device) -> "Data":
        """A copy with every tensor on ``device``."""
        if self.host_arrays:
            raise ValueError(
                "a Data(host_arrays=True) stays on the host: train it with "
                "train.host_features, or build a Data without host_arrays"
            )
        out = copy.copy(self)
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                setattr(out, f.name, v.to(device))
        return out

    def to_adjacency(
        self,
        *,
        add_self_loops: bool = True,
        norm: Optional[str] = "sym",
        improved: bool = False,
        reorder=False,
        **build_kwargs,
    ) -> Adjacency:
        """One-time host prep: COO -> normalized CSR Adjacency (on the CPU;
        move it with ``.to(device)``).

        ``reorder`` (True / ``'auto'``) relabels a degree-symmetric graph
        by degree bucket; ``reorder='cluster'`` by community, into packed
        windows of ``block_rows`` nodes. The other knobs (``layout``,
        ``ell_buckets``, ``hub_dense``, ``hub_dtype``, ``block_rows``,
        ``block_dtype``, ...) pass through to
        :func:`~gnn_tpu_torch.graphs.adjacency.build_adjacency`. A
        relabelled adjacency speaks a new node space: pair it with
        ``permute_nodes(adj.perm)``."""
        ei, ew = _numpy(self.edge_index), _numpy(self.edge_attr)
        if ew is not None and ew.ndim > 1:
            ew = None  # vector-valued edge attrs are features, not weights
        if norm in ("sym", "rw", "row"):
            ei, ew = transforms.gcn_norm(
                ei, ew, self.num_nodes,
                self_loops=add_self_loops, improved=improved, norm=norm,
            )
        elif add_self_loops:
            ei, ew = transforms.add_remaining_self_loops(ei, ew, num_nodes=self.num_nodes)
        return build_adjacency(ei, ew, num_nodes=self.num_nodes, reorder=reorder, **build_kwargs)

    def to_dist_graph(
        self,
        *,
        mesh,
        halo: str = "alltoall",
        axis_name: str = "data",
        add_self_loops: bool = True,
        norm: Optional[str] = "sym",
        improved: bool = False,
        local_blocked: int = 0,
        block_dtype: Optional[torch.dtype] = None,
    ):
        """Multi-device counterpart of :meth:`to_adjacency`: the same
        normalization prep, then a node partition over the mesh's
        ``axis_name`` axis, on the mesh's device
        (:func:`~gnn_tpu_torch.parallel.partition_graph`).
        ``local_blocked=R`` (halo='overlap') aligns the parts to windows of
        R nodes; pair it with a ``graphs.cluster_order(..., pack_rows=R)``
        relabelling first. ``block_dtype`` is the JAX package's type for its
        dense blocks and builds nothing here."""
        from gnn_tpu_torch.parallel.partition import partition_graph

        ei, ew = _numpy(self.edge_index), _numpy(self.edge_attr)
        if ew is not None and ew.ndim > 1:
            ew = None
        if norm in ("sym", "rw", "row"):
            ei, ew = transforms.gcn_norm(
                ei, ew, self.num_nodes, self_loops=add_self_loops, improved=improved, norm=norm,
            )
        elif add_self_loops:
            ei, ew = transforms.add_remaining_self_loops(ei, ew, num_nodes=self.num_nodes)
        return partition_graph(
            ei, ew, num_nodes=self.num_nodes, mesh=mesh, axis_name=axis_name, halo=halo,
            local_blocked=local_blocked, block_dtype=block_dtype,
        )

    def permute_nodes(self, perm) -> "Data":
        """Relabel nodes so that new id i is old id ``perm[i]`` (new -> old):
        x, y and the masks are gathered, ``edge_index`` is relabelled.
        GNNs are permutation-equivariant, so training on the result is exact."""
        perm = torch.as_tensor(perm).long().cpu()
        old2new = torch.empty(self.num_nodes, dtype=torch.int64)
        old2new[perm] = torch.arange(self.num_nodes)
        out = copy.copy(self)
        for name in ("x", "y", "train_mask", "val_mask", "test_mask"):
            v = getattr(self, name)
            if v is None:
                continue
            if self.host_arrays:
                setattr(out, name, v[perm.numpy()])
            else:
                setattr(out, name, v.index_select(0, perm.to(v.device)))
        if self.host_arrays:
            out.edge_index = old2new.numpy()[self.edge_index].astype(np.int32)
        else:
            out.edge_index = old2new.to(self.edge_index.device)[self.edge_index]
        return out

    def set_mask(self, mask, split: str) -> "Data":
        """A copy with the ``split`` mask (``TRAIN``, ``VAL`` or ``TEST``)
        replaced by ``mask`` [N] (cast to bool)."""
        if split not in (TRAIN, VAL, TEST):
            raise ValueError(f"split must be one of {TRAIN}/{VAL}/{TEST}, got {split}")
        if self.host_arrays:
            mask = np.asarray(_numpy(mask), bool)
        else:
            mask = _tensor(mask, torch.bool).to(self.edge_index.device)
        if mask.shape[0] != self.num_nodes:
            raise ValueError(f"{split}_mask has {mask.shape[0]} entries for {self.num_nodes} nodes")
        out = copy.copy(self)
        setattr(out, f"{split}_mask", mask)
        return out

    def to_dense_adj(self) -> torch.Tensor:
        """Dense [N, N] float32 with ``A[dst, src] = edge_attr`` (ones without
        it); for tests and small graphs only."""
        return convert.to_dense_adj(self.edge_index, self.edge_attr, self.num_nodes)


@dataclasses.dataclass(init=False)
class Batch(Data):
    """Block-diagonal merge of several graphs: node ids are offset graph by
    graph, and ``graph_id`` says which graph each node came from."""

    graph_id: torch.Tensor  # [N_total] int32, ascending
    num_graphs: int

    def __init__(self, data_list: Sequence[Data]):
        if not data_list:
            raise ValueError("Batch requires at least one graph")
        xs, eis, eas, ys, gids = [], [], [], [], []
        offset = 0
        for i, d in enumerate(data_list):
            if d.x is not None:
                xs.append(d.x)
            eis.append(d.edge_index + offset)
            if d.edge_attr is not None:
                eas.append(d.edge_attr)
            if d.y is not None:
                ys.append(torch.atleast_1d(d.y))
            gids.append(torch.full((d.num_nodes,), i, dtype=torch.int32))
            offset += d.num_nodes
        super().__init__(
            x=torch.cat(xs) if xs else None,
            edge_index=torch.cat(eis, dim=1),
            edge_attr=torch.cat(eas) if eas else None,
            y=torch.cat(ys) if ys else None,
            num_nodes=offset,
        )
        self.graph_id = torch.cat(gids)
        self.num_graphs = len(data_list)
