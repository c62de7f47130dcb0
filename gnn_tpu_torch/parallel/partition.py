"""Graph partitioning for multi-device message passing.

Port of ``gnn_tpu/parallel/partition.py``: a 1-D partition of the nodes over
the mesh's ``data`` axis. Part p owns the contiguous node range ``[p n_max,
(p + 1) n_max)``, the in-edges of its nodes (the forward product) and their
out-edges (the transpose product of the backward pass, partitioned by source
owner so that it is a local reduction after the exchange too). Node arrays
live in the padded layout ``[P n_max, ...]`` (:meth:`DistGraph.shard_nodes`);
padding rows take part in nothing.

The plan is the JAX package's, array for array: ``n_max`` aligned to 8 (or
to the window ``R`` of ``local_blocked``), the per-part forward and backward
edge lists lexsorted, the targeted exchange's ``send_idx`` / ``t_send_idx``
[P, P, h_max] with one ``h_max`` for both directions, the overlap mode's
local / remote split and its ``diag`` [P, B, R, R] blocks, and the
edge-parallel arrays ``esrc_coord``, ``edst_row``, ``edge_id`` and
``in_degree`` [P, ...]. Where the JAX package stacks ELL slot tables (TPU
machinery), the port builds CSRs as :class:`~gnn_tpu_torch.graphs.Adjacency`
objects over the parts of this process laid end to end, so that one kernel
launch serves every local part of a direction:

* the exchange buffer of the targeted modes is ``[x (L n_max) | recv (L P
  h_max)]``, part l's recv slots at ``L n_max + l P h_max``; that of
  ``'allgather'`` is the gathered ``[P n_max]`` layout, shared by the parts;
* ``adj`` / ``t_adj``: forward and transpose products into that buffer
  (overlap: ``adj`` reads the owned rows, ``adj_rem`` the recv slots);
* ``inc``: the incidence CSR, rows = buffer rows, entries = the positions of
  the local edges in the ``[L e_max]`` per-edge layout whose source they hold
  (the scatter-free VJP of :func:`~gnn_tpu_torch.parallel.gather_src_dist`);
* ``send``: rows = owned nodes, entries = the returned remote partials that
  belong to each of them (the VJP's return of partials without a scatter);
* ``exchange_idx`` / ``t_exchange_idx``: the rows each exchange gathers, in
  the order its collective sends them; ``esrc_index`` / ``edst_index``: the
  buffer rows of each local edge's ends; ``dst_row_ptr``: the destination CSR
  of the per-edge layout with one extra row a part for its padding edges.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gnn_tpu_torch.graphs.adjacency import Adjacency
from gnn_tpu_torch.graphs.convert import as_numpy

__all__ = ["DistGraph", "partition_graph"]

_TENSOR_FIELDS = (
    "adj", "t_adj", "adj_rem", "t_adj_rem", "inc", "send", "diag", "send_idx", "t_send_idx",
    "exchange_idx", "t_exchange_idx", "esrc_coord", "edst_row", "edge_id", "in_degree",
    "esrc_index", "edst_index", "dst_row_ptr",
)


@dataclasses.dataclass(frozen=True)
class DistGraph:
    """Node-partitioned graph: the CSRs and indices of this process's parts
    (all P of them without a process group), on one device."""

    adj: Adjacency  # forward product; overlap: over the owned rows only
    t_adj: Adjacency  # transpose product (dx); overlap: owned rows only
    send_idx: Optional[torch.Tensor]  # [L, P, H] int32: rows local part l sends to part q
    t_send_idx: Optional[torch.Tensor]  # the same for the backward (cotangents)
    exchange_idx: Optional[torch.Tensor]  # [L P H] int64: send_idx as gather rows, send order
    t_exchange_idx: Optional[torch.Tensor]
    adj_rem: Optional[Adjacency] = None  # overlap: remote-source in-edges, over the recv slots
    t_adj_rem: Optional[Adjacency] = None
    # overlap + local_blocked=R: [L, B, R, R] dense blocks of the local
    # intra-window edges (excluded from adj / t_adj); the backward uses the
    # same blocks transposed
    diag: Optional[torch.Tensor] = None
    # edge-parallel arrays (None when edge_parallel=False)
    esrc_coord: Optional[torch.Tensor] = None  # [L, E_max] int32, the JAX plan, pad -> n_buf
    edst_row: Optional[torch.Tensor] = None  # [L, E_max] int32, pad -> n_max
    edge_id: Optional[torch.Tensor] = None  # [L, E_max] int32 input-order edge id, pad -> E
    in_degree: Optional[torch.Tensor] = None  # [L, n_max] float32 in-degree of owned nodes
    inc: Optional[Adjacency] = None  # buffer rows <- local edge positions
    send: Optional[Adjacency] = None  # owned rows <- returned remote partials (targeted)
    esrc_index: Optional[torch.Tensor] = None  # [L E_max] int64 buffer row, pad -> zero row
    edst_index: Optional[torch.Tensor] = None  # [L E_max] int64 l n_max + dst, pad -> L n_max
    dst_row_ptr: Optional[torch.Tensor] = None  # [L (n_max + 1) + 1] int32
    num_parts: int = 1
    unit_weight: bool = False  # with_weight(None) of a weight-baked partition
    n_max: int = 0  # owned nodes a part (padded)
    num_nodes: int = 0  # true global node count
    mesh: object = None  # parallel.Mesh
    axis_name: str = "data"
    halo: str = "allgather"
    block_rows: int = 0  # R of the local diag blocks
    h_max: int = 0  # padded per-pair halo size
    e_max: int = 0  # padded per-part edge count
    has_weight: bool = False  # baked edge weights?
    num_local_parts: int = 1  # L: the parts this process holds
    first_part: int = 0  # the global index of its first part
    grouped: bool = False  # the exchanges ride a torch.distributed group
    group: object = None  # that group: the mesh's data_group (ProcessGroup)

    @property
    def n_buf(self) -> int:
        """Per-part halo-buffer length the edge ``esrc_coord``s index into:
        [own rows | recv slots] for the targeted modes, the padded global
        layout for 'allgather'."""
        if self.halo in ("alltoall", "overlap"):
            return self.n_max + self.num_parts * self.h_max
        return self.num_parts * self.n_max

    @property
    def device(self) -> torch.device:
        return self.adj.device

    def to(self, device) -> "DistGraph":
        """A copy with every tensor and CSR on ``device``."""
        move = lambda v: None if v is None else v.to(device)
        return dataclasses.replace(self, **{f: move(getattr(self, f)) for f in _TENSOR_FIELDS})

    def with_weight(self, weight) -> "DistGraph":
        """``weight=None`` only, as in the JAX package: the identity on a
        partition built without edge weights; on a weight-baked one, a view
        whose ``spmm`` runs the dynamic edge-parallel path with unit weights.
        Weights are baked at ``partition_graph`` time."""
        if weight is not None:
            raise ValueError(
                "DistGraph.with_weight supports only None (unit weights); per-edge weights are "
                "baked at partition_graph time: rebuild the partition, or use spmm_edge_weighted "
                "for differentiable weights"
            )
        if not self.has_weight:
            return self
        if self.esrc_coord is None:
            raise ValueError(
                "with_weight(None) on a weight-baked DistGraph needs the edge-parallel arrays: "
                "partition_graph(..., edge_parallel=True)"
            )
        return dataclasses.replace(self, unit_weight=True)

    def unweighted(self) -> "DistGraph":
        """``with_weight(None)``: the call the port's GIN makes on any graph."""
        return self.with_weight(None)

    def shard_edge_array(self, w, fill=0) -> torch.Tensor:
        """Map a per-edge array given in partition_graph's INPUT edge order to
        the [L E_max, ...] local dst-sorted edge layout that the
        edge-parallel ops consume (padding slots -> ``fill``)."""
        if self.edge_id is None:
            raise ValueError("built with edge_parallel=False")
        w = (w if isinstance(w, torch.Tensor) else torch.from_numpy(np.array(w))).to(self.device)
        ext = torch.cat([w, torch.full((1,) + tuple(w.shape[1:]), fill, dtype=w.dtype, device=w.device)])
        return ext.index_select(0, self.edge_id.reshape(-1).long())

    def shard_nodes(self, x, fill=0) -> torch.Tensor:
        """Repartition a [N, ...] node array into the padded layout: [P n_max,
        ...], or this process's [L n_max, ...] rows of it in a group."""
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        pad = torch.full(
            (self.num_parts * self.n_max - self.num_nodes,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device
        )
        x = torch.cat([x, pad])
        if self.num_local_parts == self.num_parts:
            return x
        lo = self.first_part * self.n_max
        return x[lo : lo + self.num_local_parts * self.n_max]

    def unshard_nodes(self, x_sh: torch.Tensor) -> torch.Tensor:
        """Inverse of shard_nodes: the rows of real nodes."""
        lo = self.first_part * self.n_max
        return x_sh[: max(0, min(self.num_nodes - lo, self.num_local_parts * self.n_max))]


def _halo_plan(cols_per_part, P, n_max):
    """For the targeted exchange: per-(receiver, owner) sorted lists of the
    remote rows each part needs, a common padded size H, the [P, P, H] send
    tables, per-part column remappers into the local buffer layout [own rows
    (n_max) | recv slot per peer (H each)], and the raw ``need`` tables
    (``gnn_tpu/parallel/partition.py:261-298``)."""
    need = [[None] * P for _ in range(P)]
    h = 8
    for p, cols in enumerate(cols_per_part):
        own = np.minimum(cols // n_max, P - 1)
        for q in range(P):
            if q == p:
                need[p][q] = np.zeros(0, np.int64)
                continue
            need[p][q] = np.unique(cols[own == q])
            h = max(h, len(need[p][q]))
    h = ((h + 7) // 8) * 8
    send = np.zeros((P, P, h), np.int64)  # send[owner, receiver]
    for p in range(P):
        for q in range(P):
            if q != p:
                rows = need[p][q] - q * n_max  # local on owner q
                send[q, p, : len(rows)] = rows

    def remap(p, cols):
        out = np.empty(len(cols), np.int64)
        own = np.minimum(cols // n_max, P - 1)
        for q in range(P):
            m = own == q
            if q == p:
                out[m] = cols[m] - p * n_max
            else:
                out[m] = n_max + q * h + np.searchsorted(need[p][q], cols[m])
        return out

    return send, h, remap, need


def _csr(rows, cols, weight, n_rows: int, n_cols: int) -> Adjacency:
    """An Adjacency (n_rows destination rows x n_cols source columns) over
    entries given in row order, kept in that order within a row."""
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    if max(n_rows, n_cols, len(cols)) > np.iinfo(np.int32).max:
        raise ValueError("a part's CSR must fit int32 indices for the kernels")
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    f32 = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a, np.float32))
    offsets = lambda ids, n: np.concatenate([[0], np.cumsum(np.bincount(ids, minlength=n))])
    t_perm = np.lexsort((rows, cols))
    return Adjacency(
        src=i32(cols), dst=i32(rows), row_ptr=i32(offsets(rows, n_rows)), weight=f32(weight),
        t_perm=i32(t_perm), t_row_ptr=i32(offsets(cols[t_perm], n_cols)), t_col=i32(rows[t_perm]),
        t_weight=None if weight is None else f32(np.asarray(weight)[t_perm]),
        num_src_nodes=int(n_cols), num_dst_nodes=int(n_rows),
    )


def _concat(pieces, n_rows, n_cols) -> Adjacency:
    """One CSR from the parts' (rows, cols, weight) in part order."""
    rows = np.concatenate([r for r, _, _ in pieces]) if pieces else np.zeros(0, np.int64)
    cols = np.concatenate([c for _, c, _ in pieces]) if pieces else np.zeros(0, np.int64)
    weight = None if not pieces or pieces[0][2] is None else np.concatenate([w for _, _, w in pieces])
    return _csr(rows, cols, weight, n_rows, n_cols)


def partition_graph(
    edge_index,
    edge_weight=None,
    *,
    num_nodes: int,
    num_parts: Optional[int] = None,
    mesh=None,
    axis_name: str = "data",
    halo: str = "allgather",
    edge_parallel: bool = True,
    local_blocked: int = 0,
    block_dtype: Optional[torch.dtype] = None,
) -> DistGraph:
    """Partition a COO graph by contiguous node ranges over ``num_parts``
    (or the mesh's ``axis_name`` size), with the JAX package's options:
    ``halo`` 'allgather' (every part reads the gathered features), 'alltoall'
    (each part receives only the rows its edges read) or 'overlap'
    ('alltoall' with the edges split by source owner: the local product
    needs no exchange); ``edge_parallel`` builds the per-edge arrays of the
    dynamic-weight ops; ``local_blocked=R`` (halo='overlap') moves each
    part's local intra-window edges into dense [B, R, R] blocks
    (``block_dtype`` e.g. ``torch.bfloat16``).

    Without a mesh the result holds every part on the CPU (move it with
    ``.to(device)``); with one, this process's parts on its device."""
    if num_parts is None:
        if mesh is None:
            raise ValueError("pass num_parts or a mesh")
        num_parts = mesh.shape[axis_name]
    elif mesh is not None and mesh.shape.get(axis_name) != num_parts:
        raise ValueError(f"num_parts={num_parts} but the mesh's '{axis_name}' axis has {mesh.shape.get(axis_name)}")
    if halo not in ("allgather", "alltoall", "overlap"):
        raise ValueError(f"unknown halo mode '{halo}'")
    ei = as_numpy(edge_index)
    src, dst = ei[0].astype(np.int64), ei[1].astype(np.int64)
    w = None if edge_weight is None else np.asarray(as_numpy(edge_weight), np.float32)
    P = int(num_parts)
    R_blk = int(local_blocked)
    if R_blk:
        if halo != "overlap":
            raise ValueError(
                "local_blocked requires halo='overlap' (the mode with a local/remote edge split)"
            )
        if R_blk % 8:
            raise ValueError("local_blocked must be a multiple of 8")
    n_max = -(-num_nodes // P)
    align = R_blk if R_blk else 8
    n_max = ((n_max + align - 1) // align) * align

    # this process's parts; W, rank: the processes along the data axis and
    # this one's index among them (the exchange's group)
    if mesh is None:
        W, rank, grouped, group, device = 1, 0, False, None, torch.device("cpu")
    else:
        W, rank, grouped, device = mesh.data_count, mesh.data_index, mesh.grouped, mesh.device
        group = mesh.data_group
        if P != W * mesh.num_local_parts:
            raise ValueError(f"{P} parts over {W} processes of {mesh.num_local_parts} parts each")
    L = P // W
    parts = range(rank * L, (rank + 1) * L)

    # Per-part sorted local edge lists (gnn_tpu/parallel/partition.py:368-387).
    gidx = np.arange(len(src), dtype=np.int64)
    fwd_parts, bwd_parts, fwd_ids = [], [], []
    for p in range(P):
        lo, hi = p * n_max, min((p + 1) * n_max, num_nodes)
        m = (dst >= lo) & (dst < hi)  # forward: in-edges of owned dst
        s_p, d_p = src[m], dst[m] - lo
        w_p = None if w is None else w[m]
        order = np.lexsort((s_p, d_p))
        fwd_parts.append((s_p[order], d_p[order], None if w_p is None else w_p[order]))
        fwd_ids.append(gidx[m][order])
        m = (src >= lo) & (src < hi)  # backward: out-edges of owned src
        s_p, d_p = src[m] - lo, dst[m]  # A^T: row = src, col = dst
        w_p = None if w is None else w[m]
        order = np.lexsort((d_p, s_p))
        bwd_parts.append((d_p[order], s_p[order], None if w_p is None else w_p[order]))

    targeted = halo in ("alltoall", "overlap")
    send_f = send_b = need_f = need_b = None
    h_max = 0
    if targeted:
        send_f, h_f, remap_f, need_f = _halo_plan([c for c, _, _ in fwd_parts], P, n_max)
        send_b, h_b, remap_b, need_b = _halo_plan([c for c, _, _ in bwd_parts], P, n_max)
        h_max = max(h_f, h_b)
        send_f = np.pad(send_f, ((0, 0), (0, 0), (0, h_max - h_f)))
        send_b = np.pad(send_b, ((0, 0), (0, 0), (0, h_max - h_b)))

        def scale(remap, h_dir):  # remap's n_max + q h_dir + pos, in the common h_max
            def f(p, cols):
                out = remap(p, cols)
                q, pos = (out - n_max) // h_dir, (out - n_max) % h_dir
                return np.where(out >= n_max, n_max + q * h_max + pos, out)

            return f

        remap_f, remap_b = scale(remap_f, h_f), scale(remap_b, h_b)
    else:
        remap_f = remap_b = lambda p, cols: cols  # padded-global coordinates
    H = h_max
    n_own, n_recv = L * n_max, L * P * H
    # the stacked exchange buffer and its zero row (the padding edges' source)
    n_cols = n_own + n_recv if targeted else P * n_max

    def buffer_rows(l, coords):
        """Part-local buffer coordinates -> rows of the stacked buffer."""
        if not targeted:
            return coords
        return np.where(coords < n_max, l * n_max + coords, n_own + l * P * H + (coords - n_max))

    adj_rem = t_adj_rem = None
    diag_np = None
    if halo == "overlap":
        # Split each part's edges by source owner (:441-498): local-source
        # edges read x, remote-source ones the recv slots (q h_max + pos).
        def remote_remap(need, p, cols):
            out = np.empty(len(cols), np.int64)
            own = np.minimum(cols // n_max, P - 1)
            for q in range(P):
                m = own == q
                if m.any():
                    out[m] = q * h_max + np.searchsorted(need[p][q], cols[m])
            return out

        loc = {True: [], False: []}
        rem = {True: [], False: []}
        if R_blk:
            diag_np = np.zeros((P, n_max // R_blk, R_blk, R_blk), np.float32)
        for p in range(P):
            for src_parts, need, is_fwd in ((fwd_parts, need_f, True), (bwd_parts, need_b, False)):
                cols, rows, w_p = src_parts[p]
                m = np.minimum(cols // n_max, P - 1) == p
                lc, lr = cols[m] - p * n_max, rows[m]
                lw = None if w_p is None else w_p[m]
                if R_blk:
                    dn = lc // R_blk == lr // R_blk
                    if is_fwd and dn.any():
                        np.add.at(
                            diag_np[p].reshape(-1),
                            (lr[dn] // R_blk) * R_blk * R_blk + (lr[dn] % R_blk) * R_blk + (lc[dn] % R_blk),
                            1.0 if lw is None else lw[dn],
                        )
                    lc, lr = lc[~dn], lr[~dn]
                    lw = None if lw is None else lw[~dn]
                if p in parts:
                    l = p - parts.start
                    r = ~m
                    loc[is_fwd].append((l * n_max + lr, l * n_max + lc, lw))
                    rem[is_fwd].append((
                        l * n_max + rows[r], l * P * H + remote_remap(need, p, cols[r]),
                        None if w_p is None else w_p[r],
                    ))
        adj, t_adj = _concat(loc[True], n_own, n_own), _concat(loc[False], n_own, n_own)
        adj_rem, t_adj_rem = _concat(rem[True], n_own, n_recv), _concat(rem[False], n_own, n_recv)
    else:
        pieces = {True: [], False: []}
        for l, p in enumerate(parts):
            for src_parts, remap, is_fwd in ((fwd_parts, remap_f, True), (bwd_parts, remap_b, False)):
                cols, rows, w_p = src_parts[p]
                pieces[is_fwd].append((l * n_max + rows, buffer_rows(l, remap(p, cols)), w_p))
        adj, t_adj = _concat(pieces[True], n_own, n_cols), _concat(pieces[False], n_own, n_cols)

    exchange_idx = t_exchange_idx = send_csr = None
    if targeted:
        # Gather rows in the send order of the collective, [W (receiving
        # process), L (its part q), L (sending part l), H]: row l n_max +
        # send[l, q, j]. In one process that is the recv layout [q, l, H].
        def gather_rows(send):
            idx = np.empty((W, L, L, H), np.int64)
            for w_ in range(W):
                for q in range(L):
                    for l in range(L):
                        idx[w_, q, l] = l * n_max + send[rank * L + l, w_ * L + q]
            return torch.from_numpy(idx.reshape(-1))

        exchange_idx, t_exchange_idx = gather_rows(send_f), gather_rows(send_b)

    esrc_coord = edst_row = edge_id = in_degree = inc = esrc_index = edst_index = dst_row_ptr = None
    e_max = 0
    if edge_parallel:
        # Flat per-edge views of the forward partition (:513-543).
        n_buf = n_max + P * h_max if targeted else P * n_max
        e_max = max(1, max(len(c) for c, _, _ in fwd_parts))
        e_max = ((e_max + 7) // 8) * 8
        esrc_np = np.full((P, e_max), n_buf, np.int32)
        edst_np = np.full((P, e_max), n_max, np.int32)
        eid_np = np.full((P, e_max), len(src), np.int32)
        deg_np = np.zeros((P, n_max), np.float32)
        for p in range(P):
            cols, rows, _ = fwd_parts[p]
            ep = len(cols)
            esrc_np[p, :ep] = remap_f(p, cols)
            edst_np[p, :ep] = rows
            eid_np[p, :ep] = fwd_ids[p]
            np.add.at(deg_np[p], rows, 1.0)
        esrc_np, edst_np, eid_np, deg_np = (a[parts.start : parts.stop] for a in (esrc_np, edst_np, eid_np, deg_np))
        real = edst_np != n_max
        e_buf = np.full((L, e_max), n_cols, np.int64)
        for l in range(L):
            e_buf[l, real[l]] = buffer_rows(l, esrc_np[l, real[l]].astype(np.int64))
        part_of = np.arange(L)[:, None]
        e_dst = np.where(real, part_of * n_max + edst_np, n_own)
        # the incidence CSR: entries (buffer row of the source, edge
        # position), stably sorted by row over the parts in order
        pos = (part_of * e_max + np.arange(e_max)[None, :])[real]
        rows_inc = e_buf[real]
        order = np.argsort(rows_inc, kind="stable")
        inc = _csr(rows_inc[order], pos[order], None, n_cols, L * e_max)
        seg = (part_of * (n_max + 1) + edst_np).reshape(-1)  # a padding row a part
        dst_row_ptr = np.concatenate([[0], np.cumsum(np.bincount(seg, minlength=L * (n_max + 1)))])
        esrc_coord, edst_row, edge_id, in_degree = (
            torch.from_numpy(np.ascontiguousarray(a)) for a in (esrc_np, edst_np, eid_np, deg_np)
        )
        esrc_index, edst_index = torch.from_numpy(e_buf.reshape(-1)), torch.from_numpy(e_dst.reshape(-1))
        dst_row_ptr = torch.from_numpy(dst_row_ptr.astype(np.int32))
        if targeted:
            # Remote partials return to their owners: owner q's row
            # send[q, g, j] takes slot j of receiver g. In one process the
            # partials are read where the incidence CSR left them, [L (g),
            # P (q), H]; in a group where the reverse collective puts them,
            # [W, L (q), L (g's part in its process), H]. Same entry order.
            rows_s, gs, js, cols_s = [], [], [], []
            for q, g_own in enumerate(parts):
                for g in range(P):
                    k = 0 if g == g_own else len(need_f[g][g_own])
                    j = np.arange(k)
                    rows_s.append(q * n_max + send_f[g_own, g, :k])
                    gs.append(np.full(k, g))
                    js.append(j)
                    if grouped:
                        cols_s.append((g // L) * (L * L * H) + q * (L * H) + (g % L) * H + j)
                    else:
                        cols_s.append(g * P * H + g_own * H + j)
            rows_s, gs, js, cols_s = (np.concatenate(a) for a in (rows_s, gs, js, cols_s))
            order = np.lexsort((js, gs, rows_s))
            send_csr = _csr(rows_s[order], cols_s[order], None, n_own, n_recv)

    diag = None
    if diag_np is not None:
        diag = torch.from_numpy(np.ascontiguousarray(diag_np[parts.start : parts.stop]))
        if block_dtype is not None:
            diag = diag.to(block_dtype)
    local = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a[parts.start : parts.stop], np.int32))
    out = DistGraph(
        adj=adj, t_adj=t_adj, send_idx=local(send_f), t_send_idx=local(send_b),
        exchange_idx=exchange_idx, t_exchange_idx=t_exchange_idx, adj_rem=adj_rem, t_adj_rem=t_adj_rem,
        diag=diag, esrc_coord=esrc_coord, edst_row=edst_row, edge_id=edge_id, in_degree=in_degree,
        inc=inc, send=send_csr, esrc_index=esrc_index, edst_index=edst_index, dst_row_ptr=dst_row_ptr,
        num_parts=P, n_max=int(n_max), num_nodes=int(num_nodes), mesh=mesh, axis_name=axis_name,
        halo=halo, block_rows=R_blk, h_max=int(h_max), e_max=int(e_max), has_weight=edge_weight is not None,
        num_local_parts=L, first_part=parts.start, grouped=grouped, group=group,
    )
    return out if device.type == "cpu" else out.to(device)
