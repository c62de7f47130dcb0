"""Minibatch neighbour sampling, static-shape, on the model's device.

Port of ``gnn_tpu/graphs/sampling.py``: GraphSAGE sampling *with
replacement* at fixed fanout, which makes every shape static:

* hop l has exactly ``batch * prod(1 + fanouts[:l])`` destination nodes;
* every destination draws exactly ``fanout`` in-neighbours (its own id when
  it has none), so the bipartite structure of a hop (``row_ptr``, source
  positions, destinations, the transpose arrays) is a constant shared by all
  batches of one size. Only the flat node-id vector changes per batch.

:meth:`NeighborSampler.sample` is index arithmetic on tensors that live
where the sampler does (``.to(device)``): on the card it makes no host round
trip, so it queues behind the previous step like any other kernel. An
explicit ``torch.Generator`` on the sampler's device takes the place of the
JAX key. The hop adjacencies are built once per batch size on the host and
moved to the device once; the hops then aggregate through the same kernels
as the full graph (K1 for GraphSAGE and GIN, K3 + K2 + K1 for GAT), over
CSRs with fewer destinations than sources.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gnn_tpu_torch.graphs.adjacency import Adjacency, build_adjacency
from gnn_tpu_torch.graphs.convert import as_numpy
from gnn_tpu_torch.utils.tracing import emit

__all__ = ["NeighborSampler", "sample_neighbors"]


def sample_neighbors(
    row_ptr: torch.Tensor,
    col: torch.Tensor,
    seeds: torch.Tensor,
    fanout: int,
    *,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Uniform with-replacement draw of ``fanout`` in-neighbours per seed from
    the CSR ``(row_ptr, col)``; a seed without in-neighbours samples itself.
    Returns int64 node ids [S, fanout].

    The draw is ``col[start + floor(u * max(deg, 1))]`` in float32, the JAX
    package's arithmetic, with ``u`` [S, fanout] uniform in [0, 1): from
    ``generator`` (on ``row_ptr``'s device), or given, so that a test can feed
    both packages the same uniforms.
    """
    seeds = seeds.long()
    start = row_ptr.index_select(0, seeds)
    deg = row_ptr.index_select(0, seeds + 1) - start
    if u is None:
        u = torch.rand((seeds.shape[0], fanout), generator=generator, device=row_ptr.device)
    elif u.shape != (seeds.shape[0], fanout):
        raise ValueError(f"u must be [{seeds.shape[0]}, {fanout}], got {tuple(u.shape)}")
    span = deg.clamp_min(1)[:, None]
    offs = torch.floor(u.float() * span.float()).to(start.dtype)
    # u < 1 keeps the offset inside the row in float32 already; the clamp
    # guards a caller's u == 1 against reading the next row
    offs = torch.minimum(offs, span - 1)
    nbr = col.index_select(0, (start[:, None] + offs).reshape(-1).long()).view(-1, fanout)
    return torch.where(deg[:, None] > 0, nbr.long(), seeds[:, None])


def _hop_adjacency(n_dst: int, fanout: int) -> Adjacency:
    """The constant bipartite adjacency of one sampled hop (on the CPU).

    Node list convention: [destination nodes (prefix) | sampled neighbours,
    row-major by destination]. Edge e runs from source position
    ``n_dst + e`` to destination ``e // fanout``. Unweighted: the layer's own
    aggregator (SAGE's mean, GAT's softmax) normalizes."""
    E = n_dst * fanout
    dst = np.repeat(np.arange(n_dst), fanout)
    src = n_dst + np.arange(E)
    return build_adjacency(
        np.stack([src, dst]), None, num_src_nodes=n_dst + E, num_dst_nodes=n_dst, layout="csr"
    )


def hop_adjacencies(batch_size: int, fanouts: Sequence[int]) -> List[Adjacency]:
    """The hop adjacencies of a batch, outermost first: the first aggregates
    the deepest sampled frontier, the last aggregates into the seeds."""
    adjs = []
    n_dst = batch_size
    for f in fanouts:
        adjs.append(_hop_adjacency(n_dst, f))
        n_dst = n_dst * (1 + f)
    return adjs[::-1]


class NeighborSampler:
    """Layered sampler producing (node ids, hop adjacencies) per batch.

    >>> sampler = NeighborSampler(data, fanouts=[10, 5]).to(device)
    >>> nodes, adjs = sampler.sample(generator, seed_nodes)
    >>> out = sage.forward_sampled(x[nodes], adjs)      # [batch, C]

    ``row_ptr`` / ``col`` (int32) are the CSR over *incoming* edges, sorted
    by destination then source, so the sampled neighbourhoods follow the
    direction of full-graph message passing. ``adjs`` is outermost first and
    constant per batch size; ``sample`` computes node ids only.
    """

    def __init__(self, data_or_edge_index, fanouts: Sequence[int], *, num_nodes: Optional[int] = None):
        from gnn_tpu_torch.graphs.data import Data

        if isinstance(data_or_edge_index, Data):
            ei, num_nodes = data_or_edge_index.edge_index, data_or_edge_index.num_nodes
        else:
            ei = data_or_edge_index
        ei = as_numpy(ei)
        if num_nodes is None:
            num_nodes = int(ei.max()) + 1 if ei.size else 0
        self.fanouts = list(fanouts)
        self.num_nodes = int(num_nodes)
        src, dst = ei[0].astype(np.int64), ei[1].astype(np.int64)
        if src.size and (min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= num_nodes):
            raise ValueError(f"edge ids must lie in [0, {num_nodes})")
        if max(num_nodes, src.size) > np.iinfo(np.int32).max:
            raise ValueError("node and edge counts must fit int32")
        order = np.lexsort((src, dst))
        row_ptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=num_nodes))])
        self.row_ptr = torch.from_numpy(row_ptr.astype(np.int32))
        self.col = torch.from_numpy(src[order].astype(np.int32))
        self._adj_cache = {}

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    def to(self, device) -> "NeighborSampler":
        """A copy with the CSR on ``device``; hop adjacencies are made (and
        cached) there on first use."""
        out = copy.copy(self)
        out.row_ptr, out.col = self.row_ptr.to(device), self.col.to(device)
        out._adj_cache = {}
        return out

    def adjacencies(self, batch_size: int) -> List[Adjacency]:
        """The constant per-hop bipartite adjacencies, outermost first, on
        the sampler's device."""
        if batch_size not in self._adj_cache:
            self._adj_cache[batch_size] = [
                adj.to(self.device) for adj in hop_adjacencies(batch_size, self.fanouts)
            ]
        return self._adj_cache[batch_size]

    def sample(
        self, generator: Optional[torch.Generator], seeds: torch.Tensor
    ) -> Tuple[torch.Tensor, List[Adjacency]]:
        """Per-batch node ids (int64, [seeds | hop-1 neighbours | ...]) and
        the constant adjacencies. ``generator`` lives on the sampler's
        device; the hops draw from it in turn. The node ids are emitted
        (``utils.tracing.emit("sample", ...)``)."""
        frontier = torch.as_tensor(seeds).to(self.device).long()
        batch_size = int(frontier.shape[0])
        for f in self.fanouts:
            nbrs = sample_neighbors(self.row_ptr, self.col, frontier, f, generator=generator)
            # [frontier | neighbours row-major]: _hop_adjacency's source positions
            frontier = torch.cat([frontier, nbrs.reshape(-1)])
        emit("sample", nodes=frontier)
        return frontier, self.adjacencies(batch_size)
