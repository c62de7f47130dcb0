"""Sampled-minibatch loading with host-resident features.

Port of ``gnn_tpu/train/host_loader.py::HostBatchLoader``: the regime where
the feature matrix does not fit in device memory (ogbn-papers100M: 111 M x
128 float32 = 57 GB), so the on-device
:class:`~gnn_tpu_torch.graphs.sampling.NeighborSampler`, which gathers
``x[nodes]`` from a device-resident x, cannot be used. This loader runs the
layered fanout sampling and the feature gather on the host (the graph core's
``sample_neighbors``; ``x`` may be an ``np.memmap``) and hands over only the
[batch_nodes, F] slab of a step.

The sampling semantics are the device sampler's: uniform with-replacement
draws at fixed fanout, a seed without in-neighbours samples itself. So every
shape is static and the constant hop adjacencies of
:func:`~gnn_tpu_torch.graphs.sampling.hop_adjacencies` serve every batch.
The same seed gives the JAX package's batches exactly (same C++ source, same
seed schedule: one more than the last for every hop).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from gnn_tpu_torch import native
from gnn_tpu_torch.graphs.adjacency import Adjacency
from gnn_tpu_torch.graphs.sampling import hop_adjacencies

__all__ = ["HostBatchLoader"]


class HostBatchLoader:
    """Host-side layered neighbour sampler and feature gather.

    >>> loader = HostBatchLoader(ei, x_mm, y, fanouts=[10, 5], num_nodes=N)
    >>> feats, ys = loader.batch(seed_nodes)       # numpy, on the host
    >>> adjs = [a.to(device) for a in loader.adjacencies(B)]
    >>> logits = model.forward_sampled(torch.from_numpy(feats).to(device), adjs)

    ``x`` and ``y`` may be ``np.memmap`` (never loaded whole);
    ``edge_index`` becomes a CSR once, at construction (the graph core's
    counting sort, O(E + N)).
    """

    def __init__(self, edge_index, x, y, fanouts: Sequence[int], *, num_nodes: int, seed: int = 0):
        ei = np.asarray(edge_index)
        src = np.ascontiguousarray(ei[0], np.int64)
        dst = np.ascontiguousarray(ei[1], np.int64)
        # CSR over incoming edges (row = dst): the direction of full-graph
        # message passing and of the device sampler
        perm, row_ptr = native.sort_edges_csr(src, dst, num_nodes)
        self.row_ptr = row_ptr
        self.col = np.ascontiguousarray(src[perm])
        self.x = x
        self.y = y
        self.fanouts = list(fanouts)
        self.num_nodes = int(num_nodes)
        self._seed = int(seed)
        self._adj_cache = {}

    def adjacencies(self, batch_size: int) -> List[Adjacency]:
        """The constant per-hop bipartite adjacencies (outermost first, on
        the CPU): ``NeighborSampler.adjacencies``' structure."""
        if batch_size not in self._adj_cache:
            self._adj_cache[batch_size] = hop_adjacencies(batch_size, self.fanouts)
        return self._adj_cache[batch_size]

    def batch(self, seeds) -> Tuple[np.ndarray, np.ndarray]:
        """Sample one minibatch: (features [batch_nodes, F], labels [batch]),
        numpy. Node list per hop: [frontier | neighbours row-major], the
        source positions of the hop adjacencies."""
        frontier = np.ascontiguousarray(seeds, np.int64)
        seeds = frontier
        for f in self.fanouts:
            self._seed += 1
            nbr = native.sample_neighbors_host(
                self.row_ptr, self.col, frontier, f, seed=self._seed, replace=True
            )
            # a seed without neighbours: the graph core marks slots 1.. with
            # -1; the device sampler's rule is "sample yourself"
            nbr = np.where(nbr < 0, frontier[:, None], nbr)
            frontier = np.concatenate([frontier, nbr.reshape(-1)])
        feats = np.asarray(self.x[frontier])  # a fancy index, memmap-friendly
        ys = np.asarray(self.y[seeds])
        return feats, ys
