"""Graph-level readout (global pooling) over batched graphs.

Port of ``gnn_tpu/ops/pool.py``: a :class:`gnn_tpu_torch.graphs.Batch` gives
each node a ``graph_id``; pooling is a segment reduction over it.
"""

from __future__ import annotations

import torch

from gnn_tpu_torch.ops.segment import segment_max, segment_mean, segment_sum

__all__ = ["global_add_pool", "global_mean_pool", "global_max_pool"]


def global_add_pool(x: torch.Tensor, graph_id: torch.Tensor, num_graphs: int) -> torch.Tensor:
    """[N, F] node features -> [num_graphs, F] per-graph sums."""
    return segment_sum(x, graph_id, num_graphs, indices_are_sorted=True)


def global_mean_pool(x: torch.Tensor, graph_id: torch.Tensor, num_graphs: int) -> torch.Tensor:
    """[N, F] node features -> [num_graphs, F] per-graph means."""
    return segment_mean(x, graph_id, num_graphs, indices_are_sorted=True)


def global_max_pool(x: torch.Tensor, graph_id: torch.Tensor, num_graphs: int) -> torch.Tensor:
    """[N, F] node features -> [num_graphs, F] per-graph maxima; a graph
    without nodes gives 0. Emptiness is read from the node counts, not from
    ``isfinite``, so infinite maxima survive and NaNs propagate."""
    out = segment_max(x, graph_id, num_graphs, indices_are_sorted=True)
    counts = segment_sum(torch.ones_like(graph_id), graph_id, num_graphs, indices_are_sorted=True)
    return torch.where(counts[:, None] > 0, out, torch.zeros((), dtype=out.dtype, device=out.device))
