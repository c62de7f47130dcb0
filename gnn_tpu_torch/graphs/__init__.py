"""Graph data, host-side prep, the CSR adjacency the kernels read and the
cluster-blocked layout."""

from gnn_tpu_torch.graphs.adjacency import Adjacency, build_adjacency
from gnn_tpu_torch.graphs.blocked import BlockedLayout, cluster_order
from gnn_tpu_torch.graphs.data import Batch, Data
from gnn_tpu_torch.graphs.datasets import load_dataset
from gnn_tpu_torch.graphs.generate import (
    clustered_power_law,
    cora_like,
    karate_club,
    power_law,
    stochastic_block_model,
)
from gnn_tpu_torch.graphs.transforms import (
    add_remaining_self_loops,
    add_self_loops,
    coalesce,
    degree,
    gcn_norm,
    remove_self_loops,
    to_undirected,
)

__all__ = [
    "Adjacency",
    "build_adjacency",
    "BlockedLayout",
    "cluster_order",
    "Data",
    "Batch",
    "load_dataset",
    "clustered_power_law",
    "cora_like",
    "karate_club",
    "power_law",
    "stochastic_block_model",
    "add_self_loops",
    "add_remaining_self_loops",
    "coalesce",
    "degree",
    "gcn_norm",
    "remove_self_loops",
    "to_undirected",
]
