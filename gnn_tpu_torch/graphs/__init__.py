"""Graph data, host-side prep, the CSR adjacency the kernels read, the
community-packed node order, converters and the minibatch neighbour sampler."""

from gnn_tpu_torch.graphs.adjacency import Adjacency, build_adjacency
from gnn_tpu_torch.graphs.blocked import cluster_order
from gnn_tpu_torch.graphs.convert import (
    csr_to_edge_list,
    dense_to_edge_list,
    edge_list,
    edge_list_to_csr,
    to_dense_adj,
)
from gnn_tpu_torch.graphs.data import TEST, TRAIN, VAL, Batch, Data
from gnn_tpu_torch.graphs.datasets import load_dataset
from gnn_tpu_torch.graphs.generate import (
    clustered_power_law,
    cora_like,
    karate_club,
    power_law,
    random_regular,
    stochastic_block_model,
)
from gnn_tpu_torch.graphs.sampling import NeighborSampler, sample_neighbors
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
    "cluster_order",
    "edge_list",
    "to_dense_adj",
    "dense_to_edge_list",
    "edge_list_to_csr",
    "csr_to_edge_list",
    "Data",
    "Batch",
    "TRAIN",
    "VAL",
    "TEST",
    "NeighborSampler",
    "sample_neighbors",
    "load_dataset",
    "clustered_power_law",
    "cora_like",
    "karate_club",
    "power_law",
    "random_regular",
    "stochastic_block_model",
    "add_self_loops",
    "add_remaining_self_loops",
    "coalesce",
    "degree",
    "gcn_norm",
    "remove_self_loops",
    "to_undirected",
]
