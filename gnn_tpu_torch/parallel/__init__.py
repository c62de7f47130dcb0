"""Graph-partition parallelism: meshes, the node partition, the halo
exchange and multi-process setup.

Port of ``gnn_tpu/parallel``. One process holds P parts on its device (the
exchange is index work there), or, in a ``torch.distributed`` group, its
share of them (the exchange rides the group's collectives). The JAX
package's GSPMD annotations (``replicated``, ``shard``, ``P``,
``NamedSharding``) have no counterpart.
"""

from gnn_tpu_torch.parallel import multihost
from gnn_tpu_torch.parallel.halo import (
    edge_reduce_by_dst,
    edge_valid_mask,
    gather_dst_dist,
    gather_src_dist,
    shard_node_array,
    spmm_dist,
    spmm_dist_dynw,
)
from gnn_tpu_torch.parallel.mesh import Mesh, make_mesh
from gnn_tpu_torch.parallel.partition import DistGraph, partition_graph

__all__ = [
    "make_mesh",
    "Mesh",
    "DistGraph",
    "partition_graph",
    "spmm_dist",
    "spmm_dist_dynw",
    "gather_src_dist",
    "gather_dst_dist",
    "edge_reduce_by_dst",
    "edge_valid_mask",
    "shard_node_array",
    "multihost",
]
