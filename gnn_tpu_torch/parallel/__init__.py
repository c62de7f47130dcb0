"""Graph-partition and tensor parallelism: meshes, the node partition, the
halo exchange, the model axis and multi-process setup.

Port of ``gnn_tpu/parallel``. One process holds P parts on its device (the
exchange is index work there), or, in a ``torch.distributed`` group, its
share of them (the exchange rides the group's collectives). A mesh's second
axis (``model``) shards the Linear layers (:func:`shard_model`, the
counterpart of the JAX placement ``NamedSharding(mesh, P("model", None))``);
the other GSPMD annotations of the JAX package (``replicated``, ``shard``,
``P``) have no counterpart.
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
from gnn_tpu_torch.parallel.tensor_parallel import ShardedLinear, shard_model

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
    "ShardedLinear",
    "shard_model",
    "multihost",
]
