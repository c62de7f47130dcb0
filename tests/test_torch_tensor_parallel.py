"""Tensor parallelism: the ``model`` axis of a mesh
(``gnn_tpu_torch/parallel/tensor_parallel.py``) against the JAX package's
``tests/test_parallel.py::test_tensor_parallel_gcn_matches_single_chip``,
whose computation runs here on the 8-device CPU mesh (~7 s, once a module):
a GCN 16 -> 8 -> 3 on the SBM of 96 nodes, the graph in 4 parts, each
Linear weight whose out-features divide the model axis of 2 sharded over it
(the 3-class head stays replicated), the masked cross entropy's value and
gradients. The port's loss must lie within 1e-5 of the JAX one and every
gradient within rtol 2e-4 / atol 1e-5, the JAX test's tolerances; the
sharded weights hold out / 2 rows each.

In one process the (4, 2) mesh holds every position and the shards are
column blocks on the CPU (each halo mode). Two processes of a gloo group
(``tests/torch_tensor_parallel_worker.py``, a ``file://`` store in
``tmp_path``, 120 s at most, one spawn) run a (1, 2) mesh, whose model axis
spans the two processes, and a (2, 2) mesh, whose data axis does.
"""

import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as PSpec

import torch_tensor_parallel_worker as worker
from gnn_tpu import graphs as jgraphs
from gnn_tpu import nn as jnn
from gnn_tpu.graphs.generate import stochastic_block_model as jax_sbm
from gnn_tpu.models import GCN as JaxGCN
from gnn_tpu.parallel import make_mesh as jax_make_mesh
from gnn_tpu.parallel import partition_graph as jax_partition_graph
from gnn_tpu.parallel import shard_node_array as jax_shard_node_array
from gnn_tpu_torch.parallel import ShardedLinear, make_mesh

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_tp():
    """(graph, weights, loss, gradients by name) of the JAX tensor-parallel
    step, as the JAX test computes it."""
    data = jax_sbm(num_nodes=96, num_classes=3, seed=21)
    n = data.num_nodes
    ei, w = jgraphs.gcn_norm(np.asarray(data.edge_index), num_nodes=n)
    mesh2 = jax_make_mesh((4, 2), ("data", "model"), devices=jax.devices()[:8])
    dist = jax_partition_graph(ei, w, num_nodes=n, mesh=mesh2, halo="alltoall")
    model = JaxGCN(16, 8, 3, key=jax.random.PRNGKey(0), dropout=0.0)
    params, static = jnn.partition(model)
    weights = {k: np.asarray(v) for k, v in jnn.state_dict(model).items()}

    def shard_params(path, leaf):
        if leaf is None or leaf.ndim < 2 or leaf.shape[0] % 2:
            return NamedSharding(mesh2, PSpec())
        return NamedSharding(mesh2, PSpec("model", None))

    shardings = jax.tree_util.tree_map_with_path(shard_params, params)
    params_tp = jax.tree_util.tree_map(
        lambda p, s: None if p is None else jax.device_put(p, s), params, shardings, is_leaf=lambda v: v is None
    )
    y = jax.numpy.asarray(np.asarray(data.y))
    x_sh = jax_shard_node_array(dist, data.x, mesh2)
    y_sh = dist.shard_nodes(y)
    m_sh = dist.shard_nodes(jax.numpy.ones((n,), bool), fill=False)

    @jax.jit
    def tp_loss_grad(p):
        return jax.value_and_grad(lambda p: jnn.cross_entropy(jnn.combine(p, static)(x_sh, dist), y_sh, m_sh))(p)

    val, grads = tp_loss_grad(params_tp)
    graph = dict(ei=np.asarray(ei), w=np.asarray(w), x=np.asarray(data.x), y=np.asarray(data.y).astype(np.int64))
    return graph, weights, float(val), {k: np.asarray(v) for k, v in jnn.state_dict(grads).items()}


def test_make_mesh_places_the_model_axis():
    mesh = make_mesh((4, 2), ("data", "model"), devices=[CPU] * 8)
    assert mesh.num_local_parts == 4 and mesh.model_size == 2 and list(mesh.local_shards) == [0, 1]
    assert mesh.first_part == 0 and mesh.model_group is None and not mesh.grouped


@pytest.mark.parametrize("halo", ["alltoall", "allgather", "overlap"])
def test_tensor_parallel_gcn_in_one_process_matches_jax(jax_tp, halo):
    from gnn_tpu_torch.models import GCN
    from gnn_tpu_torch.nn import cross_entropy, load_jax_state_dict
    from gnn_tpu_torch.parallel import partition_graph, shard_model, shard_node_array

    graph, weights, want_loss, want_grads = jax_tp
    n = graph["x"].shape[0]
    mesh = make_mesh((4, 2), ("data", "model"), devices=[CPU] * 8)
    dist = partition_graph(graph["ei"], graph["w"], num_nodes=n, mesh=mesh, halo=halo)
    assert dist.num_parts == 4 and dist.num_local_parts == 4
    model = shard_model(load_jax_state_dict(GCN(16, 8, 3, dropout=0.0), weights), mesh)
    lin0, lin1 = model.convs[0].lin, model.convs[1].lin
    assert isinstance(lin0, ShardedLinear) and not isinstance(lin1, ShardedLinear)  # 3 classes stay replicated
    assert [tuple(s.shape) for s in lin0.shards] == [(4, 16), (4, 16)]
    torch.testing.assert_close(torch.cat([s.detach() for s in lin0.shards]),
                               torch.from_numpy(np.array(weights["convs.0.lin.weight"])))
    valid = dist.shard_nodes(torch.ones(n, dtype=torch.bool), fill=False)
    y = dist.shard_nodes(torch.from_numpy(graph["y"]))
    loss = cross_entropy(model(shard_node_array(dist, graph["x"], mesh), dist), y, valid)
    loss.backward()
    assert abs(loss.item() - want_loss) < 1e-5
    grads = {name: p.grad for name, p in model.named_parameters() if ".shards." not in name}
    grads["convs.0.lin.weight"] = torch.cat([s.grad for s in lin0.shards])
    assert sorted(grads) == sorted(want_grads)
    for name, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), want_grads[name], rtol=2e-4, atol=1e-5, err_msg=name)


def test_tensor_parallel_gcn_across_two_processes_matches_jax(jax_tp, tmp_path):
    graph, weights, want_loss, want_grads = jax_tp
    args = (f"file://{tmp_path / 'store'}", graph, weights, want_loss, want_grads)
    ctx = mp.spawn(worker.run, args=args, nprocs=2, join=False)
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("the two-process run took more than 120 s")
