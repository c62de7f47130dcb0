"""Worker of tests/test_torch_tensor_parallel.py: one of two processes of a
gloo group on the CPU. On a (1, 2) mesh of one position a process the model
axis spans the two processes (each holds one shard of every sharded Linear,
the forward gathers the column blocks over the model group and the backward
sums dx over it); on a (2, 2) mesh of two positions a process each holds one
part with both shards and the data axis spans the processes (the halo
exchange rides the data group). The loss and every gradient, summed over the
data group, are held to the JAX values handed in. Imports no JAX (checked at
the end)."""

import sys

import numpy as np
import torch
import torch.distributed as tdist

from gnn_tpu_torch.models import GCN
from gnn_tpu_torch.nn import cross_entropy, load_jax_state_dict
from gnn_tpu_torch.parallel import ShardedLinear, make_mesh, multihost, partition_graph, shard_model, shard_node_array


def loss_and_grads(graph: dict, weights: dict, mesh):
    """The tensor-parallel GCN's loss and this process's gradients, both
    summed over the data group, as in fit."""
    ei, w, x, y = (graph[k] for k in ("ei", "w", "x", "y"))
    n = x.shape[0]
    dist = partition_graph(ei, w, num_nodes=n, mesh=mesh, halo="alltoall")
    model = shard_model(load_jax_state_dict(GCN(16, 8, 3, dropout=0.0), weights), mesh)
    group = mesh.data_group
    valid = dist.shard_nodes(torch.ones(n, dtype=torch.bool), fill=False)
    loss = cross_entropy(model(shard_node_array(dist, x, mesh), dist), dist.shard_nodes(torch.from_numpy(y)), valid,
                         group=group)
    loss.backward()
    multihost.all_reduce_gradients(model.parameters(), group)
    loss = loss.detach().clone()
    tdist.all_reduce(loss, group=group)
    return model, float(loss)


def check(model, loss: float, want_loss: float, want_grads: dict, label: str) -> None:
    if abs(loss - want_loss) >= 1e-5:
        raise AssertionError(f"{label}: loss {loss}, JAX {want_loss}")
    for name, module in model.named_modules():
        if isinstance(module, ShardedLinear):
            rows = module.out_features // 2  # the model axis has 2 shards
            want = want_grads[f"{name}.weight"]
            for m, shard in zip(module.shard_index, module.shards):
                if shard.shape[0] != rows:
                    raise AssertionError(f"{label}: {name} shard {m} holds {shard.shape[0]} rows, not {rows}")
                np.testing.assert_allclose(shard.grad.numpy(), want[m * rows : (m + 1) * rows], rtol=2e-4, atol=1e-5,
                                           err_msg=f"{label} {name} shard {m}")
    for name, p in model.named_parameters():
        if ".shards." not in name:
            np.testing.assert_allclose(p.grad.numpy(), want_grads[name], rtol=2e-4, atol=1e-5, err_msg=f"{label} {name}")


def run(rank: int, store: str, graph: dict, weights: dict, want_loss: float, want_grads: dict) -> None:
    torch.set_num_threads(1)  # a graph of 96 nodes: threads would only contend for the cores
    multihost.initialize(store, 2, rank, device="cpu")
    cpu = torch.device("cpu")
    across = make_mesh((1, 2), ("data", "model"), devices=[cpu])
    if across.model_group is None or across.data_count != 1 or list(across.local_shards) != [rank]:
        raise AssertionError("(1, 2) over two processes: the model axis should span them")
    check(*loss_and_grads(graph, weights, across), want_loss, want_grads, "model axis across processes")
    within = make_mesh((2, 2), ("data", "model"), devices=[cpu] * 2)
    if within.model_group is not None or within.data_count != 2 or within.first_part != rank:
        raise AssertionError("(2, 2) over two processes of two positions: the data axis should span them")
    check(*loss_and_grads(graph, weights, within), want_loss, want_grads, "data axis across processes")
    assert not any(name == "jax" or name.startswith("jax.") for name in sys.modules)
    tdist.destroy_process_group()
