"""Worker of tests/test_torch_multihost.py: one of two processes of a gloo
group on the CPU, each holding 2 of 4 parts of one partition. Imports no JAX
(checked at the end), so that it runs where only torch is installed."""

import sys

import numpy as np
import torch

from gnn_tpu_torch.parallel import gather_src_dist, make_mesh, multihost, partition_graph, shard_node_array, spmm_dist


def graph(n=90, e=500, F=6):
    rng = np.random.default_rng(0)
    ei = np.unique(np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]), axis=1)
    w = rng.uniform(0.1, 1.0, ei.shape[1]).astype(np.float32)
    return ei, w, rng.normal(size=(n, F)).astype(np.float32), n


def run(rank: int, store: str) -> None:
    multihost.initialize(store, 2, rank, device="cpu")
    assert multihost.is_multihost() and multihost.process_count() == 2
    mesh = make_mesh(axes=("data",), devices=[torch.device("cpu")] * 2)
    assert mesh.shape == {"data": 4} and mesh.grouped and mesh.process_index == rank
    ei, w, x, n = graph()
    A = np.zeros((n, n), np.float32)
    np.add.at(A, (ei[1], ei[0]), w)
    for halo in ("alltoall", "allgather", "overlap"):
        dist = partition_graph(ei, w, num_nodes=n, mesh=mesh, halo=halo)
        assert dist.num_local_parts == 2 and dist.first_part == 2 * rank
        lo = dist.first_part * dist.n_max
        x_sh = shard_node_array(dist, x, mesh).requires_grad_()
        assert x_sh.shape[0] == 2 * dist.n_max
        rows = dist.unshard_nodes(torch.arange(x_sh.shape[0])).numpy() + lo
        out = spmm_dist(dist, x_sh, mesh)
        np.testing.assert_allclose(dist.unshard_nodes(out).detach().numpy(), (A @ x)[rows], rtol=1e-5, atol=1e-6)
        torch.sin(out).sum().backward()  # every process's loss: the sum over the partition
        want = A.T @ np.cos(A @ x)
        np.testing.assert_allclose(dist.unshard_nodes(x_sh.grad).numpy(), want[rows], rtol=1e-5, atol=1e-6)
        x_sh.grad = None
        torch.sin(gather_src_dist(dist, x_sh)).sum().backward()
        want = np.zeros_like(x)
        np.add.at(want, ei[0], np.cos(x[ei[0]]))
        np.testing.assert_allclose(dist.unshard_nodes(x_sh.grad).numpy(), want[rows], rtol=1e-5, atol=1e-6)
    assert not any(name == "jax" or name.startswith("jax.") for name in sys.modules)
    torch.distributed.destroy_process_group()
