"""Entry check of the port: the flagship forward on the card.

Port of ``__graft_entry__.py``'s ``entry`` (and ``_flagship``, :17-48):

    fn, args = entry()      # on the card; entry(device="cpu") for the CPU
    logits = fn(*args)

builds the flagship GCN (64 -> 128 -> 8, dropout 0) on a seeded 512-node
power-law graph of 4,096 edges, prepared with ``reorder='auto'`` (the node
order ``fit`` uses by default: the features move into the relabelled node
space where there is one; these directed edges are not degree-symmetric, so
the ids stay, as in the JAX package), and returns the forward and its
arguments. Its first call on the card builds the kernels (K1) from the
repository's sources.
:func:`dryrun_multichip` is the JAX package's multi-device dry run, whole,
over the mesh positions of one process on the caller's device: the
partitioned ``fit`` runs, the distributed GAT and GIN, the streamed
aggregation with the graph and the features on the host
(``DistEdgeStream``) and a tensor-parallel GCN step on a (data, model)
mesh.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gnn_tpu_torch.graphs import Data, gcn_norm
from gnn_tpu_torch.graphs.generate import power_law, stochastic_block_model
from gnn_tpu_torch.models import GAT, GCN, GIN
from gnn_tpu_torch.nn.losses import cross_entropy
from gnn_tpu_torch.optim import Adam

__all__ = ["entry", "dryrun_multichip"]


def _flagship(in_dim=64, hidden=128, classes=8, n=512, e=4096, seed=0, generator=None):
    """(model, data, adj) of the flagship, on the CPU; ``data`` in the
    adjacency's relabelled node order."""
    ei = power_law(n, e, seed=seed)
    data = Data(
        x=np.random.default_rng(seed).normal(size=(n, in_dim)).astype(np.float32),
        edge_index=ei,
        y=np.random.default_rng(seed + 1).integers(0, classes, n).astype(np.int32),
        num_nodes=n,
    )
    adj = data.to_adjacency(norm="sym", reorder="auto")
    if adj.perm is not None:
        data = data.permute_nodes(adj.perm)
    model = GCN(in_dim, hidden, classes, dropout=0.0, generator=generator)
    return model, data, adj


def entry(device="cuda"):
    """(fn, example_args): the flagship GCN's forward and its arguments
    (model, x, adjacency) on ``device``, the model in inference mode."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry(device='cuda') needs a CUDA device; none is available")
    model, data, adj = _flagship(generator=torch.Generator().manual_seed(0))

    def fn(model, x, adj):
        return model(x, adj)

    return fn, (model.to(device).eval(), data.x.to(device), adj.to(device))


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The JAX package's multi-device dry run (``__graft_entry__.py:51-231``)
    over ``n_devices`` mesh positions of one process on ``device``: ``fit``
    of the GCN with halo 'alltoall', again with ``dist.local_blocked=8`` (the
    community order, halo 'overlap'), the flagship ``encoder_gcn``
    (mask-aware BatchNorm), a distributed GAT's loss and gradient and a
    distributed GIN's loss; the streamed aggregation of the same graph with
    its edges and features on the host (``DistEdgeStream``, chunks of 64
    edges, one K1 launch a chunk); then tensor parallelism: a GCN 16 -> 32
    -> 4 on a (n/2, 2) (data, model) mesh (n, 1 for an odd n), its Linear
    weights sharded over ``model``, one Adam step. Every loss must be
    finite."""
    from gnn_tpu_torch.graphs.streaming import DistEdgeStream
    from gnn_tpu_torch.parallel import make_mesh, partition_graph, shard_model, shard_node_array
    from gnn_tpu_torch.train import Config, fit

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip(device='cuda') needs a CUDA device; none is available")
    data = stochastic_block_model(num_nodes=16 * n_devices, num_classes=4, seed=0)
    cfg = Config()
    cfg.model.name, cfg.model.hidden, cfg.model.dropout = "gcn", 32, 0.0
    cfg.train.epochs, cfg.train.eval_every = 2, 1
    cfg.dist.num_parts, cfg.dist.halo = n_devices, "alltoall"
    for overrides in ({}, {"dist.local_blocked": 8}, {"model.name": "encoder_gcn"}):
        _, _, history = fit(cfg.apply_overrides([f"{k}={v}" for k, v in overrides.items()]), data,
                            device=device, verbose=False)
        if not history or not math.isfinite(history[-1]["loss"]):
            raise AssertionError(f"dryrun_multichip: fit {overrides or 'gcn'} gave {history}")

    mesh = make_mesh((n_devices,), ("data",), devices=[device] * n_devices)
    dist = data.to_dist_graph(mesh=mesh, norm=None, halo="alltoall")
    x = shard_node_array(dist, data.x, mesh)
    y = dist.shard_nodes(data.y.to(device))
    train = dist.shard_nodes(data.train_mask.to(device), fill=False)
    gen = torch.Generator().manual_seed(1)
    for name, model in (("GAT", GAT(16, 16, 4, heads=2, dropout=0.0, generator=gen)),
                        ("GIN", GIN(16, 16, 4, generator=gen))):
        model = model.to(device)
        loss = cross_entropy(model(x, dist), y, train)
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.requires_grad]
        if not math.isfinite(loss.item()) or not all(torch.isfinite(g).all() for g in grads):
            raise AssertionError(f"dryrun_multichip: non-finite {name} loss {loss.item()} or gradient")

    # the streamed aggregation with the graph and the features on the host:
    # each part streams its destinations' in-edges, no collective
    x_host = data.x.numpy()
    stream = DistEdgeStream(data.edge_index.numpy(), num_nodes=data.num_nodes, num_parts=n_devices, chunk_edges=64)
    out = stream.spmm_host(x_host, mesh)
    if tuple(out.shape) != x_host.shape or not torch.isfinite(out).all():
        raise AssertionError(f"dryrun_multichip: DistEdgeStream gave {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")

    # tensor parallelism over a 2-D (data, model) mesh
    model_ax = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh((n_devices // model_ax, model_ax), ("data", "model"), devices=[device] * n_devices)
    n = 16 * n_devices
    ei, w = gcn_norm(power_law(n, 4 * n, seed=0), num_nodes=n)
    dist = partition_graph(ei, w, num_nodes=n, mesh=mesh, halo="alltoall")
    rng = np.random.default_rng(0)
    x = shard_node_array(dist, rng.normal(size=(n, 16)).astype(np.float32), mesh)
    y = dist.shard_nodes(torch.from_numpy(rng.integers(0, 4, n)).to(device))
    valid = dist.shard_nodes(torch.ones(n, dtype=torch.bool, device=device), fill=False)
    model = shard_model(GCN(16, 32, 4, dropout=0.0, generator=torch.Generator().manual_seed(0)).to(device), mesh)
    opt = Adam(model.parameters(), lr=1e-2)
    loss = cross_entropy(model(x, dist), y, valid)  # the padding rows never enter the loss
    loss.backward()
    opt.step()
    if not math.isfinite(loss.item()):
        raise AssertionError(f"dryrun_multichip: non-finite tensor-parallel loss {loss.item()}")
