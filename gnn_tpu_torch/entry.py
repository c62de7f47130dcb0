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
:func:`dryrun_multichip` waits for the multi-device port and raises.
"""

from __future__ import annotations

import numpy as np
import torch

from gnn_tpu_torch.graphs import Data
from gnn_tpu_torch.graphs.generate import power_law
from gnn_tpu_torch.models import GCN

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


def dryrun_multichip(n_devices: int) -> None:
    """The JAX package's multi-device dry run (``__graft_entry__.py``):
    waits for the multi-device port (ROADMAP Queue 1 item 15) and raises."""
    raise NotImplementedError(
        f"dryrun_multichip({n_devices}) needs the multi-device port, which is not "
        "there yet (ROADMAP Queue 1 item 15)"
    )
