"""Tensor parallelism over the mesh's ``model`` axis.

The port's counterpart of the JAX placement ``NamedSharding(mesh, P("model",
None))`` of the Linear weights (``__graft_entry__.py:209-214``,
``tests/test_parallel.py:836-843``): :func:`shard_model` replaces each
:class:`~gnn_tpu_torch.nn.Linear` whose out-features divide the model axis
``M`` by a :class:`ShardedLinear` whose shard ``m`` holds the weight's rows
``[m out / M, (m + 1) out / M)``; a Linear whose out-features do not divide
``M`` (a classifier head over 3 classes on ``M = 2``), every bias and every
other parameter stay replicated, the JAX package's mixed policy. Where JAX's
GSPMD inserts the collectives, here the layer runs them:

* in one process the model shards of a part are column blocks on the same
  device: ``y = [x W_0^T | x W_1^T | ...]``, and no collective runs;
* in a group whose model axis spans processes (``mesh.model_group``), each
  process computes its shards' column blocks, the forward gathers them over
  the model group (``all_gather``) and the backward takes the process's own
  columns of the gradient; the gradient of the layer's input is summed over
  the model group (``all_reduce``), as each process saw only its shards.

What follows the gather is computed alike on the processes of one part, so
the gradients of every parameter, sharded or replicated, are summed over the
mesh's ``data_group`` only (:func:`~gnn_tpu_torch.parallel.multihost.
all_reduce_gradients`), and the loss over the data group as well.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist
from torch import nn

from gnn_tpu_torch.nn.linear import Linear
from gnn_tpu_torch.parallel.mesh import Mesh

__all__ = ["ShardedLinear", "shard_model"]


class _SumGradOverModel(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    model group (each process's shards saw only their columns)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        tdist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherOverModel(torch.autograd.Function):
    """The column blocks of every process of the model group, in its rank
    order; the backward keeps this process's columns."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group, ctx.cols = group, y.shape[1]
        ctx.rank = tdist.get_rank(group)
        blocks = [torch.empty_like(y) for _ in range(tdist.get_world_size(group))]
        tdist.all_gather(blocks, y.contiguous(), group=group)
        return torch.cat(blocks, dim=1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.cols
        return g[:, lo : lo + ctx.cols].contiguous(), None


class ShardedLinear(nn.Module):
    """A :class:`~gnn_tpu_torch.nn.Linear` with its out-features split over
    the model axis: ``shards`` holds this process's row blocks of the weight
    ([out / M, in] each), ``bias`` (replicated) is the Linear's own."""

    def __init__(self, linear: Linear, mesh: Mesh):
        super().__init__()
        M = mesh.model_size
        if linear.out_features % M:
            raise ValueError(f"out_features={linear.out_features} does not divide the model axis of {M}")
        self.in_features, self.out_features = linear.in_features, linear.out_features
        rows = linear.out_features // M
        weight = linear.weight.detach()
        self.shard_index = tuple(mesh.local_shards)
        self.shards = nn.ParameterList(
            nn.Parameter(weight[m * rows : (m + 1) * rows].clone()) for m in self.shard_index
        )
        self.bias = linear.bias
        self.group = mesh.model_group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is not None:
            x = _SumGradOverModel.apply(x, self.group)
        y = torch.cat([torch.matmul(x, w.t().to(x.dtype)) for w in self.shards], dim=1)
        if self.group is not None:
            y = _GatherOverModel.apply(y, self.group)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Shard every Linear of ``model`` whose out-features divide the mesh's
    model axis (its second) over it, in place; the rest stays replicated.
    Returns the model. A model axis of size 1 (or none) leaves the model as
    it is."""
    if mesh.model_size == 1:
        return model
    for module in list(model.modules()):
        for name, child in list(module.named_children()):
            if isinstance(child, Linear) and child.out_features % mesh.model_size == 0:
                setattr(module, name, ShardedLinear(child, mesh))
    return model

