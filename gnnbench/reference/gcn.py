"""GCN (Kipf and Welling, arXiv:1609.02907) as the port's ``gcn`` trains it:
for each layer dropout of its input, then X W^T aggregated over the
symmetric-normalized adjacency with self loops, plus the bias; ReLU between
the layers. The loss (:func:`gnnbench.reference.common.cross_entropy` of the
training nodes) is the harness's."""

from __future__ import annotations

from typing import Dict, List

import torch

from gnnbench.reference import common


def dims(model: dict, num_features: int, num_classes: int) -> List[int]:
    return [num_features] + [model["hidden"]] * (model["num_layers"] - 1) + [num_classes]


def param_shapes(model: dict, num_features: int, num_classes: int) -> Dict[str, tuple]:
    d = dims(model, num_features, num_classes)
    shapes = {}
    for i, (d_in, d_out) in enumerate(zip(d[:-1], d[1:])):
        shapes[f"convs.{i}.lin.weight"] = (d_out, d_in)
        shapes[f"convs.{i}.bias"] = (d_out,)
    return shapes


def dropout_sites(model: dict, sampled: bool) -> List[str]:
    """What each dropout of a step applies to, in the order of the forward:
    'node' ([N, width] rows of a layer's input) or 'edge' ([E, heads])."""
    if sampled:
        raise NotImplementedError("the port's GCN trains on the full graph only")
    return ["node"] * model["num_layers"]


def logits(params, model: dict, graph: dict, x, masks, prec) -> torch.Tensor:
    """[N, classes]. ``graph``: 'edge_index' [2, E] with self loops and its
    'weight' [E] in ``prec.dtype``; ``masks`` the step's keep masks, one per
    layer."""
    src, dst = graph["edge_index"]
    w = graph["weight"][:, None]
    n = x.shape[0]
    layers = model["num_layers"]
    h = x.to(prec.dtype)
    for i in range(layers):
        h = common.linear(common.dropout(h, masks[i], model["dropout"]), params[f"convs.{i}.lin.weight"], prec)
        h = torch.zeros(n, h.shape[1], dtype=h.dtype, device=h.device).index_add_(0, dst, h[src] * w)
        h = h + params[f"convs.{i}.bias"]
        if i < layers - 1:
            h = torch.relu(h)
    return h
