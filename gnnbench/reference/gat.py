"""GAT (Velickovic et al., arXiv:1710.10903) as the port's ``gat`` trains it:
``num_layers`` attention layers, ``heads`` heads of ``hidden`` features
concatenated in the hidden layers, one head over the classes at the end,
ELU between the layers. Per head

    e_ij = LeakyReLU_0.2(a_dst . W x_i + a_src . W x_j)
    out_i = sum_j softmax_j(e_ij) * dropout(1) W x_j   (+ bias),

where the dropout applies to the softmax's numerator weights only (its
denominator is the sum without dropout, as in the port and its JAX origin).
On the full graph each layer's input is dropped out too and the edges carry
self loops; on a sampled minibatch (one bipartite hop per layer, the
destinations the prefix of the sources) only the attention is, as in the
port's ``forward_sampled``. The loss (the mean cross entropy of the training
nodes, or of a minibatch's seeds) is the harness's."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from gnnbench.reference import common


def _layers(model: dict, num_features: int, num_classes: int) -> List[tuple]:
    """(in, heads, features a head, concat) of each layer."""
    out, d_in = [], num_features
    for i in range(model["num_layers"]):
        last = i == model["num_layers"] - 1
        heads, feats = (1, num_classes) if last else (model["heads"], model["hidden"])
        out.append((d_in, heads, feats, not last))
        d_in = heads * feats
    return out


def param_shapes(model: dict, num_features: int, num_classes: int) -> Dict[str, tuple]:
    shapes = {}
    for i, (d_in, heads, feats, concat) in enumerate(_layers(model, num_features, num_classes)):
        shapes[f"convs.{i}.lin.weight"] = (heads * feats, d_in)
        shapes[f"convs.{i}.att_src"] = (heads, feats)
        shapes[f"convs.{i}.att_dst"] = (heads, feats)
        shapes[f"convs.{i}.bias"] = (heads * feats if concat else feats,)
    return shapes


def dropout_sites(model: dict, sampled: bool) -> List[str]:
    return ["edge"] * model["num_layers"] if sampled else ["node", "edge"] * model["num_layers"]


def _conv(params, i, spec, h_in, src, dst, n_dst, att_mask, rate, prec):
    _, heads, feats, concat = spec
    h = common.linear(h_in, params[f"convs.{i}.lin.weight"], prec).view(-1, heads, feats)
    a_src = (h * params[f"convs.{i}.att_src"]).sum(-1)
    a_dst = (h[:n_dst] * params[f"convs.{i}.att_dst"]).sum(-1)
    e = F.leaky_relu(a_src[src] + a_dst[dst], 0.2)  # [E, heads]
    shift = torch.full((n_dst, heads), -torch.inf, dtype=e.dtype, device=e.device)
    shift = shift.scatter_reduce(0, dst[:, None].expand(-1, heads), e.detach(), "amax")
    ex = torch.exp(e - shift[dst])
    den = torch.zeros(n_dst, heads, dtype=e.dtype, device=e.device).index_add_(0, dst, ex)
    num_w = common.dropout(ex, att_mask, rate)
    num = torch.zeros(n_dst, heads, feats, dtype=h.dtype, device=h.device)
    num = num.index_add_(0, dst, num_w[:, :, None] * h[src])
    out = num / den.clamp_min(1e-16)[:, :, None]
    out = out.reshape(n_dst, heads * feats) if concat else out.mean(dim=1)
    return out + params[f"convs.{i}.bias"]


def logits(params, model: dict, graph: dict, x, masks, prec) -> torch.Tensor:
    """Full graph: ``graph['edge_index']`` [2, E] with self loops, ``masks``
    (input, attention) per layer; [N, classes]. Sampled: ``graph['hops']`` a
    list of (src positions, dst positions, n_dst) per layer, outermost
    first, ``x`` the rows of the sampled nodes, ``masks`` the attention masks
    per layer; [seeds, classes]."""
    specs = _layers(model, x.shape[1], int(params[f"convs.{model['num_layers'] - 1}.bias"].shape[0]))
    rate = model["dropout"]
    h = x.to(prec.dtype)
    sampled = "hops" in graph
    for i, spec in enumerate(specs):
        if sampled:
            src, dst, n_dst = graph["hops"][i]
            att_mask = masks[i]
        else:
            (src, dst), n_dst = graph["edge_index"], x.shape[0]
            h = common.dropout(h, masks[2 * i], rate)
            att_mask = masks[2 * i + 1]
        h = _conv(params, i, spec, h, src, dst, n_dst, att_mask, rate, prec)
        if i < len(specs) - 1:
            h = F.elu(h)
    return h
