"""GATv2 (Brody, Alon and Yahav, "How Attentive are Graph Attention
Networks?", ICLR 2022, arXiv:2105.14491) as the port's ``gatv2`` trains it:
``num_layers`` attention layers, ``heads`` heads of ``hidden`` features
concatenated in the hidden layers, one head over the classes at the end,
ELU between the layers, each layer's input dropped out. Per head, with two
projections h_src = W_src x and h_dst = W_dst x (no bias):

    e_ij = sum_f a[f] * LeakyReLU_0.2(h_dst[i, f] + h_src[j, f])
    out_i = sum_j softmax_j(e_ij) * dropout(1) h_src[j]   (+ bias),

over j in N(i) and i itself (the edges carry self loops), where the dropout
applies to the softmax's numerator weights only (its denominator is the sum
without dropout, as in the port's GAT). The score has no bias inside, as the
paper's scoring function. Full graph only: the port's GATv2 has no sampled
path. The loss (the mean cross entropy of the training nodes) is the
harness's."""

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
        shapes[f"convs.{i}.lin_src.weight"] = (heads * feats, d_in)
        shapes[f"convs.{i}.lin_dst.weight"] = (heads * feats, d_in)
        shapes[f"convs.{i}.att"] = (heads, feats)
        shapes[f"convs.{i}.bias"] = (heads * feats if concat else feats,)
    return shapes


def dropout_sites(model: dict, sampled: bool) -> List[str]:
    if sampled:
        raise NotImplementedError("GATv2 has no sampled path")
    return ["node", "edge"] * model["num_layers"]


def conv(params, i, spec, h_in, src, dst, n_dst, att_mask, rate, prec):
    """Layer ``i`` over the edges (src, dst) into ``n_dst`` destinations."""
    _, heads, feats, concat = spec
    h_src = common.linear(h_in, params[f"convs.{i}.lin_src.weight"], prec).view(-1, heads, feats)
    h_dst = common.linear(h_in[:n_dst], params[f"convs.{i}.lin_dst.weight"], prec).view(-1, heads, feats)
    e = (F.leaky_relu(h_dst[dst] + h_src[src], 0.2) * params[f"convs.{i}.att"]).sum(-1)  # [E, heads]
    shift = torch.full((n_dst, heads), -torch.inf, dtype=e.dtype, device=e.device)
    shift = shift.scatter_reduce(0, dst[:, None].expand(-1, heads), e.detach(), "amax")
    ex = torch.exp(e - shift[dst])
    den = torch.zeros(n_dst, heads, dtype=e.dtype, device=e.device).index_add_(0, dst, ex)
    num_w = common.dropout(ex, att_mask, rate)
    num = torch.zeros(n_dst, heads, feats, dtype=h_src.dtype, device=h_src.device)
    num = num.index_add_(0, dst, num_w[:, :, None] * h_src[src])
    out = num / den.clamp_min(1e-16)[:, :, None]
    out = out.reshape(n_dst, heads * feats) if concat else out.mean(dim=1)
    return out + params[f"convs.{i}.bias"]


def logits(params, model: dict, graph: dict, x, masks, prec) -> torch.Tensor:
    """``graph['edge_index']`` [2, E] with self loops, ``masks`` (input,
    attention) per layer; [N, classes]."""
    if "hops" in graph:
        raise NotImplementedError("GATv2 has no sampled path")
    specs = _layers(model, x.shape[1], int(params[f"convs.{model['num_layers'] - 1}.bias"].shape[0]))
    rate = model["dropout"]
    h = x.to(prec.dtype)
    (src, dst), n = graph["edge_index"], x.shape[0]
    for i, spec in enumerate(specs):
        h = common.dropout(h, masks[2 * i], rate)
        h = conv(params, i, spec, h, src, dst, n, masks[2 * i + 1], rate, prec)
        if i < len(specs) - 1:
            h = F.elu(h)
    return h
