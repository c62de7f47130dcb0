"""GAT: Linear, the per-node attention scores, and per edge the softmax's
numerator over the heads (K3)."""

from __future__ import annotations

from gnnbench import bounds
from gnnbench.flops import layer_graphs, linear_flops


def _layers(config: dict, shapes: dict) -> list:
    """(in, heads, features a head) of each layer."""
    m = config["model"]
    out, d_in = [], shapes["features"]
    for i in range(m["num_layers"]):
        last = i == m["num_layers"] - 1
        heads, feats = (1, shapes["classes"]) if last else (m["heads"], m["hidden"])
        out.append((d_in, heads, feats))
        d_in = heads * feats
    return out


def step_flops(config: dict, shapes: dict) -> float:
    """Linear forward and backward; the two scores a . h of every source
    row, forward and their two gradients; and per edge, head and feature one
    multiply-add each in the numerator's forward, its input gradient (K3 over
    the transpose) and the gradient of its weights (the SDDMM)."""
    layers = _layers(config, shapes)
    total = 0.0
    for i, ((n_dst, n_src, n_edges), (d_in, heads, feats)) in enumerate(
        zip(layer_graphs(shapes, len(layers)), layers)
    ):
        width = heads * feats
        total += linear_flops(n_src, d_in, width, i == 0)
        total += 3 * 2 * 2.0 * n_src * width
        total += 3 * 2.0 * n_edges * width
    return total


def kernel_bounds(config: dict, shapes: dict) -> dict:
    """K3's calls in a step: each layer's numerator forward and its input
    gradient over the transpose, which reads the weights through the int32
    edge index ``w_index``; float32."""
    layers = _layers(config, shapes)
    k3 = []
    for (n_dst, n_src, n_edges), (_, heads, feats) in zip(layer_graphs(shapes, len(layers)), layers):
        k3.append(bounds.csr_spmm_heads_bound(n_dst, n_src, n_edges, heads, feats, 4))
        k3.append(bounds.csr_spmm_heads_bound(n_src, n_dst, n_edges, heads, feats, 4, indexed=True))
    return {"K3": k3}
