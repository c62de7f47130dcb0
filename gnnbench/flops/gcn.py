"""GCN: Linear, then the weighted aggregation over the adjacency (K1)."""

from __future__ import annotations

from gnnbench import bounds
from gnnbench.flops import layer_graphs, linear_flops


def _dims(config: dict, shapes: dict) -> list:
    m = config["model"]
    return [shapes["features"]] + [m["hidden"]] * (m["num_layers"] - 1) + [shapes["classes"]]


def step_flops(config: dict, shapes: dict) -> float:
    """Linear forward and backward plus one multiply-add per edge and
    feature in the aggregation and in its transpose in the backward."""
    d = _dims(config, shapes)
    graphs = layer_graphs(shapes, len(d) - 1)
    total = 0.0
    for i, ((n_dst, n_src, n_edges), d_in, d_out) in enumerate(zip(graphs, d[:-1], d[1:])):
        total += linear_flops(n_src, d_in, d_out, i == 0) + 2 * 2.0 * n_edges * d_out
    return total


def kernel_bounds(config: dict, shapes: dict) -> dict:
    """K1's calls in a step: each layer's aggregation forward and its
    transpose (the input gradient of X W^T) in the backward, float32."""
    d = _dims(config, shapes)
    graphs = layer_graphs(shapes, len(d) - 1)
    k1 = []
    for (n_dst, n_src, n_edges), d_out in zip(graphs, d[1:]):
        k1.append(bounds.csr_spmm_bound(n_dst, n_src, n_edges, d_out, 4))
        k1.append(bounds.csr_spmm_bound(n_src, n_dst, n_edges, d_out, 4))
    return {"K1": k1}
