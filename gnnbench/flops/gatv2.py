"""GATv2: two Linear projections, the fused per-edge score forward and
backward (``gnn::gatv2_score``), and GAT's numerator over the heads (K3 and
its SDDMM)."""

from __future__ import annotations

from gnnbench import bounds
from gnnbench.flops import layer_graphs, linear_flops

# operations per edge, head and feature: forward z = h_dst + h_src, the
# LeakyReLU's multiply, the multiply-add by att; backward z again, the
# LeakyReLU, the multiply-add into datt, ds * att and the slope's multiply,
# the adds into dh_dst and dh_src
SCORE_FWD, SCORE_BWD = 4, 8
_INDEX = 4  # int32 indices
_F32 = 4


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
    """Both projections forward and backward; per edge, head and feature
    the score's forward and backward operations, and one multiply-add each
    in the numerator's forward, its input gradient (K3 over the transpose)
    and the gradient of its weights (the SDDMM)."""
    layers = _layers(config, shapes)
    total = 0.0
    for i, ((n_dst, n_src, n_edges), (d_in, heads, feats)) in enumerate(
        zip(layer_graphs(shapes, len(layers)), layers)
    ):
        width = heads * feats
        total += linear_flops(n_src, d_in, width, i == 0) + linear_flops(n_dst, d_in, width, i == 0)
        total += (SCORE_FWD + SCORE_BWD) * float(n_edges) * width
        total += 3 * 2.0 * n_edges * width
    return total


def score_bounds(n_dst: int, n_src: int, n_edges: int, heads: int, feats: int) -> list:
    """The score's forward and backward calls of one layer, float32: each
    input and output byte once. Forward: h_src, h_dst, att, src, dst and the
    scores [E, H]. Backward: the cotangent [E, H], h_src, h_dst, att, src
    and dst, and dh_src, dh_dst, datt; the transpose and row offsets the
    kernels walk are their layout, not counted."""
    width = heads * feats
    rows = (n_src + n_dst) * width * _F32
    fwd = rows + width * _F32 + 2 * n_edges * _INDEX + n_edges * heads * _F32
    bwd = 2 * rows + 2 * width * _F32 + n_edges * heads * _F32 + 2 * n_edges * _INDEX
    return [bounds.Bound(bytes=fwd, operations=SCORE_FWD * n_edges * width),
            bounds.Bound(bytes=bwd, operations=SCORE_BWD * n_edges * width)]


def kernel_bounds(config: dict, shapes: dict) -> dict:
    """K3's calls in a step as GAT's (each layer's numerator forward and its
    input gradient over the transpose, which reads the weights through the
    int32 edge index ``w_index``), and the score's forward and backward
    calls of each layer; float32."""
    layers = _layers(config, shapes)
    k3, score = [], []
    for (n_dst, n_src, n_edges), (_, heads, feats) in zip(layer_graphs(shapes, len(layers)), layers):
        k3.append(bounds.csr_spmm_heads_bound(n_dst, n_src, n_edges, heads, feats, 4))
        k3.append(bounds.csr_spmm_heads_bound(n_src, n_dst, n_edges, heads, feats, 4, indexed=True))
        score += score_bounds(n_dst, n_src, n_edges, heads, feats)
    return {"K3": k3, "gatv2_score": score}
