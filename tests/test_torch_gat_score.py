"""GAT's score op (``ops/cuda/gat_score.py``) on the CPU, through its plain
versions: the node and edge scores and their gradients against the
expressions GATConv ran before (einsum node scores, both gathers, the add
and LeakyReLU), on a full graph with self loops and on a sampled hop whose
destinations are the first of its nodes; and against a float64 reference.
The kernels themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py``, marked ``gpu``)."""

import pytest
import torch
import torch.nn.functional as F

from gnn_tpu_torch import graphs as tg
from gnn_tpu_torch.graphs import NeighborSampler
from gnn_tpu_torch.ops.cuda.gat_score import gat_scores
from gnn_tpu_torch.ops.gather import gather_dst_edges, gather_src_edges


def _full_graph():
    ei, _ = tg.to_undirected(tg.power_law(300, 2000, seed=1), num_nodes=300)
    ei, _ = tg.add_remaining_self_loops(ei, num_nodes=300)
    return tg.build_adjacency(ei, num_nodes=300)


def _sampled_hop():
    data = tg.stochastic_block_model(num_nodes=300, num_classes=4, feature_dim=12, seed=1)
    _, adjs = NeighborSampler(data, [5, 3]).sample(torch.Generator().manual_seed(0), torch.arange(64))
    return adjs[0]


def _old_scores(h, att_src, att_dst, adj, slope, src_dtype):
    """GATConv's score before the op: node scores, the two gathers (their
    VJPs on K2 and K1), the add and LeakyReLU."""
    a_src = torch.einsum("nhf,hf->nh", h, att_src)
    a_dst = torch.einsum("nhf,hf->nh", h, att_dst)[: adj.num_dst_nodes]
    e = gather_dst_edges(a_dst, adj).float() + gather_src_edges(a_src.to(src_dtype), adj).float()
    return F.leaky_relu(e, slope)


@pytest.mark.parametrize("graph", ["full", "sampled hop"])
@pytest.mark.parametrize("H,F_", [(8, 8), (1, 40), (3, 5)])
def test_gat_scores_match_the_old_expressions(graph, H, F_):
    adj = _full_graph() if graph == "full" else _sampled_hop()
    gen = torch.Generator().manual_seed(H * 100 + F_)
    leaves = [torch.randn(adj.num_src_nodes, H, F_, generator=gen), torch.randn(H, F_, generator=gen),
              torch.randn(H, F_, generator=gen)]
    g = torch.randn(adj.num_edges, H, generator=gen)
    outs = []
    for fn in (gat_scores, _old_scores):
        xs = [t.clone().requires_grad_() for t in leaves]
        e = fn(*xs, adj, 0.2, torch.float32)
        outs.append((e, *torch.autograd.grad(e, xs, g)))
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_gat_scores_round_the_source_score_to_the_message_dtype():
    """With bfloat16 messages the source's node score meets the edges
    rounded, as the old gather of ``a_src.to(bfloat16)`` had it; the
    gradients are float32, the rounding passed straight through (the old
    path ran the source gather's VJP in bfloat16)."""
    adj = _full_graph()
    gen = torch.Generator().manual_seed(3)
    leaves = [torch.randn(300, 8, 8, generator=gen), torch.randn(8, 8, generator=gen), torch.randn(8, 8, generator=gen)]
    g = torch.randn(adj.num_edges, 8, generator=gen)
    xs = [t.clone().requires_grad_() for t in leaves]
    e = gat_scores(*xs, adj, 0.2, torch.bfloat16)
    grads = torch.autograd.grad(e, xs, g)
    with torch.no_grad():
        torch.testing.assert_close(e, _old_scores(*leaves, adj, 0.2, torch.bfloat16), rtol=1e-5, atol=1e-5)
    ys = [t.clone().requires_grad_() for t in leaves]
    a_src, a_dst = (ys[0] * ys[1]).sum(-1), (ys[0] * ys[2]).sum(-1)
    a_src = a_src + (a_src.to(torch.bfloat16).float() - a_src).detach()
    want = F.leaky_relu(a_dst[adj.dst.long()] + a_src[adj.src.long()], 0.2)
    for got, w in zip(grads, torch.autograd.grad(want, ys, g)):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-4)


def test_gat_scores_against_float64():
    """The op in float32 against its expressions in float64: scores and all
    three gradients within float32 rounding."""
    adj = _sampled_hop()
    gen = torch.Generator().manual_seed(5)
    leaves = [torch.randn(adj.num_src_nodes, 4, 6, generator=gen, dtype=torch.float64),
              torch.randn(4, 6, generator=gen, dtype=torch.float64), torch.randn(4, 6, generator=gen, dtype=torch.float64)]
    g = torch.randn(adj.num_edges, 4, generator=gen, dtype=torch.float64)
    xs = [t.clone().requires_grad_() for t in leaves]
    a_src, a_dst = ((xs[0] * xs[i]).sum(-1) for i in (1, 2))
    want = F.leaky_relu(a_dst[adj.dst.long()] + a_src[adj.src.long()], 0.2)
    want_grads = torch.autograd.grad(want, xs, g)
    xs32 = [t.float().requires_grad_() for t in leaves]
    e = gat_scores(*xs32, adj, 0.2)
    grads = torch.autograd.grad(e, xs32, g.float())
    torch.testing.assert_close(e.double(), want, rtol=1e-5, atol=1e-5)
    for got, w in zip(grads, want_grads):
        torch.testing.assert_close(got.double(), w, rtol=1e-5, atol=1e-4)


def test_gat_scores_reject_bad_shapes():
    adj = _full_graph()
    with pytest.raises(ValueError, match="h must be"):
        gat_scores(torch.randn(299, 2, 3), torch.randn(2, 3), torch.randn(2, 3), adj, 0.2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gat_scores(torch.randn(300, 2, 3), torch.randn(2, 3), torch.randn(2, 3), adj, 0.2, torch.float16)
