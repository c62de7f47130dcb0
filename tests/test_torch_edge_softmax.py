"""``ops/cuda/edge_softmax.py``, the attention's softmax by destination, on
the CPU (its plain versions): against the expressions GAT's tail ran before
it (a scatter-max, the shift's gather, ``exp``, K2's plain denominator and a
clamp), against the JAX package's ``segment_softmax``, under
``torch.autograd.gradcheck`` in float64, and through ``mp/gat.py::attend``.

The graph has rows without in-edges (the last 10 nodes) and a hub of 300
in-edges; the scores span +-30, so the shift matters: exp(30) overflows no
float32, but a global shift would underflow every row far below the hub's
max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tpu.ops.segment import segment_softmax as jax_segment_softmax
from gnn_tpu_torch import graphs as tg
from gnn_tpu_torch.mp import GATConv
from gnn_tpu_torch.mp.gat import attend
from gnn_tpu_torch.nn.dropout import dropout
from gnn_tpu_torch.ops.cuda.edge_softmax import (
    edge_softmax, edge_softmax_bwd, edge_softmax_parts, edge_softmax_plain,
)
from gnn_tpu_torch.ops.cuda.spmm_heads import spmm_heads_csr
from gnn_tpu_torch.ops.edge_agg import edge_aggregate_max
from gnn_tpu_torch.ops.segment import segment_sum_edges

N, EMPTY, HUB = 60, 10, 3


def _adjacency(n=N, edges=500, hub_edges=300, seed=0):
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n, edges), rng.integers(0, n, hub_edges)])
    dst = np.concatenate([rng.integers(0, n - EMPTY, edges), np.full(hub_edges, HUB)])
    return tg.build_adjacency(np.stack([src, dst]), num_nodes=n)


def _scores(adj, H, dtype=torch.float32, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand(adj.num_edges, H, generator=gen, dtype=torch.float64) * 60 - 30).to(dtype)


def _old_parts(e, adj):
    """The expressions ``attend`` ran before the softmax was one op."""
    m = edge_aggregate_max(e, adj.edge_agg_layouts()[0])
    m = torch.nan_to_num(m, nan=0.0, posinf=0.0, neginf=0.0)
    ex = torch.exp(e - m.index_select(0, adj.dst.long()))
    return ex, segment_sum_edges(ex, adj).clamp_min(1e-16)


@pytest.mark.parametrize("H", [1, 8])
def test_plain_parts_equal_the_old_expressions(H):
    adj = _adjacency()
    e = _scores(adj, H)
    ex, den = edge_softmax_parts(e, adj)
    old_ex, old_den = _old_parts(e, adj)
    assert torch.equal(ex, old_ex) and torch.equal(den, old_den)
    assert (den[N - EMPTY:] == 1e-16).all() and (den[: N - EMPTY] >= 1).all()


@pytest.mark.parametrize("H", [1, 8])
def test_parts_give_the_jax_segment_softmax(H):
    """ex / den[dst] is the JAX package's softmax by destination (float32,
    each with its own exp: rtol=1e-5)."""
    adj = _adjacency()
    e = _scores(adj, H)
    ex, den = edge_softmax_parts(e, adj)
    alpha = ex / den.index_select(0, adj.dst.long())
    want = jax_segment_softmax(jnp.asarray(e.numpy()), jnp.asarray(adj.dst.numpy()), N)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("H", [1, 3])
def test_gradcheck_in_float64(H):
    """The shift is held constant in the backward, so (ex, den) alone are
    not what gradcheck's finite differences see; the softmax ex / den[dst]
    and the normalised sum of ex * v by destination are, being the same for
    any shift."""
    adj = _adjacency(n=14, edges=40, hub_edges=12, seed=2)
    n = adj.num_dst_nodes
    e = _scores(adj, H, torch.float64).requires_grad_()
    v = torch.randn(adj.num_edges, H, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    rows = adj.dst.long()

    def softmax(e):
        ex, den = edge_softmax_parts(e, adj)
        return ex / den.index_select(0, rows)

    def normalised_sum(e):
        ex, den = edge_softmax_parts(e, adj)
        return torch.zeros(n, H, dtype=e.dtype).index_add(0, rows, ex * v) / den

    assert torch.autograd.gradcheck(softmax, (e,))
    assert torch.autograd.gradcheck(normalised_sum, (e,))


@pytest.mark.parametrize("H", [1, 8])
def test_backward_holds_the_shift_constant(H):
    """de = ex * (g_ex + g_den[dst]), bitwise the VJP of the old expressions."""
    adj = _adjacency()
    gen = torch.Generator().manual_seed(4)
    e = _scores(adj, H).requires_grad_()
    g_ex = torch.randn(adj.num_edges, H, generator=gen)
    g_den = torch.randn(N, H, generator=gen)
    ex, den = edge_softmax_parts(e, adj)
    (de,) = torch.autograd.grad((ex, den), e, (g_ex, g_den))
    e_old = e.detach().clone().requires_grad_()
    (de_old,) = torch.autograd.grad(_old_parts(e_old, adj), e_old, (g_ex, g_den))
    assert torch.equal(de, de_old)
    assert torch.equal(de, edge_softmax_bwd(ex.detach(), g_ex, g_den, adj.dst))
    (de_ex_only,) = torch.autograd.grad(edge_softmax_parts(e, adj)[0].sum(), e)  # den unused: a zero cotangent
    assert torch.equal(de_ex_only, ex.detach())


def _old_attend(conv, adj, e, h, *, generator=None):
    """``attend`` as it was before the softmax was one op."""
    n_out, H, F = adj.num_dst_nodes, h.shape[1], h.shape[2]
    ex, den = _old_parts(e, adj)
    ex_num = dropout(ex, conv.dropout_rate, training=conv.training, generator=generator)
    out = spmm_heads_csr(adj, h, ex_num).float() / den[:, :, None]
    out = out.reshape(n_out, H * F) if conv.concat else out.mean(dim=1)
    return out + conv.bias, ex_num / den.index_select(0, adj.dst.long())


@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_attend_equals_the_old_expressions(concat, rate):
    """Output, alpha and the gradients of the scores, the messages and the
    bias, with the same dropout draws on both paths."""
    H, F = 4, 5
    adj = _adjacency()
    conv = GATConv(7, F, heads=H, concat=concat, dropout=rate, generator=torch.Generator().manual_seed(5))
    conv.train()
    gen = torch.Generator().manual_seed(6)
    e0, h0 = _scores(adj, H), torch.randn(N, H, F, generator=gen)
    g_out = torch.randn(N, H * F if concat else F, generator=gen)
    results = []
    for run in (attend, _old_attend):
        e, h = e0.clone().requires_grad_(), h0.clone().requires_grad_()
        conv.zero_grad()
        out, alpha = run(conv, adj, e, h, generator=torch.Generator().manual_seed(7), **(
            {"return_attention": True} if run is attend else {}))
        out.backward(g_out)
        results.append((out.detach(), alpha.detach(), e.grad, h.grad, conv.bias.grad.clone()))
    for name, new, old in zip(("out", "alpha", "de", "dh", "dbias"), *results):
        assert torch.equal(new, old), name


def test_no_edges_and_no_launch_on_the_cpu():
    """A graph without edges gives empty ex and den at its floor; the CPU
    runs the plain versions and counts no launch."""
    adj = tg.build_adjacency(np.zeros((2, 0), np.int64), num_nodes=5)
    before = (edge_softmax.launches, edge_softmax_bwd.launches)
    e = torch.zeros(0, 2, requires_grad=True)
    ex, den = edge_softmax_parts(e, adj)
    (ex.sum() + den.sum()).backward()
    assert ex.shape == (0, 2) and torch.equal(den, torch.full((5, 2), 1e-16)) and e.grad.shape == (0, 2)
    assert (edge_softmax.launches, edge_softmax_bwd.launches) == before


def test_rejects_bad_arguments():
    adj = _adjacency()
    e = _scores(adj, 2)
    with pytest.raises(ValueError, match="edge scores"):
        edge_softmax_parts(e[1:], adj)
    with pytest.raises(ValueError, match="edge scores"):
        edge_softmax_parts(e[:, 0], adj)
    with pytest.raises(ValueError, match="must be \\[E, H\\]"):
        edge_softmax(e[:, 0], adj.row_ptr)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        edge_softmax(e.to("meta"), adj.row_ptr.to("meta"))
    with pytest.raises(ValueError, match="one \\[E, H\\]"):
        edge_softmax_bwd(e, e[1:], torch.zeros(N, 2), adj.dst)
    assert edge_softmax_plain(e, adj.row_ptr)[1].shape == (N, 2)
